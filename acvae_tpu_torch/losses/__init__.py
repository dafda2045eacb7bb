"""The composite dict-interface losses of the reference (``losses/loss.py``)."""
