"""Tensor ops: masked reductions, losses, SpecAugment, the spline time warp,
the log-mel frontend."""
