"""Caption scoring: BLEU, ROUGE-L, CIDEr-D, native METEOR and SPICE, and
the Porter stemmer they share; the diversity suite and the human
(leave-one-out) bounds."""
