"""Decoding: next-word sampling, the batched beam search, diverse beam
search and the probability-averaged ensemble."""
