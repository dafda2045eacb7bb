"""Decoding: next-word sampling and the batched beam search."""
