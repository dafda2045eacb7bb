"""Host-side data helpers: the vocabulary."""
