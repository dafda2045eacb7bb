"""Host-side data: the vocabulary, the synthetic corpora and the loader."""
