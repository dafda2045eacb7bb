"""Config reading: the YAML subset reader and ``load_config``."""
