"""Pre-tokenizers of the host path."""
