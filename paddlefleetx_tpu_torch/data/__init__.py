"""Data utilities of the port (tokenizers)."""
