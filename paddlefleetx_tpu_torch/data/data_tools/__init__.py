"""Dataset index builders of the port."""
