"""Utilities of the port: logging, YAML configs, device selection."""
