"""Batch samplers and collate functions of the port."""
