"""Models of the port (GPT) and their config derivations."""
