"""Training data of the port: the deterministic token pipeline."""
