"""Training data: the deterministic, seekable synthetic token stream."""
