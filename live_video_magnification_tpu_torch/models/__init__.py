"""The phase pipeline with explicit carried state, and the processing chain."""
