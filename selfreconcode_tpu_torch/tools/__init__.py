"""A/B tools of the training step's reference-exact variants."""
