"""Camera model."""
