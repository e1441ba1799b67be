"""UV texture baking."""
