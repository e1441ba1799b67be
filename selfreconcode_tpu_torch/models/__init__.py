"""Neural fields, body model and skinner."""
