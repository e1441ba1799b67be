"""Leaf math, positional encoding, sampling and mesh helpers."""
