"""Deterministic synthetic training data (numpy)."""
