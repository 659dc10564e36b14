"""Deterministic synthetic data for the LM paths."""
