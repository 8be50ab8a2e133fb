"""Synthetic data (numpy)."""
