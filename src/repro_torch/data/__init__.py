"""Synthetic video world and embedders."""
