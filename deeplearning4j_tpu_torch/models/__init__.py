"""Canned architectures."""
