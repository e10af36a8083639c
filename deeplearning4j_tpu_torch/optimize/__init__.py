"""Updater configurations."""
