"""Utilities: checkpoint and resume."""
