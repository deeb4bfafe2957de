"""Helpers shared across the port (params trees)."""
