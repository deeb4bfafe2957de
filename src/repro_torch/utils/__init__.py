"""Helpers shared across the port (params trees, the name registry)."""
