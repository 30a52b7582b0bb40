"""Observability for the port (only the clock so far)."""
