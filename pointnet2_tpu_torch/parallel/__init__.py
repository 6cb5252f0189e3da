"""Multi-process coordination of the port (single-process form only)."""
