"""Host-side utilities of the port (numpy and threads)."""
