"""Host utilities of the port (flame diagnostics)."""
