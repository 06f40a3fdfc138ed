"""Core containers, constants and integer math of the port (host)."""
