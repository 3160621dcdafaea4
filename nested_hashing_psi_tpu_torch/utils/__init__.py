"""Host utilities of the port (the native g++ helpers)."""
