"""Private indexed equality engines."""
