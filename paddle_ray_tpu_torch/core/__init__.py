"""Core utilities of the port."""
