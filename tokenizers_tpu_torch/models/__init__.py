"""Models of the host path."""
