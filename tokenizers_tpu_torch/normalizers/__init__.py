"""Normalizers of the host path."""
