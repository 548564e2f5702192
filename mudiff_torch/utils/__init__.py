"""Utilities of the port (NIfTI I/O)."""
