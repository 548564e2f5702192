"""Utilities of the port: NIfTI and PNG I/O, training reports, profiling."""
