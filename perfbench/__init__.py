"""The benchmark of the port (mudiff_torch) on one H100: see core.py."""
