"""See ops.py."""
