"""Dynamic analysis of the port's runtime: the race harness (tsan.py)."""
