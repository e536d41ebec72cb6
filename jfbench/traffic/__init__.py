"""The read generator (reads.py)."""
