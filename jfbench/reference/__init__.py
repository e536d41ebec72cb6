"""The plain count that decides `correct` (count.py)."""
