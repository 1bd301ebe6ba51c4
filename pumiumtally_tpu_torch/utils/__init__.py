"""Logging, and checkpoint/resume of tally state (checkpoint.py)."""
