"""The port's benchmark harness (see run.py)."""
