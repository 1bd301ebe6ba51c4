"""The plain float64 reference the check compares with."""
