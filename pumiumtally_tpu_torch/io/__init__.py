"""Result writers (numpy only)."""
