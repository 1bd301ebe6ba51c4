"""Single-device mesh partitioning and particle migration."""
