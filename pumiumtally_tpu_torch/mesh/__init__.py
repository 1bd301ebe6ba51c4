"""Mesh containers and generators."""
