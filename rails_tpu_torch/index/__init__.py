"""Exact MoL top-k retrieval."""
