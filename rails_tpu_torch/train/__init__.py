"""Evaluation (serving) step."""
