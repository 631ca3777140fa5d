"""Mixture-of-Logits similarity."""
