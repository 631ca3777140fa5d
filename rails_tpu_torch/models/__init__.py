"""Sequential encoder (HSTU) and the top-level recommender."""
