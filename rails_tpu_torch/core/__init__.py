"""Device rules."""
