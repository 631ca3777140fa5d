"""Host-side sequence data and batches."""
