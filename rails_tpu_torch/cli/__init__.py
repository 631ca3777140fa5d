"""Command-line entry points of the port (`python -m rails_tpu_torch.cli.<name>`)."""
