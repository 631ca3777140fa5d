"""Training losses and negative samplers (`rails_tpu/losses/`)."""
