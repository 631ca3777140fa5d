"""Configs and weights from elsewhere: the JAX package's weights (`from_jax`) and
the reference's gin bindings (`gin_import`)."""
