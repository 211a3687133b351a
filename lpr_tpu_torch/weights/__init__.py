"""Checkpoint reading and the weight bridge from the JAX package."""
