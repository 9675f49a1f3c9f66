"""Experiments of the port: counterparts of the JAX package's ``experiments/``."""
