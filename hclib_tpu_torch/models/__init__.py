"""Workload inputs shared with the JAX package's models."""
