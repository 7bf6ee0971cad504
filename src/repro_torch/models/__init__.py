"""Model definitions of the port: every family of the JAX package."""
