"""Stand-alone tools of the port (twins of the JAX package's `scripts/`)."""
