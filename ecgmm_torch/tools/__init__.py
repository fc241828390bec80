"""Weight conversion between the JAX reference and the port."""
