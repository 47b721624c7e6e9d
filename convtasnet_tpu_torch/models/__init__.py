"""The Conv-TasNet model, its block math and the weight bridge from JAX."""
