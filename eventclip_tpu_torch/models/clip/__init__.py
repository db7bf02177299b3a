"""CLIP architecture table, towers and the weight bridge from the JAX layout."""
