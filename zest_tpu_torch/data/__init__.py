"""Host-side inputs of the port: the synthetic scene (NumPy only) and the
training loop's prefetch thread."""
