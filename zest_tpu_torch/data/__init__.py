"""Host-side inputs of the port: the synthetic scene and the wander path's
poses (NumPy only), and the training loop's prefetch thread."""
