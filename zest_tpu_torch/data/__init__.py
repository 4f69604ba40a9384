"""Host-side inputs of the port (NumPy only)."""
