"""Measurement scripts for the port, run as ``python -m zest_tpu_torch.tools.<name>``."""
