"""Command-line entry points of the port (``python -m segma_tpu_torch.cli.<name>``)."""
