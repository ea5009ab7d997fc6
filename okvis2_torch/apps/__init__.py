"""Command-line apps of the port (``python -m okvis2_torch.apps.<name>``)."""
