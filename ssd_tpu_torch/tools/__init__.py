"""Command-line tools of the port (run as ``python -m ssd_tpu_torch.tools.<name>``)."""
