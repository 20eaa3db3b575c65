"""Command-line tools of the port (``python3 -m toyfhe_tpu_torch.tools.<name>``)."""
