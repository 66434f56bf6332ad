"""Command-line tools of the port (``python -m cs_vit_tpu_torch.tools.<name>``)."""
