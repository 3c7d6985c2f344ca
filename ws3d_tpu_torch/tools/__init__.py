"""Command-line entry points (python -m ws3d_tpu_torch.tools.<name>)."""
