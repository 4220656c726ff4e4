"""Command-line entry points of the port (`python -m
surel_plus_tpu_torch.cli.main`)."""
