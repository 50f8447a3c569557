"""Entry points: the offline admin tool (`python -m
scintirete_tpu_torch.cli.admin_main`)."""
