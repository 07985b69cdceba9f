"""Command-line entry points: ``python -m papr_tpu_torch.cli.train`` and
``python -m papr_tpu_torch.cli.test``."""
