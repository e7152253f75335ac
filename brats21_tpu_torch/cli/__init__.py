"""Inference CLI of the port (``python -m brats21_tpu_torch.cli.main_inference``)."""
