"""Samples of the port (run with `python -m rejit_tpu_torch.samples.<name>`)."""
