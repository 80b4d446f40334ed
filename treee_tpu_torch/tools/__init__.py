"""Measurement tools of the port, each run as ``python -m
treee_tpu_torch.tools.<name>`` on a CUDA card."""
