"""Operator tools of the port: ``python -m distar_tpu_torch.tools.<name>``."""
