"""Runnable recipes of the port (``python -m hivemind_tpu_torch.examples.<name>``)."""
