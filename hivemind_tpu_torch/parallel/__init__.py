"""Attention cores of the port (ring attention itself comes with the multi-GPU tier)."""
