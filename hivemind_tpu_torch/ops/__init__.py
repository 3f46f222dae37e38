"""Device ops of the port: the hand-written Hopper kernels (``csrc/``), their
wrappers and their plain PyTorch versions."""
