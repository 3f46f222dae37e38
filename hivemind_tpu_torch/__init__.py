"""hivemind_tpu_torch: the PyTorch/CUDA port of hivemind_tpu for NVIDIA Hopper.

This package serves Llama-family decoder blocks (and the other built-in expert
blocks) through the same entry points as the JAX package —
``load_llama_blocks`` → ``ModuleBackend`` → ``TaskPool``/``Runtime`` — with the
JAX package's Pallas kernels rewritten by hand in CUDA C++ for ``sm_90a``
(``csrc/``). It imports torch, numpy and the standard library only: never jax,
flax, optax or any module of ``hivemind_tpu``.

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``;
without a card it raises instead of quietly running on the CPU. Importing the
package builds nothing: kernels are compiled at their first launch
(``ops/_build.py``).
"""

__version__ = "0.1.0"
