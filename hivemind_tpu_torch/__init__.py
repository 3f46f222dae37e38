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

The top-level names are the JAX package's (``hivemind_tpu/__init__.py``): a few
light ones imported eagerly, the rest resolved at first use, so ``import
hivemind_tpu_torch`` loads no jax and none of the networking stack.
"""

from hivemind_tpu_torch.utils.loop import EventLoopShutdownError, LoopRunner, get_loop_runner
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.timed_storage import DHTExpiration, TimedStorage, ValueWithExpiration, get_dht_time

__version__ = "0.1.0"

# each lazy name and the module of the port that defines it
_LAZY = {
    "DHT": "hivemind_tpu_torch.dht",
    "DHTNode": "hivemind_tpu_torch.dht.node",
    "P2P": "hivemind_tpu_torch.p2p",
    "PeerID": "hivemind_tpu_torch.p2p",
    "DecentralizedAverager": "hivemind_tpu_torch.averaging",
    "MeshAverager": "hivemind_tpu_torch.averaging",
    "NATTraversal": "hivemind_tpu_torch.p2p",
    "Optimizer": "hivemind_tpu_torch.optim",
    "GradientAverager": "hivemind_tpu_torch.optim",
    "TrainingStateAverager": "hivemind_tpu_torch.optim",
    "PowerSGDGradientAverager": "hivemind_tpu_torch.optim",
    "GradScaler": "hivemind_tpu_torch.optim",
    "TrainingAverager": "hivemind_tpu_torch.optim",
    "ProgressTracker": "hivemind_tpu_torch.optim",
    "Server": "hivemind_tpu_torch.moe",
    "ModuleBackend": "hivemind_tpu_torch.moe",
    "RemoteExpert": "hivemind_tpu_torch.moe",
    "RemoteMixtureOfExperts": "hivemind_tpu_torch.moe",
    "RemoteSequential": "hivemind_tpu_torch.moe",
    "RemoteSwitchMixtureOfExperts": "hivemind_tpu_torch.moe",
    "register_expert_class": "hivemind_tpu_torch.moe",
    "RetryPolicy": "hivemind_tpu_torch.resilience",
    "Deadline": "hivemind_tpu_torch.resilience",
    "BreakerBoard": "hivemind_tpu_torch.resilience",
    "CHAOS": "hivemind_tpu_torch.resilience",
    "SimNetwork": "hivemind_tpu_torch.sim",
    "SimPeer": "hivemind_tpu_torch.sim",
    "LinkMatrix": "hivemind_tpu_torch.sim",
    "run_scenario": "hivemind_tpu_torch.sim",
}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'hivemind_tpu_torch' has no attribute {name!r}")
