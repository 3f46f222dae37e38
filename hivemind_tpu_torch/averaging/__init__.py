"""Decentralized averaging (the port of hivemind_tpu/averaging/): matchmaking through
the DHT, the fault-tolerant butterfly all-reduce with per-link wire codecs, verified
state downloads, and the mesh tiers (``MeshAverager``, ``SliceAverager``) where a mesh
of ranks is one peer. The reduction runs in numpy on the host in the JAX package's
operations and order, so a group may mix the two packages' peers."""

from hivemind_tpu_torch.averaging.allreduce import AllReduceRunner, AveragingMode
from hivemind_tpu_torch.averaging.averager import DecentralizedAverager
from hivemind_tpu_torch.averaging.control import AveragingStage, StepControl
from hivemind_tpu_torch.averaging.group_info import GroupInfo
from hivemind_tpu_torch.averaging.ici import MeshAverager
from hivemind_tpu_torch.averaging.key_manager import GroupKeyManager
from hivemind_tpu_torch.averaging.load_balancing import load_balance_peers
from hivemind_tpu_torch.averaging.matchmaking import Matchmaking, MatchmakingException
from hivemind_tpu_torch.averaging.partition import (
    AllreduceException,
    TensorPartContainer,
    TensorPartReducer,
)
from hivemind_tpu_torch.averaging.slice import SliceAverager
from hivemind_tpu_torch.averaging.state_sync import (
    DigestMismatch,
    ManifestMismatch,
    StaleDonor,
    StateAssembly,
    StateDownloadResult,
    StateSyncError,
    StateUnavailable,
    build_state_manifest,
    download_state_verified,
    payload_digest,
)
