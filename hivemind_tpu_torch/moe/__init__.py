"""Mixture-of-experts serving of the port: the server side (backends, pools,
runtime, decode sessions, the connection handler, the Server that declares its
experts in the DHT, checkpoints and hot-expert replication) and the clients
(RemoteExpert, RemoteSequential, the beam search and the mixture-of-experts
layers)."""

from hivemind_tpu_torch.moe.client import (
    MoEBeamSearcher,
    RemoteCallMany,
    RemoteExpert,
    RemoteExpertWorker,
    RemoteMixtureOfExperts,
    RemoteSequential,
    RemoteSwitchMixtureOfExperts,
)
from hivemind_tpu_torch.moe.expert_uid import ExpertInfo, ExpertUID, ReplicaInfo, is_valid_prefix, is_valid_uid, split_uid
from hivemind_tpu_torch.moe.server import (
    ConnectionHandler,
    ModuleBackend,
    Runtime,
    Server,
    background_server,
    declare_experts,
    get_experts,
    register_expert_class,
)
