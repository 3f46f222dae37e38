"""Mixture-of-experts serving of the port: the server side (backends, pools,
runtime, decode sessions, the connection handler) and the expert client."""

from hivemind_tpu_torch.moe.client import RemoteExpert, RemoteExpertWorker
from hivemind_tpu_torch.moe.expert_uid import ExpertInfo, ExpertUID, ReplicaInfo, is_valid_prefix, is_valid_uid, split_uid
from hivemind_tpu_torch.moe.server import ConnectionHandler, ModuleBackend, Runtime, register_expert_class
