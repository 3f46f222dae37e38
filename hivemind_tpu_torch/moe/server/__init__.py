"""Expert serving: ModuleBackend → TaskPool → Runtime, KV-cache decode sessions,
the ConnectionHandler that serves them over the wire, the Server that declares
them in the DHT, checkpoints and hot-expert replication, tensor-parallel blocks
over a serving mesh, and the Llama checkpoint loader with its client head and greedy generation."""

from hivemind_tpu_torch.moe.server.admission import ClientOverBudgetError, FairShareAdmission
from hivemind_tpu_torch.moe.server.checkpoints import CheckpointSaver, load_experts, store_experts
from hivemind_tpu_torch.moe.server.connection_handler import ConnectionHandler
from hivemind_tpu_torch.moe.server.decode_session import DecodeSessionManager
from hivemind_tpu_torch.moe.server.dht_handler import declare_experts, get_experts
from hivemind_tpu_torch.moe.server.layers import register_expert_class
from hivemind_tpu_torch.moe.server.llama_loader import (
    LlamaClientHead,
    decode_cache_bytes,
    generate_greedy,
    load_llama_blocks,
    plan_block_capacity,
    predict_block_param_bytes,
)
from hivemind_tpu_torch.moe.server.mesh_backend import MeshModuleBackend, ServingMesh
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
from hivemind_tpu_torch.moe.server.replication import ReplicationManager, ReplicationPolicy
from hivemind_tpu_torch.moe.server.runtime import Runtime
from hivemind_tpu_torch.moe.server.server import Server, background_server
from hivemind_tpu_torch.moe.server.task_pool import ServerOverloadedError, TaskPool
