"""Expert serving: ModuleBackend → TaskPool → Runtime, KV-cache decode sessions,
and the Llama checkpoint loader with its client head and greedy generation."""

from hivemind_tpu_torch.moe.server.decode_session import DecodeSessionManager
from hivemind_tpu_torch.moe.server.llama_loader import (
    LlamaClientHead,
    decode_cache_bytes,
    generate_greedy,
    load_llama_blocks,
    plan_block_capacity,
    predict_block_param_bytes,
)
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
