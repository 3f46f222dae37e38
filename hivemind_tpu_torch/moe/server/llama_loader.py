"""Load HuggingFace-layout Llama-family checkpoints into ``llama_block`` serving
backends (the port of hivemind_tpu/moe/server/llama_loader.py) — the Petals-style
block server of BASELINE config #5.

- **Checkpoint format**: ``config.json`` plus either a single ``model.safetensors``
  or a sharded set with ``model.safetensors.index.json``. The port reads
  safetensors itself (:class:`SafetensorsFile`: an 8-byte little-endian header
  length, a JSON header, raw little-endian bytes, memory-mapped with numpy), so it
  needs no ``safetensors`` package. Tensors are read per block, so host memory
  stays ~one block.
- **Weight mapping**: HF ``nn.Linear`` weights are ``[out, in]``, the port's
  layout too, so they load untransposed; the RMSNorm weights map onto the
  blocks' norms. HF's rotary convention (split halves) matches ``apply_rope``.
- **Int8 serving**: ``weight_quantization="int8"`` stores the matrices with the
  blockwise absmax codec, quantized on the device by the port's kernel.
- **Memory budgeting**: :func:`plan_block_capacity` decides how many blocks fit
  one card from per-block bytes + decode-session KV budget (:func:`decode_cache_bytes`)
  + headroom.
- **Generation**: :class:`LlamaClientHead` holds the client's ends of the
  pipeline (embedding, final norm, LM head), and :func:`generate_greedy` decodes
  through any pipe of KV-cache sessions.
"""

from __future__ import annotations

import json
import struct
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hivemind_tpu_torch.moe.server.layers import name_to_block
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
from hivemind_tpu_torch.ops.quantized_params import QUANT_BLOCK_SIZE
from hivemind_tpu_torch.utils.device import resolve_device
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class LlamaCheckpointConfig:
    hidden_size: int
    num_attention_heads: int
    num_key_value_heads: int
    intermediate_size: int
    num_hidden_layers: int
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6  # HF LlamaConfig default; Llama-2 ships 1e-5

    @classmethod
    def load(cls, checkpoint_dir) -> "LlamaCheckpointConfig":
        with open(Path(checkpoint_dir) / "config.json") as f:
            raw = json.load(f)
        return cls(
            hidden_size=int(raw["hidden_size"]),
            num_attention_heads=int(raw["num_attention_heads"]),
            num_key_value_heads=int(raw.get("num_key_value_heads", raw["num_attention_heads"])),
            intermediate_size=int(raw["intermediate_size"]),
            num_hidden_layers=int(raw["num_hidden_layers"]),
            rope_theta=float(raw.get("rope_theta", 10000.0)),
            rms_norm_eps=float(raw.get("rms_norm_eps", 1e-6)),
        )


_NUMPY_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


class SafetensorsFile:
    """One ``.safetensors`` file, memory-mapped; :meth:`get` copies one tensor out.
    BF16 tensors (which numpy cannot hold) are widened to float32, exactly."""

    def __init__(self, path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            (header_len,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(header_len))
        header.pop("__metadata__", None)
        self.entries: Dict[str, dict] = header
        self._data_start = 8 + header_len
        self._bytes = np.memmap(self.path, dtype=np.uint8, mode="r")

    def keys(self) -> Iterable[str]:
        return self.entries.keys()

    def get(self, name: str) -> np.ndarray:
        entry = self.entries[name]
        begin, end = entry["data_offsets"]
        if not 0 <= begin <= end <= len(self._bytes) - self._data_start:
            raise ValueError(f"{self.path}: tensor {name!r} lies outside the file")
        raw = self._bytes[self._data_start + begin : self._data_start + end]
        dtype = entry["dtype"]
        if dtype == "BF16":
            array = (raw.view("<u2").astype(np.uint32) << 16).view(np.float32)
        elif dtype in _NUMPY_DTYPES:
            array = np.array(raw.view(np.dtype(_NUMPY_DTYPES[dtype]).newbyteorder("<")))
        else:
            raise TypeError(f"{self.path}: tensor {name!r} has unsupported dtype {dtype}")
        return array.reshape(entry["shape"])


class ShardedSafetensorsReader:
    """Lazy tensor access over a single- or multi-file safetensors checkpoint."""

    def __init__(self, checkpoint_dir):
        self.dir = Path(checkpoint_dir)
        index_path = self.dir / "model.safetensors.index.json"
        self._files: Dict[str, SafetensorsFile] = {}
        if index_path.exists():
            with open(index_path) as f:
                self.weight_map: Dict[str, str] = json.load(f)["weight_map"]
        else:
            single = self.dir / "model.safetensors"
            if not single.exists():
                raise FileNotFoundError(f"{self.dir} holds neither model.safetensors nor an index")
            handle = self._files["model.safetensors"] = SafetensorsFile(single)
            self.weight_map = {name: "model.safetensors" for name in handle.keys()}

    def get(self, name: str) -> np.ndarray:
        try:
            filename = self.weight_map[name]
        except KeyError:
            raise KeyError(f"checkpoint has no tensor {name!r}") from None
        handle = self._files.get(filename)
        if handle is None:
            handle = self._files[filename] = SafetensorsFile(self.dir / filename)
        return handle.get(name)


def _block_params_from_hf(reader: ShardedSafetensorsReader, layer: int) -> Dict[str, torch.Tensor]:
    """One decoder layer's HF tensors as a LlamaBlockExpert parameter dict (fp32, host)."""
    prefix = f"model.layers.{layer}."

    def tensor(hf_name: str) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(reader.get(prefix + hf_name), dtype=np.float32))

    return {
        "query.weight": tensor("self_attn.q_proj.weight"),
        "key.weight": tensor("self_attn.k_proj.weight"),
        "value.weight": tensor("self_attn.v_proj.weight"),
        "attention_out.weight": tensor("self_attn.o_proj.weight"),
        "ffn_gate.weight": tensor("mlp.gate_proj.weight"),
        "ffn_up.weight": tensor("mlp.up_proj.weight"),
        "ffn_down.weight": tensor("mlp.down_proj.weight"),
        "attention_norm.weight": tensor("input_layernorm.weight"),
        "ffn_norm.weight": tensor("post_attention_layernorm.weight"),
    }


def load_llama_blocks(
    checkpoint_dir,
    *,
    layers: Optional[Sequence[int]] = None,
    uid_prefix: str = "llama.",
    weight_quantization: Optional[str] = None,
    max_batch_size: int = 64,
    device: Union[str, torch.device] = "cuda",
    optimizer: Optional[Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]] = None,
) -> Tuple[Dict[str, ModuleBackend], LlamaCheckpointConfig]:
    """Build ``{uid: ModuleBackend}`` serving the checkpoint's decoder layers on
    ``device`` (``"cuda"`` unless the caller asks for the CPU).

    ``layers`` defaults to all of them; uid = ``f"{uid_prefix}{layer}"``. Blocks are
    built on the meta device; each block's checkpoint tensors are copied to
    ``device`` once and, for int8, quantized once. ``optimizer`` (a factory over a
    block's parameter tensors) trains the fp blocks on ``backward``; None is SGD
    with learning rate 0, as the JAX package's ``optax.sgd(0.0)``.
    """
    device = resolve_device(device)
    config = LlamaCheckpointConfig.load(checkpoint_dir)
    reader = ShardedSafetensorsReader(checkpoint_dir)
    layers = list(layers) if layers is not None else list(range(config.num_hidden_layers))

    backends: Dict[str, ModuleBackend] = {}
    for layer in layers:
        with torch.device("meta"):
            module = name_to_block["llama_block"](
                config.hidden_size,
                num_heads=config.num_attention_heads,
                num_kv_heads=config.num_key_value_heads,
                rope_theta=config.rope_theta,
                ffn_inner=config.intermediate_size,
                rms_eps=config.rms_norm_eps,
            )
        backend = ModuleBackend(
            f"{uid_prefix}{layer}",
            module,
            sample_input=np.zeros((2, 8, config.hidden_size), np.float32),
            optimizer=optimizer,
            params=_block_params_from_hf(reader, layer),
            max_batch_size=max_batch_size,
            weight_quantization=weight_quantization,
            device=device,
        )
        backends[backend.name] = backend
        logger.info(
            f"loaded block {layer} as {backend.name!r} "
            f"({backend.param_bytes() / 1e6:.1f} MB resident on {device}"
            f"{', int8' if weight_quantization else ''})"
        )
    return backends, config


# ---------------------------------------------------------------- memory budgeting


def predict_block_param_bytes(config: LlamaCheckpointConfig, weight_quantization: Optional[str] = None) -> int:
    """Resident bytes ONE decoder block should cost, from config arithmetic alone:
    fp32 matrices + norm weights, or blockwise int8 (codes padded to
    QUANT_BLOCK_SIZE + one fp32 absmax per block; norm weights stay fp32)."""
    hid, inner = config.hidden_size, config.intermediate_size
    head_dim = hid // config.num_attention_heads
    kv = config.num_key_value_heads * head_dim
    matrices = [
        hid * hid,  # q_proj
        kv * hid,  # k_proj
        kv * hid,  # v_proj
        hid * hid,  # o_proj
        inner * hid,  # gate_proj
        inner * hid,  # up_proj
        hid * inner,  # down_proj
    ]
    norm_bytes = 2 * hid * 4  # input/post-attention RMSNorm weights, always fp32
    if weight_quantization == "int8":
        total = norm_bytes
        for size in matrices:
            blocks = -(-size // QUANT_BLOCK_SIZE)  # ceil
            total += blocks * QUANT_BLOCK_SIZE + blocks * 4  # int8 codes + fp32 absmax
        return total
    return sum(matrices) * 4 + norm_bytes


def decode_cache_bytes(config: LlamaCheckpointConfig, batch: int, max_len: int) -> int:
    """KV-cache bytes ONE session costs for ONE block (bf16 K + V in the compact
    kv-heads layout, see ``LlamaBlockExpert.init_decode_cache``)."""
    head_dim = config.hidden_size // config.num_attention_heads
    return 2 * 2 * batch * max_len * config.num_key_value_heads * head_dim


def device_hbm_bytes(device: Union[str, torch.device] = "cuda") -> Optional[int]:
    """The card's total memory (``torch.cuda.mem_get_info``); None for the CPU,
    where callers pass an explicit budget."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    _free, total = torch.cuda.mem_get_info(device)
    return int(total)


def plan_block_capacity(
    block_bytes: int,
    *,
    hbm_bytes: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    decode_sessions: int = 0,
    cache_bytes_per_session_block: int = 0,
    reserve_fraction: float = 0.2,
) -> int:
    """How many blocks fit one card: ``(memory*(1-reserve) - sessions*cache) / block``.
    ``reserve_fraction`` keeps headroom for activations, the transient dense
    weights of int8 serving and the allocator's cache. Returns at least 0."""
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes(device)
    if hbm_bytes is None:
        raise ValueError("the CPU reports no device memory limit; pass hbm_bytes explicitly")
    usable = int(hbm_bytes * (1.0 - reserve_fraction))
    per_block = block_bytes + decode_sessions * cache_bytes_per_session_block
    if per_block <= 0:
        return 0
    return max(usable // per_block, 0)


class LlamaClientHead:
    """The client-side ends of a Petals-style pipeline: token embedding in, final
    RMSNorm + LM head out, as fp32 tensors on ``device``. Loaded from the
    checkpoint's ``model.embed_tokens.weight``, ``model.norm.weight`` and
    ``lm_head.weight`` (absent: tied with the embedding)."""

    def __init__(self, embed: torch.Tensor, norm_scale: torch.Tensor, lm_head: torch.Tensor,
                 rms_eps: float = 1e-6):
        self.embed_matrix = embed  # [vocab, hid]
        self.norm_scale = norm_scale  # [hid]
        self.lm_head_matrix = lm_head  # [vocab, hid]
        self.rms_eps = rms_eps

    @classmethod
    def load(cls, checkpoint_dir, device: Union[str, torch.device] = "cuda") -> "LlamaClientHead":
        device = resolve_device(device)
        reader = ShardedSafetensorsReader(checkpoint_dir)
        config = LlamaCheckpointConfig.load(checkpoint_dir)

        def tensor(name: str) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(reader.get(name), dtype=np.float32)).to(device)

        embed = tensor("model.embed_tokens.weight")
        try:
            lm_head = tensor("lm_head.weight")
        except KeyError:
            lm_head = embed  # tied embeddings
        return cls(embed, tensor("model.norm.weight"), lm_head, rms_eps=config.rms_norm_eps)

    @property
    def device(self) -> torch.device:
        return self.embed_matrix.device

    @property
    def vocab_size(self) -> int:
        return self.embed_matrix.shape[0]

    def embed(self, token_ids) -> torch.Tensor:
        """[batch, seq] int ids -> [batch, seq, hid] fp32 hidden states on the head's device."""
        return self.embed_matrix[torch.as_tensor(np.asarray(token_ids, np.int64), device=self.device)]

    def logits(self, hidden) -> torch.Tensor:
        """[batch, seq, hid] block-stack output (a tensor or an array) -> [batch,
        seq, vocab] fp32 logits: RMSNorm, then the LM projection, as HF's
        LlamaForCausalLM ends."""
        hidden = torch.as_tensor(hidden, dtype=torch.float32, device=self.device)
        rms = torch.sqrt(hidden.pow(2).mean(dim=-1, keepdim=True) + self.rms_eps)
        return (hidden / rms * self.norm_scale) @ self.lm_head_matrix.T


def generate_greedy(head: LlamaClientHead, pipe, prompt_ids, max_new_tokens: int,
                    session_id: Optional[str] = None) -> np.ndarray:
    """Greedy decoding through a pipe of KV-cache sessions: one prefill, then one
    single-token step per new token (the last token needs none: its cache entry
    would go unread). ``pipe`` is any object with ``decode_step(hidden,
    session_id, reset=False)`` returning the block stack's output. ``session_id``
    defaults to a fresh unique id: servers key sessions by (uid, session_id), so a
    shared constant would let concurrent generations overwrite each other's caches.
    ``prompt_ids``: [batch, prompt_len]; returns [batch, prompt_len + new] int64."""
    if session_id is None:
        session_id = f"gen-{uuid.uuid4().hex}"
    prompt = np.asarray(prompt_ids, np.int64)
    ids = np.empty((prompt.shape[0], prompt.shape[1] + max_new_tokens), np.int64)
    ids[:, : prompt.shape[1]] = prompt
    hidden = pipe.decode_step(head.embed(prompt), session_id, reset=True)
    for step in range(max_new_tokens):
        next_ids = torch.argmax(head.logits(hidden[:, -1:]), dim=-1).cpu().numpy()
        ids[:, prompt.shape[1] + step] = next_ids[:, 0]
        if step + 1 < max_new_tokens:
            hidden = pipe.decode_step(head.embed(next_ids), session_id)
    return ids
