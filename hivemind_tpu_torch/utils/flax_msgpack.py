"""flax's msgpack state format, written out for the port (the format of
``flax.serialization.to_bytes`` / ``msgpack_restore``), on the port's own
MessagePack codec (``utils/msgpack_codec.py``).

The JAX package writes expert state blobs (checkpoints, ``rpc_replica_state``)
in this format, so the port reads and writes it byte for byte:

- a tree is dicts with string keys; a list or tuple becomes ``{"0": ..., "1": ...}``
  (flax's state-dict form), and keys keep their order;
- an array (numpy, or a torch tensor) is ``ExtType(1, packb([shape, dtype name,
  C-order bytes]))``, a 0-d array included;
- a numpy scalar (``np.generic``) is ``ExtType(3, ...)`` with the same payload;
- an array of more than ``MAX_CHUNK_SIZE`` bytes is written as
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``, the
  flat array cut into chunks of at most that many bytes, as flax cuts it;
- Python ints, floats, bools, strings, bytes and None are plain msgpack values.

``bfloat16`` has no numpy dtype on a machine without ``ml_dtypes``: a
``torch.bfloat16`` tensor is written under the name ``"bfloat16"`` and read back
as one. Every other array is read back as a numpy array (a read-only view of the
blob's bytes).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from hivemind_tpu_torch.utils import msgpack_codec

__all__ = ["MAX_CHUNK_SIZE", "msgpack_restore", "to_bytes", "to_state_dict"]

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
# msgpack caps one object at 2**31 - 1 bytes; flax leaves a margin, as here
MAX_CHUNK_SIZE = 2**30


def to_state_dict(tree: Any) -> Any:
    """flax's state-dict form: lists and tuples become dicts keyed by position."""
    if isinstance(tree, dict):
        keys = [str(key) for key in tree]
        if len(set(keys)) != len(keys):
            raise ValueError(f"dict keys do not have a unique string representation: {list(tree)}")
        return {str(key): to_state_dict(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(index): to_state_dict(value) for index, value in enumerate(tree)}
    return tree


def _as_array(value: torch.Tensor):
    """A torch tensor as (numpy array, dtype name); bfloat16 rides as its int16 bits."""
    value = value.detach().to("cpu").contiguous()
    if value.dtype == torch.bfloat16:
        return value.view(torch.int16).numpy(), "bfloat16"
    array = value.numpy()
    return array, array.dtype.name


def _array_payload(array: np.ndarray, dtype_name: str) -> bytes:
    if array.dtype.hasobject or array.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    return msgpack_codec.packb([[int(dim) for dim in array.shape], dtype_name, array.tobytes("C")])


def _chunk(array: np.ndarray, dtype_name: str) -> dict:
    chunk = max(1, int(MAX_CHUNK_SIZE / array.dtype.itemsize))
    flat = array.reshape(-1)
    return {
        _CHUNKED: True,
        "shape": {str(i): int(dim) for i, dim in enumerate(array.shape)},
        "chunks": {str(i): (flat[start:start + chunk], dtype_name)
                   for i, start in enumerate(range(0, flat.size, chunk))},
    }


def _prepare(tree: Any) -> Any:
    """Arrays as ``(array, dtype name)`` pairs, the oversized ones chunked."""
    if isinstance(tree, dict):
        return {key: _prepare(value) for key, value in tree.items()}
    if isinstance(tree, torch.Tensor):
        array, name = _as_array(tree)
    elif isinstance(tree, np.ndarray):
        array, name = tree, tree.dtype.name
    else:
        return tree
    if array.size * array.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(array, name)
    return (array, name)


def _ext_pack(value: Any):
    if isinstance(value, tuple) and len(value) == 2 and isinstance(value[0], np.ndarray):
        return msgpack_codec.ExtType(_EXT_NDARRAY, _array_payload(*value))
    if isinstance(value, np.generic):
        array = np.asarray(value)
        return msgpack_codec.ExtType(_EXT_NPSCALAR, _array_payload(array, array.dtype.name))
    raise TypeError(f"cannot serialize {type(value).__name__!r} object")


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes(tree)`` for a tree of dicts, lists, tuples,
    arrays (numpy or torch) and Python or numpy scalars."""
    return msgpack_codec.packb(_prepare(to_state_dict(tree)), default=_ext_pack)


def _array_from_payload(data: bytes):
    shape, dtype_name, buffer = msgpack_codec.unpackb(data)
    if dtype_name == "bfloat16":
        bits = torch.frombuffer(bytearray(buffer), dtype=torch.int16) if buffer else torch.empty(0, dtype=torch.int16)
        return bits.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext_unpack(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_payload(data)
    if code == _EXT_NPSCALAR:
        array = _array_from_payload(data)
        return array.reshape(()) if isinstance(array, torch.Tensor) else array[()]
    return msgpack_codec.ExtType(code, data)


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def msgpack_restore(blob: bytes) -> Any:
    """``flax.serialization.msgpack_restore(blob)``: the state dict the blob holds."""
    return _unchunk(msgpack_codec.unpackb(blob, ext_hook=_ext_unpack))
