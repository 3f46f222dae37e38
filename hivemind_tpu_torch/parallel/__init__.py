"""The mesh tier of the port (hivemind_tpu/parallel/): a ``(dp, tp, sp)`` mesh of
``torch.distributed`` ranks, its sharding rules, ring attention over its sequence axis,
and the bridge that stages a mesh's tensors to one host and back."""

from hivemind_tpu_torch.parallel.ici import MeshTensorBridge
from hivemind_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    batch_sharding,
    make_mesh,
    param_spec,
    params_shardings,
    replicated,
    shard_batch,
    shard_state_dict,
)
from hivemind_tpu_torch.parallel.ring_attention import plain_attention, ring_attention, ring_flash_attention
