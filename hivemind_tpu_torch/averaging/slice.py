"""SliceAverager: ONE mesh of several ranks = ONE swarm peer (the port of
hivemind_tpu/averaging/slice.py).

- **Rank 0 is the network process.** It alone builds a DHT (``dht_factory`` is called
  there only) and the embedded :class:`MeshAverager`: matchmaking, the butterfly
  all-reduce and state sharing happen only there. The other ranks never hold a DHT and
  take part only in the mesh's collectives.
- **``step()`` is collective**: every rank calls it at the same point. A round is three
  synchronized phases:

  1. *stage* (every rank): the optional mean over ``local_reduce_axis`` on the devices,
     then each leaf's regions pulled into rank 0's host mirrors, one leaf at a time;
  2. *swarm round* (rank 0 only): the embedded averager's ``step()`` averages the
     mirrors with the other swarm peers; the other ranks wait in phase 3's broadcast;
  3. *adopt* (every rank): rank 0 broadcasts a success flag, then the averaged leaves
     one at a time (the JAX package's ``broadcast_one_to_all`` of each leaf), each rank
     receiving its region, written into its tensors in place.

The embedded averager advertises the slice's aggregate egress (the base rate times its
hosts), so the load balancer gives the slice a proportionally larger part of the
reduction."""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from hivemind_tpu_torch.averaging.ici import MeshAverager
from hivemind_tpu_torch.parallel.ici import MeshTensorBridge
from hivemind_tpu_torch.parallel.mesh import Mesh, NamedSharding
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class SliceAverager:
    """See module docstring.

    :param tensors: this rank's tensors (shards where ``shardings`` shard them),
        updated in place when a round succeeds
    :param mesh: the mesh spanning every rank of the slice
    :param dht_factory: zero-argument callable building the network rank's DHT; called
        ONLY on rank 0
    :param shardings: each tensor's sharding (default: replicated)
    :param local_reduce_axis: as in :class:`MeshAverager`
    :param kwargs: forwarded to the embedded :class:`MeshAverager` (rank 0)
    """

    def __init__(
        self,
        tensors: Sequence[torch.Tensor],
        mesh: Mesh,
        dht_factory: Callable[[], Any],
        *,
        shardings: Optional[Sequence[NamedSharding]] = None,
        local_reduce_axis: Optional[str] = None,
        **kwargs,
    ):
        self.mesh = mesh
        self.local_reduce_axis = local_reduce_axis
        self.bridge = MeshTensorBridge(mesh)
        self.is_network_process = self.bridge.is_network_rank
        self._tensors: List[torch.Tensor] = list(tensors)
        self._shardings = shardings
        self.dht = None
        self.averager: Optional[MeshAverager] = None
        if self.is_network_process:
            self.dht = dht_factory()
            self.averager = MeshAverager(self._tensors, mesh, self.dht, shardings=shardings,
                                         local_reduce_axis=local_reduce_axis, external_staging=True, **kwargs)
        else:
            # the same collective gather the network rank runs inside MeshAverager's
            # constructor: the followers hold no mirror, they send their regions
            self.bridge.gather_reduced_to_host(self._tensors, shardings, reduce_axis=local_reduce_axis)

    @property
    def tensors(self) -> List[torch.Tensor]:
        return self._tensors

    def step(self, *, weight: Optional[float] = None, timeout: Optional[float] = None, **step_kwargs) -> bool:
        """One collective swarm round. Every rank of the slice must call this; returns
        True when the swarm round succeeded and the averaged values were adopted, False
        when it failed (the tensors are left unchanged)."""
        # phase 1: stage (collective; one reduced leaf in flight)
        mirrors = self.averager._averaged_tensors if self.averager is not None else None
        if self.averager is not None:
            with self.averager.lock_averaged_tensors:
                self.bridge.stage_reduced_into_mirrors(self._tensors, mirrors, self._shardings,
                                                       reduce_axis=self.local_reduce_axis)
        else:
            self.bridge.stage_reduced_into_mirrors(self._tensors, None, self._shardings,
                                                   reduce_axis=self.local_reduce_axis)

        # phase 2: the swarm round (network rank only)
        ok = False
        if self.averager is not None:
            try:
                ok = self.averager.step(weight=weight, timeout=timeout, **step_kwargs) is not None
            except Exception as e:
                logger.warning(f"slice swarm round failed: {e!r}")

        # phase 3: adopt (collective; also the rendezvous of the ranks)
        flag = self.bridge.broadcast_array(np.asarray([1.0 if ok else 0.0], np.float32), (1,), torch.device("cpu"))
        if float(flag[0]) < 0.5:
            return False
        with torch.no_grad():
            for index, tensor in enumerate(self._tensors):
                sharding = None if self._shardings is None else self._shardings[index]
                value = None
                if self.averager is not None:
                    with self.averager.lock_averaged_tensors:
                        value = mirrors[index].copy()
                tensor.copy_(self.bridge.scatter_leaf(tensor, value, sharding))
        return True

    def shutdown(self) -> None:
        if self.averager is not None:
            self.averager.shutdown()
        if self.dht is not None:
            self.dht.shutdown()
