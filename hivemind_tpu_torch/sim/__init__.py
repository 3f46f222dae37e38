"""hivemind_tpu_torch.sim — the thousand-peer in-process swarm simulator (the port
of hivemind_tpu/sim/: the same scenarios over the port's DHT, matchmaking and beam
search, giving the JAX package's summaries for the same seed).

Real logic layers (DHT, matchmaking, expert declarations + beam search,
breakers) over an in-process transport driven by a seeded WAN link matrix,
paced by a virtual clock so thousand-peer scenarios run in seconds and replay
deterministically. See docs/simulation.md.
"""

from hivemind_tpu_torch.sim.clock import (
    SimDeadlockError,
    VirtualClockEventLoop,
    install_virtual_time,
    uninstall_virtual_time,
)
from hivemind_tpu_torch.sim.network import (
    LinkMatrix,
    LinkProfile,
    LinkSpec,
    Partition,
    SimLossError,
    SimNetwork,
    SimP2P,
    SimPartitionError,
    SimPeerDeadError,
)
from hivemind_tpu_torch.sim.peer import SimDHT, SimPeer, descriptor_schema_hash
from hivemind_tpu_torch.sim.scenarios import ScenarioResult, run_scenario, scenario_names

__all__ = [
    "LinkMatrix",
    "LinkProfile",
    "LinkSpec",
    "Partition",
    "ScenarioResult",
    "SimDHT",
    "SimDeadlockError",
    "SimLossError",
    "SimNetwork",
    "SimP2P",
    "SimPartitionError",
    "SimPeer",
    "SimPeerDeadError",
    "VirtualClockEventLoop",
    "descriptor_schema_hash",
    "install_virtual_time",
    "run_scenario",
    "scenario_names",
    "uninstall_virtual_time",
]
