"""The PyTorch port as a package: it imports no JAX and nothing of the JAX package
(nor pydantic or the wire libraries), its entry points refuse to run without a card
unless asked for the CPU, the DHT runs without one and takes no device, its tensor
schemas speak the JAX package's dtype names, and chip_smoke.py refuses to run
without a card."""

import re
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from hivemind_tpu.utils.tensor_descr import BatchTensorDescriptor as JaxBatchTensorDescriptor
from hivemind_tpu_torch.ops import _build
from hivemind_tpu_torch.utils.tensor_descr import BatchTensorDescriptor

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "hivemind_tpu_torch"

# what the port never loads: the JAX stack, pydantic (the JAX package's DHT schema
# validator), and the wire libraries the JAX package uses (the port has its own
# msgpack, proto3 and libcrypto codecs, so it also loads on a machine without them)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hivemind_tpu", "ml_dtypes", "msgpack", "google.protobuf",
             "cryptography", "pydantic")

_ISOLATION_PROBE = """
import importlib, importlib.util, pathlib, sys
import numpy as np
import torch
import hivemind_tpu_torch

FORBIDDEN = %r
def leaked():
    return sorted(name for name in sys.modules
                  if any(name == top or name.startswith(top + ".") for top in FORBIDDEN))

spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
# from the file system: pkgutil.walk_packages would import each package to walk it
root = pathlib.Path(hivemind_tpu_torch.__file__).parent
modules = sorted(".".join(("hivemind_tpu_torch",) + path.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
                 for path in root.rglob("*.py"))
for name in modules:
    importlib.import_module(name)
for name in ("hivemind_tpu_torch.moe.server.decode_session", "hivemind_tpu_torch.telemetry.blackbox",
             "hivemind_tpu_torch.p2p.p2p", "hivemind_tpu_torch.p2p.crypto_channel",
             "hivemind_tpu_torch.moe.server.connection_handler", "hivemind_tpu_torch.moe.client.expert",
             "hivemind_tpu_torch.proto.runtime_pb2", "hivemind_tpu_torch.utils.msgpack_codec",
             "hivemind_tpu_torch.proto.dht_pb2", "hivemind_tpu_torch.dht.dht", "hivemind_tpu_torch.dht.node",
             "hivemind_tpu_torch.moe.server.server", "hivemind_tpu_torch.moe.client.remote_sequential",
             "hivemind_tpu_torch.utils.flax_msgpack", "hivemind_tpu_torch.moe.server.checkpoints",
             "hivemind_tpu_torch.moe.server.replication", "hivemind_tpu_torch.moe.client.call_many",
             "hivemind_tpu_torch.moe.client.beam_search", "hivemind_tpu_torch.moe.client.moe",
             "hivemind_tpu_torch.telemetry.monitor", "hivemind_tpu_torch.utils.auth",
             "hivemind_tpu_torch.averaging", "hivemind_tpu_torch.averaging.averager",
             "hivemind_tpu_torch.averaging.load_balancing", "hivemind_tpu_torch.proto.averaging_pb2",
             "hivemind_tpu_torch.optim", "hivemind_tpu_torch.optim.optimizer", "hivemind_tpu_torch.dht.schema",
             "hivemind_tpu_torch.moe.server.layers.optim", "hivemind_tpu_torch.examples.albert.run_trainer",
             "hivemind_tpu_torch.parallel", "hivemind_tpu_torch.parallel.mesh", "hivemind_tpu_torch.parallel.ici",
             "hivemind_tpu_torch.averaging.ici", "hivemind_tpu_torch.averaging.slice",
             "hivemind_tpu_torch.optim.slice_optimizer", "hivemind_tpu_torch.examples.slice_training",
             "hivemind_tpu_torch.examples.slice_collaborative_training", "hivemind_tpu_torch.hivemind_cli.run_dht",
             "hivemind_tpu_torch.hivemind_cli.run_server", "hivemind_tpu_torch.moe.server.mesh_backend",
             "hivemind_tpu_torch.utils.limits", "hivemind_tpu_torch.utils.platform",
             "hivemind_tpu_torch.examples.llama_generate", "hivemind_tpu_torch.examples.pipeline_inference",
             "hivemind_tpu_torch.sim", "hivemind_tpu_torch.sim.scenarios", "hivemind_tpu_torch.sim.network",
             "hivemind_tpu_torch.hivemind_cli.run_top", "hivemind_tpu_torch.hivemind_cli.run_blackbox",
             "hivemind_tpu_torch.hivemind_cli.run_chaos_soak", "hivemind_tpu_torch.utils.nested"):
    assert name in sys.modules, name
assert not leaked(), leaked()
import hivemind_tpu_torch as top_level
for name in top_level._LAZY:  # every lazy top-level name resolves without the JAX stack
    getattr(top_level, name)
assert not leaked(), leaked()

assert not torch.cuda.is_available()
from hivemind_tpu_torch.moe.server.layers import NopExpert
from hivemind_tpu_torch.moe.server.llama_loader import device_hbm_bytes, load_llama_blocks
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
from hivemind_tpu_torch.models.albert import AlbertConfig, make_train_step
from hivemind_tpu_torch.moe.server.server import Server
from hivemind_tpu_torch.moe.client.moe import RemoteMixtureOfExperts
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.examples.albert import run_trainer
from hivemind_tpu_torch.parallel import make_mesh
from hivemind_tpu_torch.hivemind_cli import run_server
from hivemind_tpu_torch.moe.server.mesh_backend import ServingMesh
refused = 0
for entry_point in (
    lambda: ModuleBackend("nop", NopExpert(4), sample_input=np.zeros((1, 4), np.float32)),
    lambda: load_llama_blocks("/nonexistent"),
    lambda: device_hbm_bytes(),
    lambda: make_train_step(AlbertConfig.tiny(), lambda params: torch.optim.AdamW(params)),
    lambda: Server.create(expert_uids=["nop.0"], expert_cls="nop", hidden_dim=4),
    lambda: RemoteMixtureOfExperts(dht=DHT(), in_features=4, grid_size=(2,), uid_prefix="nop."),
    lambda: run_trainer.main(["--tiny", "--max_steps", "0"]),
    lambda: make_mesh(2, backend="gloo"),
    lambda: run_server.main(["--expert_cls", "nop", "--expert_uids", "nop.0", "--hidden_dim", "4"]),
    lambda: ServingMesh(["cuda", "cuda"]),
):
    try:
        entry_point()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
        refused += 1
assert refused == 10, refused
backend = ModuleBackend("nop", NopExpert(4), sample_input=np.zeros((1, 4), np.float32), device="cpu")
assert backend.forward(np.ones((2, 4), np.float32))[0].tolist() == [[1.0] * 4] * 2
assert backend.backward(np.ones((2, 4), np.float32), np.ones((2, 4), np.float32))[0].tolist() == [[1.0] * 4] * 2
import hivemind_tpu_torch.models.albert
assert "flash_attention_bwd" in hivemind_tpu_torch.ops._build.SOURCES
# the transport runs: a handshake over loopback loads no wire library either
import asyncio
from hivemind_tpu_torch.p2p import P2P
from hivemind_tpu_torch.proto import runtime_pb2

async def _echo():
    server, client = await P2P.create(), await P2P.create()
    async def echo(request, context):
        return runtime_pb2.ExpertUID(uid=request.uid + "!")
    await server.add_protobuf_handler("echo", echo, runtime_pb2.ExpertUID)
    client.add_peer_addr(server.peer_id, server.get_visible_maddrs()[0])
    reply = await client.call_protobuf_handler(server.peer_id, "echo", runtime_pb2.ExpertUID(uid="a"),
                                               runtime_pb2.ExpertUID)
    await client.shutdown()
    await server.shutdown()
    return reply.uid
assert asyncio.run(_echo()) == "a!"
# the DHT runs on the host with no card and takes no device; a CPU server declares in it
import inspect
from hivemind_tpu_torch.dht import DHT, DHTNode
from hivemind_tpu_torch.moe import RemoteSequential, get_experts
assert not any("device" in inspect.signature(fn).parameters for fn in (DHT.__init__, DHTNode.create))
server = Server.create(expert_uids=["nop.0"], expert_cls="nop", hidden_dim=4, device="cpu", start=True)
client = DHT(initial_peers=[str(m) for m in server.dht.get_visible_maddrs()], start=True)
assert client.store("k", {"v": (1, b"x")}, 2e9) and server.dht.get("k", latest=True).value == {"v": (1, b"x")}
import time
declared_by = time.monotonic() + 20  # the server declares in the background as it starts
while get_experts(client, ["nop.0"])[0] is None and time.monotonic() < declared_by:
    time.sleep(0.05)
assert get_experts(client, ["nop.0"])[0].peer_id == server.dht.peer_id
assert RemoteSequential(client, "nop.", 1)(torch.ones(2, 4)).tolist() == [[1.0] * 4] * 2
client.shutdown()
server.shutdown()
server.dht.shutdown()
# two port averagers find each other through the DHT and average on the host
from hivemind_tpu_torch.averaging import DecentralizedAverager
first = DHT(start=True)
second = DHT(initial_peers=[str(m) for m in first.get_visible_maddrs()], start=True)
averagers = [DecentralizedAverager([torch.full((8,), float(i))], dht, prefix="probe", start=True,
                                   target_group_size=2, min_matchmaking_time=0.5)
             for i, dht in enumerate((first, second))]
controls = [averager.step(wait=False, timeout=30) for averager in averagers]
assert all(control.result(timeout=60) is not None for control in controls)
for averager in averagers:
    with averager.get_tensors() as tensors:
        assert tensors[0].tolist() == [0.5] * 8
    averager.shutdown()
second.shutdown()
first.shutdown()
assert not leaked(), leaked()
print("isolated")
""" % (FORBIDDEN,)


def test_package_imports_no_jax_and_refuses_to_run_without_cuda():
    """In a fresh interpreter (the test process itself has jax loaded by conftest)."""
    result = subprocess.run(
        [sys.executable, "-c", _ISOLATION_PROBE], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip().endswith("isolated")


def test_package_sources_never_name_the_jax_stack():
    """Nor the wire libraries, not even lazily: no import statement anywhere in the
    port or in chip_smoke.py names one."""
    names = "|".join(re.escape(name) for name in FORBIDDEN)
    forbidden = re.compile(r"^\s*(import|from)\s+(" + names + r")(\.|\s|$)", re.MULTILINE)
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert {"compression", "proto", "moe", "p2p", "dht"} <= {path.relative_to(PACKAGE).parts[0] for path in sources[:-1]}
    offenders = [str(path.relative_to(REPO)) for path in sources if forbidden.search(path.read_text())]
    assert not offenders, offenders


def test_only_the_load_balancer_imports_scipy():
    """scipy's HiGHS cuts the averaging spans, as in the JAX package; no other module of
    the port, nor chip_smoke.py, imports scipy."""
    importer = re.compile(r"^\s*(import|from)\s+scipy(\.|\s|$)", re.MULTILINE)
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    importers = [str(path.relative_to(REPO)) for path in sources if importer.search(path.read_text())]
    assert importers == ["hivemind_tpu_torch/averaging/load_balancing.py"], importers


def test_no_source_names_a_jax_package_module_as_a_string():
    """A copied module that looks a JAX-package module up by name (``sys.modules``
    lookups of executors and pools) silently reads nothing: every such name in
    the port and chip_smoke.py must be a ``hivemind_tpu_torch`` one."""
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert {"telemetry", "resilience"} <= {path.relative_to(PACKAGE).parts[0] for path in sources[:-1]}
    offenders = [str(path.relative_to(REPO)) for path in sources
                 if re.search(r"""["']hivemind_tpu\.""", path.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize(
    "array,tensor",
    [
        (np.zeros((3, 64, 8), np.float32), torch.zeros((3, 64, 8), dtype=torch.float32)),
        (np.zeros((2, 5), ml_dtypes.bfloat16), torch.zeros((2, 5), dtype=torch.bfloat16)),
        (np.zeros((4, 2), np.int8), torch.zeros((4, 2), dtype=torch.int8)),
    ],
    ids=["float32", "bfloat16", "int8"],
)
def test_batch_descriptors_match_the_jax_package(array, tensor):
    theirs = JaxBatchTensorDescriptor.from_array(array)
    for ours in (BatchTensorDescriptor.from_tensor(tensor), BatchTensorDescriptor.from_tensor(array)):
        assert (ours.shape, ours.dtype, ours.requires_grad) == (theirs.shape, theirs.dtype, theirs.requires_grad)


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(tmp_path, monkeypatch):
    paths = {name: _build.library_path(name) for name in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    assert all(path.parent == REPO / "build" / "hivemind_tpu_torch" for path in paths.values())
    assert paths == {name: _build.library_path(name) for name in _build.SOURCES}  # stable
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_kernel_build_compiles_each_part_at_once_then_links_them(tmp_path, monkeypatch):
    """A source in PARTS is compiled as that many objects, each with its -DHM_PART, and
    linked into one library; a whole source is one shared build; no object is left."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "$@" >> "%s"\nout=""\nprev=""\n'
                    'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\necho built > "$out"\n' % log)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    built = _build.build_all()
    calls = [line.split() for line in log.read_text().splitlines()]
    for name in _build.SOURCES:
        source = str(_build.CSRC / f"{name}.cu")
        compiles = [call for call in calls if call[-1] == source]
        parts = _build.PARTS.get(name, 1)
        if parts == 1:
            assert len(compiles) == 1 and "-shared" in compiles[0] and "-c" not in compiles[0]
            continue
        assert sorted(next(a for a in call if a.startswith("-DHM_PART=")) for call in compiles) == [
            f"-DHM_PART={i}" for i in range(parts)]
        assert all("-c" in call and "-shared" not in call for call in compiles)
        objects = [call[call.index("-o") + 1] for call in compiles]
        (link,) = [call for call in calls if sorted(call[-parts:]) == sorted(objects)]  # compiles log in any order
        assert "-shared" in link and "-c" not in link
        assert built[name].read_text() == "built\n"
    assert not list((tmp_path / "build").glob("*.o"))


def test_chip_smoke_children_fork_from_a_server_that_starts_no_thread():
    """chip_smoke.py's children fork from a server that imports CHILD_PRELOAD: forking is safe
    only while importing those modules starts no thread (and touches no card)."""
    probe = ("import importlib, importlib.util, sys, threading\n"
             "spec = importlib.util.spec_from_file_location('chip_smoke', sys.argv[1])\n"
             "smoke = importlib.util.module_from_spec(spec); spec.loader.exec_module(smoke)\n"
             "for name in smoke.CHILD_PRELOAD[1:]: importlib.import_module(name)\n"
             "import torch\n"
             "print(threading.active_count(), torch.cuda.is_initialized(), smoke.CHILD_PRELOAD[0])\n")
    result = subprocess.run([sys.executable, "-c", probe, str(REPO / "chip_smoke.py")], cwd=REPO,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert result.stdout.split() == ["1", "False", "__main__"]


def test_chip_smoke_draws_ahead_the_arrays_drawn_in_turn():
    """The kernel checks' inputs, drawn ahead by a thread, equal those drawn one by one, and
    a shape out of order is refused."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = [(3, 4), (5,), (2, 2, 2)] * 4
    rng = np.random.default_rng(7)
    expected = [rng.standard_normal(shape, dtype=np.float32) for shape in shapes]
    with smoke.Draws(np.random.default_rng(7), shapes, ahead=2) as draw:
        got = [draw(shape) for shape in shapes]
    assert all(np.array_equal(a, b) for a, b in zip(expected, got))
    with smoke.Draws(np.random.default_rng(7), shapes, ahead=2) as draw:  # left early: its thread ends
        with pytest.raises(AssertionError, match="out of order"):
            draw((5,))
    assert len(smoke.FLASH_DRAWS) == 3 * (len(smoke.FLASH_SHAPES) + len(smoke.FLASH_EXTRA_CASES) + len(
        smoke.UNALIGNED_CASES)) + len(smoke.STRIDED_CASES)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_to_run_without_a_card(tmp_path, where):
    script = REPO / "chip_smoke.py"
    if where == "alone":  # a directory holding chip_smoke.py and nothing else of the repo
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = REPO
    result = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120)
    assert result.returncode != 0
    assert '"ok"' not in result.stdout
