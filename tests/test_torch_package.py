"""The PyTorch port as a package: it imports no JAX and nothing of the JAX package,
its entry points refuse to run without a card unless asked for the CPU, its tensor
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

# the wire layer needs msgpack and protobuf, which the card's machine lacks; every
# other module of the port (the card's path) and chip_smoke.py load neither
WIRE_MODULES = ("hivemind_tpu_torch.compression", "hivemind_tpu_torch.proto", "hivemind_tpu_torch.utils.serializer")

_ISOLATION_PROBE = """
import importlib, importlib.util, pathlib, sys
import numpy as np
import torch
import hivemind_tpu_torch

WIRE = %r
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
# from the file system: pkgutil.walk_packages would import each package to walk it
root = pathlib.Path(hivemind_tpu_torch.__file__).parent
modules = sorted(".".join(("hivemind_tpu_torch",) + path.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
                 for path in root.rglob("*.py"))
for name in modules:
    if not name.startswith(WIRE):
        importlib.import_module(name)
assert "hivemind_tpu_torch.moe.server.decode_session" in sys.modules
wire_leaked = sorted(name for name in sys.modules if name.split(".")[0] == "msgpack" or name.startswith("google.protobuf"))
assert not wire_leaked, wire_leaked
for name in modules:
    importlib.import_module(name)
assert "msgpack" in sys.modules and "google.protobuf" in sys.modules
leaked = sorted(name for name in sys.modules
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hivemind_tpu", "ml_dtypes"))
assert not leaked, leaked

assert not torch.cuda.is_available()
from hivemind_tpu_torch.moe.server.layers import NopExpert
from hivemind_tpu_torch.moe.server.llama_loader import device_hbm_bytes, load_llama_blocks
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
from hivemind_tpu_torch.models.albert import AlbertConfig, make_train_step
refused = 0
for entry_point in (
    lambda: ModuleBackend("nop", NopExpert(4), sample_input=np.zeros((1, 4), np.float32)),
    lambda: load_llama_blocks("/nonexistent"),
    lambda: device_hbm_bytes(),
    lambda: make_train_step(AlbertConfig.tiny(), lambda params: torch.optim.AdamW(params)),
):
    try:
        entry_point()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
        refused += 1
assert refused == 4, refused
backend = ModuleBackend("nop", NopExpert(4), sample_input=np.zeros((1, 4), np.float32), device="cpu")
assert backend.forward(np.ones((2, 4), np.float32))[0].tolist() == [[1.0] * 4] * 2
assert backend.backward(np.ones((2, 4), np.float32), np.ones((2, 4), np.float32))[0].tolist() == [[1.0] * 4] * 2
import hivemind_tpu_torch.models.albert
assert "flash_attention_bwd" in hivemind_tpu_torch.ops._build.SOURCES
leaked = sorted(name for name in sys.modules if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hivemind_tpu"))
assert not leaked, leaked
print("isolated")
""" % (WIRE_MODULES,)


def test_package_imports_no_jax_and_refuses_to_run_without_cuda():
    """In a fresh interpreter (the test process itself has jax loaded by conftest)."""
    result = subprocess.run(
        [sys.executable, "-c", _ISOLATION_PROBE], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip().endswith("isolated")


def test_package_sources_never_name_the_jax_stack():
    forbidden = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|hivemind_tpu|ml_dtypes)(\.|\s|$)", re.MULTILINE)
    sources = sorted(PACKAGE.rglob("*.py"))
    assert {"compression", "proto", "moe"} <= {path.relative_to(PACKAGE).parts[0] for path in sources}
    offenders = [str(path.relative_to(REPO)) for path in sources if forbidden.search(path.read_text())]
    assert not offenders, offenders
    # the card's path imports no wire module at its top (the wire layer imports
    # msgpack and protobuf at its own top), and chip_smoke.py none anywhere
    wire = r"(import|from)\s+(msgpack|google\.protobuf|" + "|".join(map(re.escape, WIRE_MODULES)) + r")(\.|\s|$)"
    card_path = [path for path in sources
                 if not ".".join(path.relative_to(REPO).with_suffix("").parts).startswith(WIRE_MODULES)]
    offenders = [str(path.relative_to(REPO)) for path in card_path if re.search("^" + wire, path.read_text(), re.MULTILINE)]
    assert not offenders, offenders
    assert not re.search(r"^\s*" + wire, (REPO / "chip_smoke.py").read_text(), re.MULTILINE)


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
