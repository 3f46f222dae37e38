"""The port's entry points on the CPU: ``run_dht`` and ``run_server --device cpu
--llama_checkpoint`` start as child processes under a time limit and a client
generates through them (with the lossless "none" wire, so the served ids equal a
local generation's exactly); ``--mesh_devices`` on a host without cards raises the
JAX package's error; ``increase_file_limit`` does what the JAX package's does and
never lowers an unlimited hard limit; the entry points run on the card by default;
the two ported examples run as clients against servers of the port."""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from hivemind_tpu.utils import limits as jax_limits
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.examples import llama_generate, pipeline_inference
from hivemind_tpu_torch.hivemind_cli import run_server
from hivemind_tpu_torch.moe.server.decode_session import DecodeSessionManager
from hivemind_tpu_torch.moe.server.llama_loader import LlamaClientHead, generate_greedy, load_llama_blocks
from hivemind_tpu_torch.moe.server.server import Server
from hivemind_tpu_torch.utils import limits

from test_llama_loader import HID, _write_checkpoint

REPO = Path(__file__).resolve().parent.parent
STARTUP_LIMIT_S = 90.0
PROMPT, NEW, VOCAB = [[3, 1, 4, 1, 5]], 6, 96


def _write_checkpoint_with_head(path: Path) -> None:
    """The tiny checkpoint of tests/test_llama_loader.py, plus the client's ends (a tied
    embedding and the final norm) in a shard of their own."""
    _write_checkpoint(path)
    rng = np.random.RandomState(1)
    head = {"model.embed_tokens.weight": (rng.randn(VOCAB, HID) * 0.5).astype(np.float32),
            "model.norm.weight": np.ones(HID, np.float32)}
    save_file(head, path / "model-head.safetensors")
    index = json.loads((path / "model.safetensors.index.json").read_text())
    index["weight_map"].update({name: "model-head.safetensors" for name in head})
    (path / "model.safetensors.index.json").write_text(json.dumps(index))


class LocalPipe:
    """``decode_step`` over the blocks of one process (the reference generation)."""

    def __init__(self, blocks):
        self.blocks, self.manager = blocks, DecodeSessionManager(blocks, max_len=64)

    def decode_step(self, hidden, session_id, reset=False):
        x = hidden.cpu().numpy() if isinstance(hidden, torch.Tensor) else hidden
        for uid in self.blocks:
            x = self.manager.decode(uid, session_id, x, reset)
        return x


def _start(module: str, *args: str, log_path: Path) -> subprocess.Popen:
    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, "-m", f"hivemind_tpu_torch.hivemind_cli.{module}", *args],
                                stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
                                env=dict(os.environ, PYTHONPATH=str(REPO)))


def _wait_for(process: subprocess.Popen, log_path: Path, pattern: str) -> re.Match:
    deadline = time.monotonic() + STARTUP_LIMIT_S
    while time.monotonic() < deadline:
        found = re.search(pattern, log_path.read_text(errors="replace"))
        if found:
            return found
        assert process.poll() is None, f"{process.args[2]} exited:\n{log_path.read_text()[-3000:]}"
        time.sleep(0.1)
    raise TimeoutError(f"{process.args[2]} logged no {pattern!r} in {STARTUP_LIMIT_S} s")


def test_run_dht_and_run_server_serve_a_client_on_the_cpu(tmp_path):
    checkpoint = tmp_path / "tiny"
    checkpoint.mkdir()
    _write_checkpoint_with_head(checkpoint)
    logs = {name: tmp_path / f"{name}.log" for name in ("run_dht", "run_server")}
    children, client = [], None
    try:
        children.append(_start("run_dht", "--listen_host", "127.0.0.1", "--refresh_period", "1",
                               log_path=logs["run_dht"]))
        maddr = _wait_for(children[0], logs["run_dht"], r"--initial_peers (\S+)").group(1)
        children.append(_start("run_server", "--device", "cpu", "--llama_checkpoint", str(checkpoint),
                               "--mesh_devices", "0", "--activation_compression", "none", "--initial_peers", maddr,
                               log_path=logs["run_server"]))
        serving = _wait_for(children[1], logs["run_server"], r"serving 2 experts")
        # the launches that loading made are logged before the announcement a client waits for
        assert _wait_for(children[1], logs["run_server"], r"kernel launches while loading: \{.*\}").end() < serving.start()
        client = DHT(initial_peers=[maddr], start=True)
        # the ported example's client mode, through the swarm the entry points made
        ids = llama_generate.main(["--checkpoint", str(checkpoint), "--generate", str(NEW), "--initial_peers", maddr,
                                   "--device", "cpu", "--prompt_ids", *map(str, PROMPT[0])])
        local = load_llama_blocks(checkpoint, device="cpu")[0]
        head = LlamaClientHead.load(checkpoint, device="cpu")
        np.testing.assert_array_equal(ids, generate_greedy(head, LocalPipe(local), np.asarray(PROMPT), NEW))
        _wait_for(children[0], logs["run_dht"], r"health: \d+ peers in routing table")
        for child in children:
            child.send_signal(signal.SIGINT)  # the entry points stop through their shutdown path
        for child in children:
            assert child.wait(30) == 0
        launches = _wait_for(children[1], logs["run_server"], r"kernel launches: (\{.*\})").group(1)
        assert '"flash_attention_lse": 0' in launches  # the CPU runs the plain versions
    finally:
        if client is not None:
            client.shutdown()
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()


def test_run_server_publishes_telemetry_that_run_top_reads(tmp_path):
    """``run_server --telemetry_key`` publishes its snapshot to the DHT, and ``run_top
    --serving`` (a child, as a user runs it) renders the served experts' board from it."""
    checkpoint = tmp_path / "tiny"
    checkpoint.mkdir()
    _write_checkpoint_with_head(checkpoint)
    logs = {name: tmp_path / f"{name}.log" for name in ("run_dht", "run_server")}
    children = []
    try:
        children.append(_start("run_dht", "--listen_host", "127.0.0.1", log_path=logs["run_dht"]))
        maddr = _wait_for(children[0], logs["run_dht"], r"--initial_peers (\S+)").group(1)
        children.append(_start("run_server", "--device", "cpu", "--llama_checkpoint", str(checkpoint),
                               "--initial_peers", maddr, "--telemetry_key", "cli_telemetry", "--telemetry_interval",
                               "1", log_path=logs["run_server"]))
        _wait_for(children[1], logs["run_server"], r"serving 2 experts")
        llama_generate.main(["--checkpoint", str(checkpoint), "--generate", "2", "--initial_peers", maddr,
                             "--device", "cpu", "--prompt_ids", *map(str, PROMPT[0])])
        time.sleep(1.5)  # the publisher's next snapshot holds the served requests
        top = subprocess.run([sys.executable, "-m", "hivemind_tpu_torch.hivemind_cli.run_top", "--initial_peers", maddr,
                              "--key", "cli_telemetry", "--frames", "1", "--no-ansi", "--serving", "--device"],
                             capture_output=True, text=True, timeout=120, cwd=REPO)
        assert top.returncode == 0, top.stderr
        board = top.stdout[top.stdout.index("serving board"):]
        assert "llama.0" in board and "kind=decode" in board, top.stdout
        assert "device board" in top.stdout
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()


def test_mesh_devices_without_a_card_raises_the_jax_packages_error(tmp_path):
    _write_checkpoint(tmp_path)
    for device in (["--device", "cpu"], []):  # asked for the CPU, or by default on a host without cards
        with pytest.raises(RuntimeError, match=r"^--mesh_devices 2 but only 0 local devices$"):
            run_server.main(["--llama_checkpoint", str(tmp_path), "--mesh_devices", "2", *device])
    with pytest.raises(SystemExit, match="only supported with --llama_checkpoint"):
        run_server.main(["--mesh_devices", "2", "--device", "cpu"])


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(tmp_path):
    _write_checkpoint(tmp_path)
    for entry_point in (
        lambda: run_server.main(["--expert_cls", "nop", "--expert_uids", "nop.0", "--hidden_dim", "4"]),
        lambda: run_server.main(["--llama_checkpoint", str(tmp_path)]),
        lambda: llama_generate.main(["--checkpoint", str(tmp_path), "--serve", "0:1"]),
        lambda: pipeline_inference.main(["--serve", "blk.0"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry_point()


class _FakeResource:
    RLIMIT_NOFILE, RLIM_INFINITY = 7, -1

    def __init__(self, soft, hard):
        self.limits, self.calls = (soft, hard), []

    def getrlimit(self, which):
        return self.limits

    def setrlimit(self, which, limits):
        self.calls.append((which, limits))


@pytest.mark.parametrize("soft, hard", [(1024, -1), (1024, 4096), (1024, 2**20), (2**16, -1), (2**16, 2**20)])
def test_increase_file_limit_matches_jax_and_never_lowers_an_unlimited_hard_limit(monkeypatch, soft, hard):
    calls = []
    for module in (limits, jax_limits):
        fake = _FakeResource(soft, hard)
        monkeypatch.setitem(sys.modules, "resource", fake)
        module.increase_file_limit()
        calls.append(fake.calls)
    assert calls[0] == calls[1]
    for _which, (new_soft, new_hard) in calls[0]:
        assert new_hard == hard  # the hard limit is kept, an unlimited one above all
        assert soft < new_soft <= (new_hard if new_hard != -1 else new_soft)
    assert bool(calls[0]) == (soft < 2**15)


def test_pipeline_example_generates_through_a_server_of_the_port():
    server = Server.create(expert_uids=["blk.0", "blk.1"], expert_cls="causal_transformer", hidden_dim=64,
                           device="cpu", start=True)
    try:
        maddr = str(server.dht.get_visible_maddrs()[0])
        deadline = time.monotonic() + 30
        out = None
        while out is None:
            try:  # the server declares its experts in the background as it starts
                out = pipeline_inference.main(["--num_blocks", "2", "--prefix", "blk.", "--initial_peers", maddr,
                                               "--device", "cpu", "--seq_len", "8", "--batch_size", "2"])
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        assert tuple(out.shape) == (2, 8, 64) and torch.isfinite(out).all()
        tokens = pipeline_inference.main(["--num_blocks", "2", "--prefix", "blk.", "--initial_peers", maddr,
                                          "--device", "cpu", "--generate", "4"])
        assert len(tokens) == 5 and tokens[0] == 1
    finally:
        server.shutdown()
        server.dht.shutdown()

