"""The port's swarm tooling against the JAX package's: ``utils/nested.py``,
``hivemind_cli/run_blackbox.py`` and ``hivemind_cli/run_top.py`` on the same
structures and the same black-box spools, and the lazy top-level API.

The black-box spool is a wire format both packages share (``telemetry/blackbox.py``),
so a spool the port's ``BlackBox`` writes is read by both tools, and their outputs
are held equal: the ``--format json`` report and the Chrome trace exactly, the
dashboard frame line for line."""

from __future__ import annotations

import inspect
import io
import json
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import hivemind_tpu
import hivemind_tpu_torch
from hivemind_tpu.hivemind_cli import run_blackbox as jax_blackbox
from hivemind_tpu.hivemind_cli import run_top as jax_top
from hivemind_tpu.utils import nested as jax_nested
from hivemind_tpu_torch.hivemind_cli import run_blackbox, run_top
from hivemind_tpu_torch.p2p.nat import NATTraversal
from hivemind_tpu_torch.telemetry.blackbox import BlackBox, read_spool
from hivemind_tpu_torch.telemetry.tracing import start_span, trace
from hivemind_tpu_torch.utils import nested

REPO = Path(__file__).resolve().parent.parent

# ---------------------------------------------------------------------- nested

_leaves = st.one_of(st.integers(-1000, 1000), st.text(max_size=4), st.none(), st.floats(allow_nan=False))
_structures = st.recursive(
    _leaves,
    lambda children: st.one_of(st.lists(children, max_size=4), st.tuples(children, children),
                               st.dictionaries(st.text(max_size=3), children, max_size=4)),
    max_leaves=20,
)


@settings(max_examples=60, deadline=None)
@given(_structures)
def test_nested_flatten_pack_and_map_match_the_jax_package(structure):
    flat = list(nested.nested_flatten(structure))
    assert flat == list(jax_nested.nested_flatten(structure))
    assert nested.nested_pack(flat, structure) == jax_nested.nested_pack(flat, structure) == structure
    tag = lambda leaf: ("leaf", leaf)
    assert nested.nested_map(tag, structure) == jax_nested.nested_map(tag, structure)
    pair = lambda a, b: (a, b)
    assert nested.nested_map(pair, structure, structure) == jax_nested.nested_map(pair, structure, structure)


@settings(max_examples=60, deadline=None)
@given(_structures, _structures)
def test_nested_compare_matches_the_jax_package(first, second):
    assert nested.nested_compare(first, second) == jax_nested.nested_compare(first, second)
    assert nested.nested_compare(first, first)


def test_nested_map_needs_a_structure_and_utils_export_it():
    with pytest.raises(ValueError, match="at least one structure"):
        nested.nested_map(lambda: None)
    from hivemind_tpu_torch import utils

    assert utils.nested_flatten is nested.nested_flatten and utils.nested_pack is nested.nested_pack
    assert utils.nested_map is nested.nested_map and utils.nested_compare is nested.nested_compare


# ---------------------------------------------------------------------- black box and top


@pytest.fixture
def spools(tmp_path):
    """Two peers' spools written by the port's BlackBox: peerA finished a step, spooled
    two ledger rounds and died inside an all-reduce (abandoned, its segment left
    open); peerB published cleanly."""
    a, b = tmp_path / "peerA", tmp_path / "peerB"
    box_b = BlackBox(b, peer="peerB", metrics_interval=None, peer_filter="peerB")
    box_a = BlackBox(a, peer="peerA", metrics_interval=None, peer_filter="peerA")
    with trace("dht.store", peer="peerA"):
        pass
    with trace("optimizer.step", peer="peerB"):
        pass
    for round_ in (1, 2):
        box_a.writer.append("ledger_round", {
            "round": round_, "peer": "peerA", "slowest_peer": "peerB",
            "exchanges": [{"peer": "peerB", "dur_s": 2.0 + round_}, {"peer": "peerC", "dur_s": 0.5}]})
    box_a.snapshot_metrics()
    start_span("averaging.allreduce", peer="peerA")  # the operation peerA dies inside
    box_a.abandon()
    box_b.close()
    return a, b


def _captured(main, argv) -> str:
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_blackbox_json_report_equals_the_jax_tools(spools):
    a, b = spools
    for argv in ([str(a), str(b), "--format", "json"], [str(a), str(b), "--victim", "peerA", "--format", "json"],
                 [str(a), "--victim", "peerA", "--last", "30", "--format", "json"]):
        ours = _captured(run_blackbox.main, argv)
        assert ours == _captured(jax_blackbox.main, argv), argv
    report = json.loads(ours)
    post = report["postmortem"]["peerA"]
    assert post["final_round"]["round"] == 2 and post["last_in_flight"]["name"] == "averaging.allreduce"
    frames, stats = read_spool(a)
    assert run_blackbox.reconstruct_final_round(frames, stats) == jax_blackbox.reconstruct_final_round(frames, stats)


def test_blackbox_text_and_chrome_outputs_equal_the_jax_tools(spools, tmp_path):
    a, b = spools
    argv = [str(a), str(b), "--victim", "peerA"]
    text = _captured(run_blackbox.main, argv)
    assert text == _captured(jax_blackbox.main, argv) and "averaging.allreduce" in text
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    assert run_blackbox.main([str(a), str(b), "--format", "chrome", "--out", str(ours)]) == 0
    assert jax_blackbox.main([str(a), str(b), "--format", "chrome", "--out", str(theirs)]) == 0
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    names = {event.get("name") for event in json.loads(ours.read_text())["traceEvents"]}
    assert {"dht.store", "optimizer.step", "averaging.allreduce"} <= names


def test_top_from_spool_prints_the_jax_tools_frame(spools, monkeypatch):
    a, b = spools
    argv = ["--frames", "1", "--no-ansi", "--from-spool", str(a), str(b)]
    ours = _captured(run_top.main, argv)
    monkeypatch.setattr(sys, "argv", ["hivemind-top", *argv])
    out = io.StringIO()
    with redirect_stdout(out):
        jax_top.main()
    assert ours == out.getvalue()
    assert "peerA" in ours and "peerB" in ours


def test_top_boards_render_the_jax_tools_frames(spools):
    """The serving and device boards over one snapshot set (as fetched from the DHT),
    and two frames in a row (the rates come from frame-to-frame deltas)."""
    a, b = spools
    records = {peer: run_blackbox.spool_snapshot(spool) for peer, spool in run_blackbox.load_spools([a, b]).items()}
    records["peerA"]["serving"] = {
        "totals": {"requests": 120, "errors": 3, "sheds": 2},
        "experts": {"ffn.0": {"requests": 100, "p95_s": 0.04, "sheds": 2}, "ffn.1": {"requests": 20, "p95_s": 0.01}},
        "saturation": {"queue_depth": {"pool=ffn.0_forward": 7}, "runtime_utilization": {"_": 0.93},
                       "decode_session_occupancy": {"_": 0.5}, "sheds": 2},
        "scorecards": {"far.9": {"requests": 10, "success_rate": 0.5, "timeouts": 3, "sheds": 2, "failures": 0}},
        "slowest": [{"expert": "ffn.0", "kind": "forward", "client": "cliX", "total_s": 0.31, "queue_wait_s": 0.28,
                     "compute_s": 0.02}],
    }
    records["peerB"]["serving"] = {"experts": "nope", "saturation": 3}  # a malformed section gets a flagged row
    later = json.loads(json.dumps(records))
    later["peerA"]["time"] = records["peerA"]["time"] + 5.0
    later["peerA"]["serving"]["experts"]["ffn.0"]["requests"] = 150
    for module in (run_top, jax_top):
        assert module.DEFAULT_PUBLISH_INTERVAL == run_top.DEFAULT_PUBLISH_INTERVAL
    frames = []
    for module in (run_top, jax_top):
        frame, samples = module.render_frame(records, now=records["peerA"]["time"], ansi=False)
        frame2, _ = module.render_frame(later, now=later["peerA"]["time"], prev_samples=samples, ansi=False)
        board, previous = module.render_serving_board(records, now=records["peerA"]["time"], ansi=False)
        board2, _ = module.render_serving_board(later, prev_requests=previous, now=later["peerA"]["time"], ansi=False)
        frames.append((frame, frame2, board, board2, module.render_device_board(records, ansi=False)))
    assert frames[0] == frames[1]
    assert "ffn.0" in frames[0][3] and "10.0" in frames[0][3]  # 50 requests over 5 s
    assert "<malformed serving section>" in frames[0][2]


# ---------------------------------------------------------------------- the top-level API


def test_every_top_level_name_resolves_to_the_ports_class():
    table = re.findall(r'"(\w+)": "hivemind_tpu[.\w]*"', inspect.getsource(hivemind_tpu.__getattr__))
    assert len(table) == 29 and "NATTraversal" in table
    assert sorted(hivemind_tpu_torch._LAZY) == sorted(table)  # the JAX package's table, NATTraversal included
    for name in table:
        ours, theirs = getattr(hivemind_tpu_torch, name), getattr(hivemind_tpu, name)
        assert getattr(ours, "__name__", type(ours).__name__) == getattr(theirs, "__name__", type(theirs).__name__)
        assert (getattr(ours, "__module__", None) or type(ours).__module__).startswith("hivemind_tpu_torch."), name
    from hivemind_tpu_torch.utils import loop, serializer, timed_storage

    for module, names in ((loop, ("EventLoopShutdownError", "LoopRunner", "get_loop_runner")),
                          (serializer, ("MSGPackSerializer",)),
                          (timed_storage, ("DHTExpiration", "TimedStorage", "ValueWithExpiration", "get_dht_time"))):
        for name in names:  # the eager names, as the JAX package's
            assert getattr(hivemind_tpu_torch, name) is getattr(module, name) and hasattr(hivemind_tpu, name), name
    assert hivemind_tpu_torch.NATTraversal is NATTraversal  # resolves since the relay/NAT slice
    with pytest.raises(AttributeError, match="no attribute 'nonexistent'"):
        hivemind_tpu_torch.nonexistent


def test_importing_the_package_loads_no_jax():
    probe = ("import sys, hivemind_tpu_torch; assert hivemind_tpu_torch.run_scenario; "
             "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'hivemind_tpu')]")
    subprocess.run([sys.executable, "-c", probe], cwd=REPO, check=True, timeout=120)
