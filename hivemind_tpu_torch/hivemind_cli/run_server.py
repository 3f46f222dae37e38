"""Run an expert server (the port of hivemind_tpu/hivemind_cli/run_server.py; the
reference's hivemind/hivemind_cli/run_server.py).

Two modes:
- registry experts: ``--expert_cls`` blocks under ``--expert_uids`` or
  ``--expert_pattern``, trained by Adam on every backward;
- a Llama checkpoint (``--llama_checkpoint``, HF layout): its decoder layers as
  ``llama_block`` backends, as many as fit the card's memory unless
  ``--llama_layers`` says which; ``--mesh_devices N`` serves each block
  tensor-parallel over the first N local cards (``MeshModuleBackend``).

Everything runs on the card unless ``--device cpu`` asks for the CPU's plain
PyTorch path. For example, a DHT node and a server of two cards joining it:

    python -m hivemind_tpu_torch.hivemind_cli.run_dht --listen_host 127.0.0.1
    python -m hivemind_tpu_torch.hivemind_cli.run_server --llama_checkpoint /path/to/hf_llama \\
        --mesh_devices 2 --initial_peers <the DHT's multiaddr>

Before it announces ``serving N experts`` the server logs the kernel launches
that loading made (``kernel launches while loading: {...}``); it then runs until
interrupted (SIGINT), logs the launches of each kernel so far (``kernel launches:
{...}``) and shuts down. The difference of the two lines is what serving launched."""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from hivemind_tpu_torch.moe.server.server import Server
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.platform import add_device_arg, apply_device

logger = get_logger(__name__)


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Run a hivemind_tpu_torch expert server")
    parser.add_argument("--num_experts", type=int, default=None)
    parser.add_argument("--expert_uids", nargs="*", default=None, help="explicit expert uids")
    parser.add_argument("--expert_pattern", default=None, help="e.g. 'ffn.[0:16].[0:16]'")
    parser.add_argument("--expert_cls", default="ffn", help="registered expert class")
    parser.add_argument("--hidden_dim", type=int, default=1024)
    parser.add_argument("--expert_kwargs", default=None,
                        help="JSON dict forwarded to the expert class, e.g. '{\"num_kv_heads\": 2}' for GQA llama_block")
    parser.add_argument("--decode_max_len", type=int, default=256,
                        help="KV-cache decode session capacity (prompt + generated tokens) per client session")
    parser.add_argument("--decode_max_sessions", type=int, default=64,
                        help="LRU cap on concurrent KV-cache decode sessions")
    parser.add_argument("--max_queue_size", type=int, default=1024,
                        help="bounded task-pool queue: submits past this many waiting tasks are shed with "
                             "ServerOverloadedError (counted in hivemind_moe_shed_total)")
    parser.add_argument("--activation_compression", default="float16",
                        help="wire dtype for expert activations and gradients (float16 halves wire bytes; "
                             "'none' = bit-identical fp32), published in expert info and DHT declarations")
    parser.add_argument("--client_rate", type=float, default=None,
                        help="fair-share admission: per-client token budget in samples/s; a client past its "
                             "bucket is shed with ClientOverBudgetError. Default: off")
    parser.add_argument("--client_burst", type=float, default=None,
                        help="token-bucket burst ceiling (default 2s of --client_rate)")
    parser.add_argument("--replica_slots", type=int, default=0,
                        help="acquire up to this many hot experts from other servers")
    parser.add_argument("--replicate_hot_experts", action="store_true",
                        help="advertise this server's hot experts for replication by other servers")
    parser.add_argument("--replication_watch_grids", nargs="*", default=None,
                        help="grid roots to scan for replica_wanted adverts (default: this server's own)")
    parser.add_argument("--custom_module_path", default=None,
                        help="path to a .py file whose @register_expert_class decorators run before the server starts")
    parser.add_argument("--max_batch_size", type=int, default=4096)
    parser.add_argument("--initial_peers", nargs="*", default=[])
    parser.add_argument("--checkpoint_dir", default=None)
    parser.add_argument("--llama_checkpoint", default=None,
                        help="serve an HF-layout Llama checkpoint: decoder layers load into llama_block backends")
    parser.add_argument("--llama_layers", default=None,
                        help="'start:stop' layer range of --llama_checkpoint to serve (default: as many as the "
                             "card's memory plan allows from the start, or all on the CPU)")
    parser.add_argument("--llama_uid_prefix", default="llama.")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="serve each block tensor-parallel over this many local cards (0 = one device). "
                             "The memory plan uses the probe block's measured bytes per card")
    parser.add_argument("--weight_quantization", choices=["int8"], default=None,
                        help="serve blocks int8 weight-only via the blockwise codec (4x less resident memory; "
                             "inference-only)")
    parser.add_argument("--decode_sessions_budget", type=int, default=8,
                        help="concurrent decode sessions the memory plan reserves KV-cache space for")
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--max_connections", type=int, default=0,
                        help="connection-manager high water for the DHT peer (0 = unlimited)")
    parser.add_argument("--increase_file_limit", action="store_true",
                        help="raise RLIMIT_NOFILE for many concurrent connections")
    parser.add_argument("--metrics-port", "--metrics_port", type=int, default=None, dest="metrics_port",
                        help="serve Prometheus text exposition at http://<metrics_host>:PORT/metrics (0 = auto-pick)")
    parser.add_argument("--metrics_host", default="127.0.0.1",
                        help="bind host of the metrics endpoint (0.0.0.0 for remote scrapers)")
    parser.add_argument("--telemetry_key", default=None,
                        help="publish this server's telemetry snapshot to the DHT under this key "
                             "every --telemetry_interval seconds")
    parser.add_argument("--telemetry_interval", type=float, default=30.0)
    parser.add_argument("--blackbox_dir", default=None,
                        help="crash-durable flight-recorder spool directory (spans, serving ledger records, "
                             "metric snapshots as msgpack frames)")
    parser.add_argument("--no_device_telemetry", action="store_false", dest="device_telemetry",
                        help="disable device-side observability (memory sampling on the watchdog tick); on by default")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    if args.increase_file_limit:
        from hivemind_tpu_torch.utils.limits import increase_file_limit

        increase_file_limit()

    if args.custom_module_path:
        import importlib.util
        import sys

        spec = importlib.util.spec_from_file_location("hivemind_custom_experts", args.custom_module_path)
        if spec is None or spec.loader is None:
            raise RuntimeError(f"cannot load {args.custom_module_path}")
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module  # classes' __module__ must resolve (pickling etc.)
        spec.loader.exec_module(module)  # runs the @register_expert_class decorators
        logger.info(f"loaded custom expert module {args.custom_module_path}")

    if args.llama_checkpoint:
        server = _serve_llama_checkpoint(args)
        _run_forever(server, _start_telemetry(args, server.dht))
        return
    if args.mesh_devices:
        raise SystemExit("--mesh_devices is only supported with --llama_checkpoint serving; "
                         "the registry-expert path would silently ignore it")

    from hivemind_tpu_torch.dht import DHT

    device = apply_device(args)  # before the DHT starts: no card, no server
    # construct the DHT here so --max_connections reaches its transport
    dht = DHT(initial_peers=args.initial_peers, start=True, max_connections=args.max_connections)
    server = Server.create(
        num_experts=args.num_experts,
        expert_uids=args.expert_uids,
        expert_pattern=args.expert_pattern,
        expert_cls=args.expert_cls,
        hidden_dim=args.hidden_dim,
        expert_kwargs=json.loads(args.expert_kwargs) if args.expert_kwargs else None,
        max_batch_size=args.max_batch_size,
        dht=dht,
        checkpoint_dir=Path(args.checkpoint_dir) if args.checkpoint_dir else None,
        decode_max_len=args.decode_max_len,
        decode_max_sessions=args.decode_max_sessions,
        max_queue_size=args.max_queue_size,
        activation_compression=args.activation_compression,
        client_rate=args.client_rate,
        client_burst=args.client_burst,
        replica_slots=args.replica_slots,
        replicate_hot_experts=args.replicate_hot_experts,
        replication_watch_grids=args.replication_watch_grids,
        # optax.adam(learning_rate): betas (0.9, 0.999), eps 1e-8, as Server's default optimizer
        optim_factory=lambda params: torch.optim.Adam(params, lr=args.learning_rate, betas=(0.9, 0.999), eps=1e-8),
        device=device,
        start=True,
    )
    _run_forever(server, _start_telemetry(args, dht))


def _serve_llama_checkpoint(args) -> Server:
    """Serve a checkpoint's decoder layers, choosing how many fit this card (or
    mesh of cards) when no explicit range is given."""
    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.moe.server.llama_loader import (
        LlamaCheckpointConfig,
        decode_cache_bytes,
        device_hbm_bytes,
        load_llama_blocks,
        plan_block_capacity,
    )
    from hivemind_tpu_torch.moe.server.mesh_backend import ServingMesh, local_cards

    mesh: Optional[ServingMesh] = None
    if args.mesh_devices:
        # the first N local cards, one shard each (the JAX package: jax.local_devices()[:N])
        if args.device == "cpu":  # the CPU has no cards to shard over
            raise RuntimeError(f"--mesh_devices {args.mesh_devices} but only 0 local devices")
        mesh = local_cards(args.mesh_devices)
    device = mesh.devices[0] if mesh is not None else apply_device(args)

    config = LlamaCheckpointConfig.load(args.llama_checkpoint)
    if args.llama_layers:
        start, _, stop = args.llama_layers.partition(":")
        layers = range(int(start or 0), int(stop or config.num_hidden_layers))
    else:
        layers = range(config.num_hidden_layers)
        hbm = device_hbm_bytes(device)
        if hbm is not None:
            # measure one real block, then plan with KV-cache headroom
            probe, _ = load_llama_blocks(args.llama_checkpoint, layers=[0], uid_prefix="_probe.",
                                         weight_quantization=args.weight_quantization, device=device, mesh=mesh)
            probe_backend = next(iter(probe.values()))
            # mesh serving: plan from the measured bytes per card, not an assumed 1/N
            block_bytes = probe_backend.param_bytes_per_device() if mesh is not None else probe_backend.param_bytes()
            del probe, probe_backend  # released before the real load fills the plan
            fit = plan_block_capacity(
                block_bytes,
                hbm_bytes=hbm,
                decode_sessions=args.decode_sessions_budget,
                # conservative: full per-session caches budgeted on every card
                cache_bytes_per_session_block=decode_cache_bytes(config, batch=1, max_len=args.decode_max_len),
            )
            layers = range(min(fit, config.num_hidden_layers))
            logger.info(
                f"memory plan: {block_bytes / 1e6:.0f} MB/block resident per card "
                f"({'mesh of ' + str(args.mesh_devices) if mesh is not None else 'single device'}), "
                f"{hbm / 1e9:.1f} GB/card → serving {len(layers)} of {config.num_hidden_layers} layers"
            )
    backends, _config = load_llama_blocks(
        args.llama_checkpoint,
        layers=layers,
        uid_prefix=args.llama_uid_prefix,
        weight_quantization=args.weight_quantization,
        max_batch_size=args.max_batch_size,
        device=device,
        mesh=mesh,
    )
    dht = DHT(initial_peers=args.initial_peers, start=True, max_connections=args.max_connections)
    server = Server(
        dht, backends, decode_max_len=args.decode_max_len,
        # the memory plan reserved KV space for exactly this many sessions: cap the
        # session manager to it so the reservation is real, not advisory
        decode_max_sessions=args.decode_sessions_budget,
        max_queue_size=args.max_queue_size,
        activation_compression=args.activation_compression,
        client_rate=args.client_rate,
        client_burst=args.client_burst,
        device=device,
    )
    server.run_in_background(await_ready=True)
    return server


def _start_telemetry(args, dht):
    """The optional metrics endpoint, black box and DHT snapshot publisher; returns
    the components to shut down."""
    import types

    from hivemind_tpu_torch.telemetry import ensure_watchdog
    from hivemind_tpu_torch.utils.loop import get_loop_runner

    # the server and the DHT already armed the loop watchdog; stay loud if it is disabled
    if ensure_watchdog(get_loop_runner().loop) is None:
        logger.warning("event-loop watchdog disabled (HIVEMIND_WATCHDOG=0): stalls will be silent")
    components = []
    if args.device_telemetry:
        from hivemind_tpu_torch.telemetry.device import arm_device_telemetry, disarm_device_telemetry

        arm_device_telemetry()
        components.append(types.SimpleNamespace(shutdown=disarm_device_telemetry))
    if args.blackbox_dir:
        from hivemind_tpu_torch.telemetry.blackbox import arm_blackbox, disarm_blackbox

        arm_blackbox(args.blackbox_dir, peer=str(dht.peer_id))
        logger.info(f"black-box recorder armed: spooling to {args.blackbox_dir}")
        # disarm (not just close) at shutdown, so the global slot is free for what arms next
        components.append(types.SimpleNamespace(shutdown=disarm_blackbox))
    if args.metrics_port is not None:
        from hivemind_tpu_torch.telemetry import MetricsExporter

        components.append(MetricsExporter(port=args.metrics_port, host=args.metrics_host))
    if args.telemetry_key:
        from hivemind_tpu_torch.telemetry import TelemetryPublisher

        components.append(TelemetryPublisher(dht, args.telemetry_key, interval=args.telemetry_interval))
    return tuple(components)


def kernel_launches() -> dict:
    """The launches of each kernel wrapper in this process so far."""
    from hivemind_tpu_torch.ops import blockwise_int8, flash_attention

    wrappers = (flash_attention.flash_attention_lse, flash_attention.flash_attention_backward_dq,
                flash_attention.flash_attention_backward_dkv, blockwise_int8.blockwise_int8_quantize,
                blockwise_int8.blockwise_int8_dequantize, blockwise_int8.blockwise_int8_dequantize_window)
    return {wrapper.__name__: wrapper.launches for wrapper in wrappers}


def _run_forever(server: Server, telemetry=()) -> None:
    for maddr in server.dht.get_visible_maddrs():
        logger.info(f"listening: {maddr}")
    # before the announcement a client waits for: every launch after it was made serving
    logger.info(f"kernel launches while loading: {json.dumps(kernel_launches())}")
    logger.info(f"serving {len(server.backends)} experts: {sorted(server.backends)[:8]}…")
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        logger.info("shutting down")
        logger.info(f"kernel launches: {json.dumps(kernel_launches())}")
        for component in telemetry:
            component.shutdown()
        server.shutdown()
        server.dht.shutdown()


if __name__ == "__main__":
    main()
