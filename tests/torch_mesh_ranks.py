"""Ranks of the port's mesh for the CPU tests: a pool of spawned processes joined in one
gloo process group, and the functions each rank runs. This module imports the port
only (never JAX), since every rank imports it; the tests hold what the ranks return
to the JAX package."""

from __future__ import annotations

import datetime
import multiprocessing
import socket
import time
import traceback

GLOO_TIMEOUT_S = 60.0  # a rank stuck in a collective raises after this long


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _serve(rank: int, world: int, port: int, conn) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
        conn.send(("ready", None))
        while True:
            message = conn.recv()
            if message is None:
                break
            fn, args = message
            try:
                conn.send(("ok", fn(rank, *args)))
            except BaseException:
                conn.send(("error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """``world`` spawned ranks of one gloo process group; ``run(fn, *args)`` calls
    ``fn(rank, *args)`` on every rank (``fn`` a function of this module) and returns the
    results by rank. A rank that fails or times out kills the pool, which starts anew at
    the next ``run``."""

    def __init__(self, world: int):
        self.world = world
        self.processes, self.conns = [], []

    def _start(self) -> None:
        context = multiprocessing.get_context("spawn")
        port = free_port()
        for rank in range(self.world):
            parent, child = context.Pipe()
            process = context.Process(target=_serve, args=(rank, self.world, port, child), daemon=True)
            process.start()
            child.close()
            self.processes.append(process)
            self.conns.append(parent)
        self._collect(120.0)

    def _collect(self, timeout: float) -> list:
        deadline, results = time.monotonic() + timeout, []
        try:
            for rank, conn in enumerate(self.conns):
                if not conn.poll(max(deadline - time.monotonic(), 0.0)):
                    raise TimeoutError(f"rank {rank} did not answer within {timeout:.0f} s")
                try:
                    status, value = conn.recv()
                except EOFError:
                    raise RuntimeError(f"rank {rank} exited with code {self.processes[rank].exitcode}") from None
                if status == "error":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                results.append(value)
        except BaseException:
            self.close()
            raise
        return results

    def run(self, fn, *args, timeout: float = 90.0) -> list:
        if not self.processes:
            self._start()
        for conn in self.conns:
            conn.send((fn, args))
        return self._collect(timeout)

    def close(self) -> None:
        for conn in self.conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for process in self.processes:
            process.join(5)
            if process.is_alive():
                process.kill()
                process.join(5)
        self.processes, self.conns = [], []


def _mesh(shape, device="cpu"):
    from hivemind_tpu_torch.parallel import make_mesh

    return make_mesh(*shape, backend="gloo", device=device)


# ---------------------------------------------------------------- the mesh


def mesh_layout(rank, shape, cases):
    """This rank's coordinate, its ranks along each axis, and its region of each
    ``(shape, spec, transposed)`` case (a NamedSharding of the port)."""
    from hivemind_tpu_torch.parallel.mesh import AXES, NamedSharding, batch_sharding

    mesh = _mesh(shape)
    bounds = lambda slices, full: [s.indices(n)[:2] for s, n in zip(slices, full)]
    regions = [bounds(NamedSharding(mesh, spec, transposed).region(full, mesh.coordinate), full)
               for full, spec, transposed in cases]
    batch = bounds(batch_sharding(mesh).region((8, 16), mesh.coordinate), (8, 16))
    return dict(rank=mesh.rank, coordinate=mesh.coordinate, axis_ranks={a: mesh.axis_ranks(a) for a in AXES},
                regions=regions, batch=batch, hosts=mesh.num_hosts)


def mesh_refusals(rank):
    """What make_mesh says to a mesh the job cannot hold, and to nccl on the CPU."""
    from hivemind_tpu_torch.parallel import make_mesh

    said = {}
    for label, kwargs in (("too many ranks", dict(dp=4, tp=1, sp=2, backend="gloo", device="cpu")),
                          ("nccl on the cpu", dict(dp=2, backend="nccl", device="cpu"))):
        try:
            make_mesh(**kwargs)
            said[label] = None
        except ValueError as e:
            said[label] = str(e)
    return said


def ring_shift_exact(rank, shape):
    """Each rank's block, rotated one step each way along sp, in bf16 and fp32:
    returns what arrived (the neighbors' bytes)."""
    import torch

    mesh = _mesh(shape)
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        mine = (torch.arange(24, dtype=torch.float32) / 7 + rank).to(dtype).reshape(2, 3, 4)
        other = -mine[0]
        forward = mesh.ring_shift([mine, other], "sp", 1)
        backward = mesh.ring_shift([mine, other], "sp", -1)
        got[str(dtype)] = [t.float().numpy() for t in (*forward, *backward)]
    from hivemind_tpu_torch.parallel.mesh import Mesh

    staging = {f"{backend} {device}": Mesh(mesh.device_mesh, backend, torch.device(device), 1).stages_through_host
               for backend in ("gloo", "nccl") for device in ("cpu", "cuda:0")}
    return dict(coordinate=mesh.coordinate, got=got, staging=staging)


def ring_attention_shards(rank, shape, q, k, v, cotangent, causal, dtype_name, flash):
    """The rank's shard of ring attention (the einsum ring, or the kernel ring run on
    its plain version) on the sp-sharded q, k, v, and its shards of the gradients of
    sum(out * cotangent)."""
    import torch

    from hivemind_tpu_torch.ops import flash_attention
    from hivemind_tpu_torch.parallel.mesh import NamedSharding, P
    from hivemind_tpu_torch.parallel.ring_attention import ring_attention, ring_flash_attention

    mesh = _mesh(shape)
    sharding = NamedSharding(mesh, P(None, "sp"))
    dtype = getattr(torch, dtype_name)
    inputs = [sharding.shard(torch.from_numpy(x)).to(dtype).clone().requires_grad_() for x in (q, k, v)]
    core = ring_flash_attention if flash else ring_attention
    before = flash_attention.flash_attention_lse.launches
    out = core(*inputs, mesh, "sp", causal)
    (out.float() * sharding.shard(torch.from_numpy(cotangent))).sum().backward()
    return dict(coordinate=mesh.coordinate, out=out.float().detach().numpy(), dtype=str(out.dtype),
                grads=[t.grad.float().numpy() for t in inputs],
                launches=flash_attention.flash_attention_lse.launches - before)


# ---------------------------------------------------------------- ALBERT on a mesh


def albert_train_step(rank, shape, flax_params, batch, masked_loss_fraction, lr, seq):
    """One SGD step of tiny ALBERT (fp32) on the mesh from the given weights and global
    batch: the loss, and the whole updated parameters (flax layout, on rank 0) gathered
    through the bridge."""
    import torch

    from hivemind_tpu_torch.convert import from_flax_albert_params
    from hivemind_tpu_torch.models import AlbertConfig, make_train_step
    from hivemind_tpu_torch.parallel import shard_batch, shard_state_dict

    mesh = _mesh(shape)
    config = AlbertConfig.tiny(dtype=torch.float32, max_position=seq, mesh=mesh)
    model, train_step = make_train_step(config, lambda p: torch.optim.SGD(p, lr=lr),
                                        masked_loss_fraction=masked_loss_fraction, device="cpu")
    model.load_state_dict(shard_state_dict(from_flax_albert_params(flax_params), mesh))
    loss = train_step(shard_batch({key: torch.from_numpy(value) for key, value in batch.items()}, mesh))
    return dict(loss=float(loss), **_gathered(model, mesh))


def causal_lm_train_step(rank, shape, flax_params, input_ids, lr):
    """One SGD step of the tiny causal LM (fp32) on the mesh from the given weights and
    global token batch: the loss, and the whole updated parameters (flax layout, on rank
    0) gathered through the bridge."""
    import torch

    from hivemind_tpu_torch.convert import from_flax_albert_params
    from hivemind_tpu_torch.models import CausalLMConfig, make_causal_train_step
    from hivemind_tpu_torch.parallel import shard_batch, shard_state_dict

    mesh = _mesh(shape)
    config = CausalLMConfig.tiny(dtype=torch.float32, mesh=mesh)
    model, train_step = make_causal_train_step(config, lambda p: torch.optim.SGD(p, lr=lr), device="cpu")
    model.load_state_dict(shard_state_dict(from_flax_albert_params(flax_params), mesh))
    loss = train_step(shard_batch({"input_ids": torch.from_numpy(input_ids)}, mesh))
    return dict(loss=float(loss), **_gathered(model, mesh))


def _gathered(model, mesh) -> dict:
    """The model's parameters gathered whole to rank 0 (flax paths; None elsewhere), and
    each local shard's shape."""
    from hivemind_tpu_torch.convert import flax_path
    from hivemind_tpu_torch.parallel import MeshTensorBridge, params_shardings

    named = dict(model.named_parameters())
    shardings = params_shardings(named, mesh)
    mirrors = MeshTensorBridge(mesh).gather_to_host(list(named.values()), list(shardings.values()))
    local_shapes = {name: tuple(p.shape) for name, p in named.items()}
    whole = None if mirrors is None else {"/".join(flax_path(name, p.ndim)[0]): m for (name, p), m in
                                          zip(named.items(), mirrors)}
    return dict(params=whole, local_shapes=local_shapes)


# ---------------------------------------------------------------- the bridge


def bridge_round_trip(rank, shape, cases):
    """Each case ``(whole flax-layout array, spec, transposed)``: this rank's shard
    gathered to rank 0's mirror and scattered back; counts the regions rank 0 received."""
    import torch
    import torch.distributed as dist

    from hivemind_tpu_torch.parallel import MeshTensorBridge
    from hivemind_tpu_torch.parallel.mesh import NamedSharding

    mesh = _mesh(shape)
    bridge = MeshTensorBridge(mesh)
    shardings = [NamedSharding(mesh, spec, transposed) for _, spec, transposed in cases]
    leaves = [s.shard(torch.from_numpy(whole.T if s.transposed else whole)).contiguous().clone()
              for (whole, _, _), s in zip(cases, shardings)]
    received, recv = [], dist.recv

    def counting_recv(tensor, src=None, *args, **kwargs):
        received.append(src)
        return recv(tensor, src, *args, **kwargs)

    dist.recv = counting_recv
    try:
        mirrors = bridge.gather_to_host(leaves, shardings)
    finally:
        dist.recv = recv
    back = bridge.scatter_from_host(leaves, mirrors, shardings)
    return dict(coordinate=mesh.coordinate, mirrors=mirrors, received_from=received,
                round_trip=all(torch.equal(a, b) for a, b in zip(leaves, back)),
                regions_sent=sum(1 for s, whole in zip(shardings, cases)
                                 for owner, _ in s.owners(whole[0].shape) if owner == mesh.rank and owner != 0))


def bridge_mesh_mean(rank, shape, per_rank, axis):
    """mesh_mean over ``axis`` of this rank's own values (``per_rank[rank]``), and the
    streamed mean gathered to rank 0."""
    import torch

    from hivemind_tpu_torch.parallel import MeshTensorBridge

    mesh = _mesh(shape)
    bridge = MeshTensorBridge(mesh)
    mine = [torch.from_numpy(x) for x in per_rank[rank]]
    mean = bridge.mesh_mean(mine, axis)
    gathered = bridge.gather_reduced_to_host(mine, reduce_axis=axis)
    return dict(coordinate=mesh.coordinate, mean=[t.numpy() for t in mean], gathered=gathered)


def mesh_averager_round(rank, values, initial_peers, prefix):
    """A one-rank mesh joins the swarm through MeshAverager (lossless wire) and averages
    ``values`` with a group of two; returns its tensors after the round."""
    import torch

    from hivemind_tpu_torch.averaging import MeshAverager
    from hivemind_tpu_torch.compression import NoCompression
    from hivemind_tpu_torch.dht import DHT

    mesh = _mesh((1, 1, 1))
    tensors = [torch.from_numpy(v.copy()) for v in values]
    dht = DHT(initial_peers=initial_peers, start=True)
    averager = MeshAverager(tensors, mesh, dht, prefix=prefix, target_group_size=2, min_group_size=2,
                            min_matchmaking_time=2.0, compression=NoCompression(), start=True)
    try:
        ok = averager.step(timeout=40) is not None
        return dict(ok=ok, tensors=[t.numpy().copy() for t in averager.device_tensors], bandwidth=averager.bandwidth)
    finally:
        averager.shutdown()
        dht.shutdown()


# ---------------------------------------------------------------- the slice


def slice_averager_round(rank, shape, per_rank, specs, initial_peers, prefix):
    """A slice (``local_reduce_axis="dp"``, tensor-parallel leaves by ``specs``) averages
    its replicas' mean with the swarm; returns each rank's tensors after the round."""
    import torch

    from hivemind_tpu_torch.averaging import SliceAverager
    from hivemind_tpu_torch.compression import NoCompression
    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.parallel.mesh import NamedSharding

    mesh = _mesh(shape)
    shardings = [NamedSharding(mesh, spec) for spec in specs]
    tensors = [s.shard(torch.from_numpy(x)).contiguous().clone() for s, x in zip(shardings, per_rank[mesh.coordinate["dp"]])]
    built = []

    def dht_factory():
        built.append(DHT(initial_peers=initial_peers, start=True))
        return built[-1]

    averager = SliceAverager(tensors, mesh, dht_factory, shardings=shardings, local_reduce_axis="dp", prefix=prefix,
                             target_group_size=2, min_group_size=2, min_matchmaking_time=2.0,
                             compression=NoCompression(), start=True)
    try:
        ok = averager.step(timeout=40)
        return dict(ok=ok, coordinate=mesh.coordinate, tensors=[t.numpy().copy() for t in averager.tensors],
                    dht_built=len(built), bandwidth=None if averager.averager is None else averager.averager.bandwidth)
    finally:
        averager.shutdown()


def _slice_model(mesh, flax_params, seq):
    import torch

    from hivemind_tpu_torch.convert import from_flax_albert_params
    from hivemind_tpu_torch.models import AlbertConfig, AlbertForMaskedLM
    from hivemind_tpu_torch.parallel import shard_state_dict

    config = AlbertConfig.tiny(dtype=torch.float32, max_position=seq, mesh=mesh)
    model = AlbertForMaskedLM(config)
    model.load_state_dict(shard_state_dict(from_flax_albert_params(flax_params), mesh))
    return config, model


def slice_optimizer_training(rank, shape, flax_params, batches, initial_peers, options, epochs, lamb):
    """A port slice trains tiny ALBERT (fp32) with LAMB through SliceOptimizer until
    ``epochs``, one global batch of ``batches`` a step; returns the (epoch, index) of
    every batch it accumulated, its state view and its optimizer's counts."""
    import torch

    from hivemind_tpu_torch.compression import NoCompression
    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.models import make_mlm_loss_fn
    from hivemind_tpu_torch.moe.server.layers import lamb_with_warmup
    from hivemind_tpu_torch.optim import SliceOptimizer, transforms
    from hivemind_tpu_torch.parallel import shard_batch

    mesh = _mesh(shape)
    seq = batches[0]["input_ids"].shape[1]
    _, model = _slice_model(mesh, flax_params, seq)
    loss_fn = make_mlm_loss_fn(model)
    opt = SliceOptimizer(mesh=mesh, params=model.named_parameters(), optimizer=lamb_with_warmup(*lamb),
                         dht_factory=lambda: DHT(initial_peers=initial_peers, start=True),
                         grad_compression=NoCompression(), state_averaging_compression=NoCompression(), **options)
    accumulated = []
    try:
        for index, batch in enumerate(batches):
            if opt.local_epoch >= epochs:
                break
            accumulated.append((opt.local_epoch, index))
            loss_fn(shard_batch({key: torch.from_numpy(value) for key, value in batch.items()}, mesh)).backward()
            opt.step(batch_size=batch["input_ids"].shape[0])
            opt.zero_grad()
            time.sleep(0.2)
        counts = [int(leaf) for leaf in transforms.tree_leaves(opt.opt_state) if not leaf.dtype.is_floating_point]
        return dict(epoch=opt.local_epoch, accumulated=accumulated, state=opt.state_dict(), counts=counts,
                    peers=None if opt.tracker is None else opt.tracker.global_progress.num_peers)
    finally:
        opt.shutdown()


def slice_optimizer_checkpoint(rank, shape, flax_params, batch, checkpoint, seq, lamb):
    """A solo slice: with ``checkpoint`` None, trains two epochs on ``batch`` and returns
    its state_dict; else loads ``checkpoint`` and returns its state view and counts."""
    import torch

    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.models import make_mlm_loss_fn
    from hivemind_tpu_torch.moe.server.layers import lamb_with_warmup
    from hivemind_tpu_torch.optim import SliceOptimizer, transforms
    from hivemind_tpu_torch.parallel import shard_batch

    mesh = _mesh(shape)
    _, model = _slice_model(mesh, flax_params, seq)
    opt = SliceOptimizer(mesh=mesh, params=model.named_parameters(), optimizer=lamb_with_warmup(*lamb),
                         dht_factory=lambda: DHT(start=True), run_id=f"ckpt_{rank}_{time.monotonic_ns()}",
                         target_batch_size=10 ** 9, batch_size_per_step=batch["input_ids"].shape[0])
    try:
        if checkpoint is None:
            loss_fn = make_mlm_loss_fn(model)
            for _ in range(2):
                loss_fn(shard_batch({key: torch.from_numpy(value) for key, value in batch.items()}, mesh)).backward()
                opt.step()
                opt.zero_grad()
                opt.force_epoch_transition()
        else:
            opt.load_state_dict(checkpoint)
        counts = [int(leaf) for leaf in transforms.tree_leaves(opt.opt_state) if not leaf.dtype.is_floating_point]
        return dict(state=opt.state_dict(), counts=counts)
    finally:
        opt.shutdown()


def slice_network_failure(rank, shape, seq):
    """A healthy step, then rank 0's tracker fails: returns what each rank raised."""
    import torch

    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.optim import SliceOptimizer, transforms

    mesh = _mesh(shape)
    params = {"w": torch.ones(8, 4, requires_grad=True)}
    opt = SliceOptimizer(mesh=mesh, params=params, optimizer=transforms.sgd(0.1), dht_factory=lambda: DHT(start=True),
                         run_id=f"sentinel_{time.monotonic_ns()}", target_batch_size=64, batch_size_per_step=4,
                         max_broadcast_skip=0)
    try:
        grads = {"w": torch.ones(8, 4)}
        opt.step(grads, batch_size=4)
        if opt.tracker is not None:
            def boom(*args, **kwargs):
                raise OSError("injected: dht store failed")

            opt.tracker.report_local_progress = boom
        try:
            opt.step(grads, batch_size=4)
            return dict(raised=None)
        except Exception as e:
            return dict(raised=type(e).__name__, message=str(e))
    finally:
        opt.shutdown()


def slice_thinning(rank, shape, steps):
    """A solo slice (SGD on one leaf, a far target) steps ``steps`` times with broadcast
    thinning on, then forces one transition: returns how many steps skipped the decision
    broadcast on this rank, and the epoch and parameters after."""
    import torch

    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.optim import SliceOptimizer, transforms
    from hivemind_tpu_torch.optim.slice_optimizer import _C_SKIPPED_STEPS

    mesh = _mesh(shape)
    params = {"w": torch.zeros(8, 4)}
    opt = SliceOptimizer(mesh=mesh, params=params, optimizer=transforms.sgd(0.5), dht_factory=lambda: DHT(start=True),
                         run_id=f"thin_{time.monotonic_ns()}", target_batch_size=10**6, batch_size_per_step=2,
                         matchmaking_time=0.1, max_broadcast_skip=8)
    try:
        before = _C_SKIPPED_STEPS.value
        for _ in range(steps):
            opt.step({"w": torch.full((8, 4), float(rank + 1))}, batch_size=2)
            time.sleep(0.01)
        skipped = _C_SKIPPED_STEPS.value - before
        opt.force_epoch_transition()
        return dict(skipped=skipped, epoch=opt.local_epoch, w=params["w"].numpy().copy())
    finally:
        opt.shutdown()


def slice_catch_up(rank, shape, flax_params, initial_peers, run_id, seq, lamb):
    """A fresh slice joins ``run_id`` and downloads the swarm's state collectively:
    returns whether it adopted one, its state view, counts and epoch, and this rank's own
    model parameters (its shards)."""
    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.moe.server.layers import lamb_with_warmup
    from hivemind_tpu_torch.optim import SliceOptimizer, transforms

    mesh = _mesh(shape)
    _, model = _slice_model(mesh, flax_params, seq)
    opt = SliceOptimizer(mesh=mesh, params=model.named_parameters(), optimizer=lamb_with_warmup(*lamb),
                         dht_factory=lambda: DHT(initial_peers=initial_peers, start=True), run_id=run_id,
                         target_batch_size=10**9, batch_size_per_step=4, load_state_timeout=30.0)
    try:
        ok = opt.load_state_from_peers()
        counts = [int(leaf) for leaf in transforms.tree_leaves(opt.opt_state) if not leaf.dtype.is_floating_point]
        return dict(ok=ok, state=opt.state_dict(), counts=counts, epoch=opt.local_epoch, coordinate=mesh.coordinate,
                    params={name: p.detach().numpy().copy() for name, p in model.named_parameters()})
    finally:
        opt.shutdown()
