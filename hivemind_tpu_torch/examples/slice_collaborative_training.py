"""Collaborative ALBERT pretraining on a mesh of ranks that is ONE swarm peer (the port
of examples/slice_collaborative_training.py): every rank runs this script, the mesh
trains ALBERT with data, tensor and sequence parallelism, and ``SliceOptimizer`` gives it
the whole collaborative ``Optimizer`` semantics — target_batch_size epochs, swarm
gradient averaging, the progress tracker, periodic state averaging and the state
download of late joiners — with rank 0 as its only network process. Host peers of the
port (``examples/albert/run_trainer.py``) or of the JAX package with the same
``--run_id`` and widths train the same model.

One process per rank, e.g. a mesh of 4 ranks sharing one card over gloo:

    for rank in 0 1 2 3; do
        python -m hivemind_tpu_torch.examples.slice_collaborative_training --dp 2 --sp 2 \\
            --rank $rank --world_size 4 --init_method tcp://localhost:29512 &
    done

``--nproc N`` spawns the N ranks of one host itself. ``--backend nccl`` where each rank
owns a card; ``--device cpu`` rehearses on the host. Rank 0 prints its DHT address."""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_id", default="slice_collab")
    parser.add_argument("--initial_peers", nargs="*", default=[], help="swarm bootstrap (used by rank 0 only)")
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--sp", type=int, default=1)
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world_size", type=int, default=None, help="default: dp * tp * sp")
    parser.add_argument("--init_method", default="tcp://localhost:29512")
    parser.add_argument("--nproc", type=int, default=0, help=">0: spawn this many local ranks")
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    parser.add_argument("--device", default="cuda", help="cuda (default; refuses to run without a card) or cpu")
    parser.add_argument("--tiny", action="store_true", help="albert-tiny config (CPU-friendly)")
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--target_batch_size", type=int, default=4096, help="GLOBAL samples per epoch, swarm-wide")
    parser.add_argument("--batch_size", type=int, default=32, help="the slice's global samples per step")
    parser.add_argument("--seq_len", type=int, default=512)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--warmup_epochs", type=int, default=100)
    parser.add_argument("--total_epochs", type=int, default=10_000)
    parser.add_argument("--matchmaking_time", type=float, default=3.0)
    parser.add_argument("--delay_grad_averaging", action="store_true",
                        help="overlap the swarm round with training; its update lands one epoch stale")
    parser.add_argument("--seed", type=int, default=0, help="weights and data (the same on every rank)")
    return parser.parse_args(argv)


def run(rank: int, args) -> int:
    import torch

    from hivemind_tpu_torch.compression import NoCompression
    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.models import AlbertConfig, AlbertForMaskedLM, make_mlm_loss_fn, make_synthetic_mlm_batch
    from hivemind_tpu_torch.moe.server.layers import lamb_with_warmup
    from hivemind_tpu_torch.optim import SliceOptimizer
    from hivemind_tpu_torch.parallel import make_mesh, shard_batch
    from hivemind_tpu_torch.utils.logging import get_logger

    logger = get_logger(f"slice_collab.r{rank}")
    mesh = make_mesh(args.dp, args.tp, args.sp, backend=args.backend, device=args.device, init_method=args.init_method,
                     rank=rank, world_size=args.world_size or args.dp * args.tp * args.sp)
    logger.info(f"{mesh}: rank {rank} at {mesh.coordinate}")
    make_config = AlbertConfig.tiny if args.tiny else AlbertConfig.base
    config = make_config(max_position=args.seq_len, mesh=mesh)
    model = AlbertForMaskedLM(config, device=mesh.device)
    model.reset_parameters(torch.Generator(device=mesh.device).manual_seed(args.seed))  # the same weights everywhere
    loss_fn = make_mlm_loss_fn(model, masked_loss_fraction=0.25)

    def dht_factory():
        dht = DHT(initial_peers=args.initial_peers, start=True)
        for maddr in dht.get_visible_maddrs():
            logger.info(f"swarm members can join via: --initial_peers {maddr}")
        return dht

    opt = SliceOptimizer(
        mesh=mesh, params=model.named_parameters(), dht_factory=dht_factory, run_id=args.run_id,
        optimizer=lamb_with_warmup(args.learning_rate, args.warmup_epochs, args.total_epochs),
        target_batch_size=args.target_batch_size, batch_size_per_step=args.batch_size,
        matchmaking_time=args.matchmaking_time, delay_grad_averaging=args.delay_grad_averaging,
        state_averaging_compression=NoCompression(), verbose=True,
    )
    try:
        for step in range(1, args.steps + 1):
            # every rank draws the same global batch and takes its [dp, sp] block
            generator = torch.Generator(device=mesh.device).manual_seed(args.seed * 1_000_003 + step)
            batch = make_synthetic_mlm_batch(generator, config, args.batch_size, args.seq_len)
            loss = loss_fn(shard_batch(batch, mesh))
            loss.backward()
            opt.step(batch_size=args.batch_size)
            opt.zero_grad()
            if step % 10 == 0:
                logger.info(f"step {step}: loss {loss.item():.5f}, epoch {opt.local_epoch}")
    finally:
        opt.shutdown()
    logger.info(f"done: epoch {opt.local_epoch}")
    return opt.local_epoch


def _spawned(rank: int, args) -> None:
    run(rank, args)


def main(argv=None):
    args = parse_args(argv)
    if args.nproc:
        import torch.multiprocessing

        args.world_size = args.nproc
        torch.multiprocessing.spawn(_spawned, args=(args,), nprocs=args.nproc)
    else:
        run(args.rank, args)


if __name__ == "__main__":
    main()
