"""Local-SGD training on a mesh of ranks that is ONE swarm peer (the port of
examples/slice_training.py): every rank runs the same ALBERT train step on the mesh —
data, tensor and sequence parallel, gradients reduced over the data axes as in any SPMD
program — and every ``--steps_per_round`` steps the slice averages its parameters with
the rest of the swarm (other slices, single-card peers) through ``SliceAverager``:
rank 0 alone talks to the DHT, matchmaking and the all-reduce, the other ranks join only
the mesh's collectives.

One process per rank, e.g. a mesh of 2 ranks sharing one card over gloo:

    for rank in 0 1; do
        python -m hivemind_tpu_torch.examples.slice_training --sp 2 \\
            --rank $rank --world_size 2 --init_method tcp://localhost:29511 &
    done

``--nproc N`` spawns the N ranks of one host itself; ``--backend nccl`` where each rank
owns a card; ``--device cpu`` rehearses on the host. Rank 0 prints its DHT address."""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_id", default="slice_demo")
    parser.add_argument("--initial_peers", nargs="*", default=[], help="swarm bootstrap (used by rank 0 only)")
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--sp", type=int, default=1)
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world_size", type=int, default=None, help="default: dp * tp * sp")
    parser.add_argument("--init_method", default="tcp://localhost:29511")
    parser.add_argument("--nproc", type=int, default=0, help=">0: spawn this many local ranks")
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    parser.add_argument("--device", default="cuda", help="cuda (default; refuses to run without a card) or cpu")
    parser.add_argument("--tiny", action="store_true", help="albert-tiny config (CPU-friendly)")
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--steps_per_round", type=int, default=20)
    parser.add_argument("--batch_size", type=int, default=32, help="the slice's global samples per step")
    parser.add_argument("--seq_len", type=int, default=512)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--target_group_size", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0, help="weights and data (the same on every rank)")
    return parser.parse_args(argv)


def run(rank: int, args) -> None:
    import torch

    from hivemind_tpu_torch.averaging import SliceAverager
    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.models import AlbertConfig, make_synthetic_mlm_batch, make_train_step
    from hivemind_tpu_torch.parallel import make_mesh, params_shardings, shard_batch
    from hivemind_tpu_torch.utils.logging import get_logger

    logger = get_logger(f"slice_trainer.r{rank}")
    mesh = make_mesh(args.dp, args.tp, args.sp, backend=args.backend, device=args.device, init_method=args.init_method,
                     rank=rank, world_size=args.world_size or args.dp * args.tp * args.sp)
    logger.info(f"{mesh}: rank {rank} at {mesh.coordinate}")
    make_config = AlbertConfig.tiny if args.tiny else AlbertConfig.base
    config = make_config(max_position=args.seq_len, mesh=mesh)
    model, train_step = make_train_step(config, lambda p: torch.optim.AdamW(p, lr=args.learning_rate, weight_decay=1e-4),
                                        masked_loss_fraction=0.25, device=mesh.device.type, rng_seed=args.seed)

    def dht_factory():
        dht = DHT(initial_peers=args.initial_peers, start=True)
        for maddr in dht.get_visible_maddrs():
            logger.info(f"swarm members can join via: --initial_peers {maddr}")
        return dht

    named = dict(model.named_parameters())
    averager = SliceAverager([p.data for p in named.values()], mesh, dht_factory,
                             shardings=list(params_shardings(named, mesh).values()),
                             prefix=f"{args.run_id}_params", target_group_size=args.target_group_size, start=True)
    try:
        for step in range(1, args.steps + 1):
            generator = torch.Generator(device=mesh.device).manual_seed(args.seed * 1_000_003 + step)
            loss = train_step(shard_batch(make_synthetic_mlm_batch(generator, config, args.batch_size, args.seq_len), mesh))
            if step % args.steps_per_round == 0:
                averaged = averager.step(timeout=60)
                logger.info(f"step {step}: loss {loss.item():.5f}, swarm round {'ok' if averaged else 'skipped'}")
    finally:
        averager.shutdown()
    logger.info(f"done: {args.steps} steps")


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
