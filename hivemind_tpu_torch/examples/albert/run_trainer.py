"""Collaborative ALBERT pretraining peer (the port of examples/albert/run_trainer.py;
upstream: examples/albert/run_trainer.py): every peer runs this module, joins the swarm
through the DHT, and trains one shared ALBERT with the collaborative Optimizer and LAMB;
peers may come and go at any time. JAX peers running the JAX example with the same
``--run_id`` and widths train the same model. ``--model causal`` trains the decoder-only
causal LM (``models/causal_lm.py``) instead, on the sampler's unmasked token stream.

    python -m hivemind_tpu_torch.examples.albert.run_trainer --initial_peers <maddr> ...

Data: ``--dataset_path corpus.txt`` trains on a local corpus (see ``data.py``); without
it, synthetic MLM batches keep the recipe runnable anywhere. ``--device`` defaults to
``cuda`` and refuses to run without a card; ``--device cpu`` runs the plain path. The
optimizer state is averaged losslessly (``NoCompression``, upstream's default), not over
the Optimizer's default fp16 state wire, which the JAX example keeps."""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_id", default="albert_demo")
    parser.add_argument("--model", choices=("albert", "causal"), default="albert",
                        help="albert: the masked-LM flagship; causal: decoder-only next-token pretraining "
                             "(models/causal_lm.py)")
    parser.add_argument("--initial_peers", nargs="*", default=[])
    parser.add_argument("--target_batch_size", type=int, default=4096)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--warmup_epochs", type=int, default=100)
    parser.add_argument("--total_epochs", type=int, default=10_000)
    parser.add_argument("--matchmaking_time", type=float, default=3.0)
    parser.add_argument("--max_steps", type=int, default=10**9)
    parser.add_argument("--client_mode", action="store_true")
    parser.add_argument("--tiny", action="store_true", help="the model's tiny config (CPU-friendly)")
    parser.add_argument("--powersgd_rank", type=int, default=0, help=">0: PowerSGD gradient compression")
    parser.add_argument("--dataset_path", default=None, help="local text corpus")
    parser.add_argument("--vocab_path", default=None,
                        help="shared vocab file for text corpora: ALL peers must use the same token "
                             "mapping (first peer writes it, the rest load it)")
    parser.add_argument("--seed", type=int, default=None, help="data sampling seed (default: random per peer)")
    parser.add_argument("--backup_every", type=int, default=30,
                        help="healthy steps between in-memory state backups for NaN-restore (0 disables the guard)")
    parser.add_argument("--metrics_jsonl", default=None,
                        help="append per-report metrics as JSON lines (wandb-style key/value records)")
    parser.add_argument("--device", default="cuda", help="cuda (default; refuses to run without a card) or cpu")
    args = parser.parse_args(argv)

    import torch

    from hivemind_tpu_torch.compression import NoCompression
    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.examples.albert.data import make_batch_sampler
    from hivemind_tpu_torch.models import (
        AlbertConfig,
        AlbertForMaskedLM,
        CausalLM,
        CausalLMConfig,
        causal_lm_loss,
        make_mlm_loss_fn,
    )
    from hivemind_tpu_torch.moe.server.layers import lamb_with_warmup
    from hivemind_tpu_torch.optim import NaNGuard, Optimizer, PowerSGDGradientAverager
    from hivemind_tpu_torch.utils.device import resolve_device
    from hivemind_tpu_torch.utils.logging import get_logger
    from hivemind_tpu_torch.utils.profiling import JsonlMetricsSink

    logger = get_logger("albert_trainer")
    device = resolve_device(args.device)

    config_cls, model_cls = (CausalLMConfig, CausalLM) if args.model == "causal" else (AlbertConfig, AlbertForMaskedLM)
    config = config_cls.tiny(max_position=args.seq_len) if args.tiny else config_cls.base(max_position=args.seq_len)
    model = model_cls(config, device=device)
    # every peer starts from the same weights: the swarm averages one model
    model.reset_parameters(torch.Generator(device=device).manual_seed(0))
    if args.model == "causal":
        # the sampler's "labels" field is the unmasked token stream: what next-token
        # prediction trains on
        loss_fn = lambda batch: causal_lm_loss(model(batch["labels"]), batch["labels"])
    else:
        # masked-only loss: a ~4x cheaper MLM head (the same objective at 15% masking)
        loss_fn = make_mlm_loss_fn(model, masked_loss_fraction=0.25)

    dht = DHT(initial_peers=args.initial_peers, start=True)
    for maddr in dht.get_visible_maddrs():
        logger.info(f"to join this training run: --initial_peers {maddr}")

    grad_averager_factory, grad_averager_opts = None, {}
    if args.powersgd_rank > 0:
        logger.info(f"using PowerSGD rank {args.powersgd_rank} gradient compression")
        grad_averager_factory = PowerSGDGradientAverager
        grad_averager_opts = {"averager_rank": args.powersgd_rank}
    # the ALBERT recipe trains with LAMB + linear warmup + clipping; schedules are
    # epoch-keyed (one update per virtual epoch)
    opt = Optimizer(
        dht=dht,
        run_id=args.run_id,
        target_batch_size=args.target_batch_size,
        params=model.named_parameters(),
        optimizer=lamb_with_warmup(args.learning_rate, args.warmup_epochs, args.total_epochs),
        batch_size_per_step=args.batch_size,
        matchmaking_time=args.matchmaking_time,
        client_mode=args.client_mode,
        grad_averager_factory=grad_averager_factory,
        grad_averager_opts=grad_averager_opts,
        # LAMB's second moments go over a lossless wire: the Optimizer's default fp16
        # state wire turns small ones negative, and the next update takes their root
        state_averaging_compression=NoCompression(),
        verbose=True,
    )
    sample_batch = make_batch_sampler(
        config, args.seq_len, dataset_path=args.dataset_path, vocab_path=args.vocab_path,
        seed=args.seed if args.seed is not None else int(time.time() * 1000) % 2**31, device=device,
    )
    guard = NaNGuard(opt, backup_every=args.backup_every) if args.backup_every > 0 else None
    metrics_sink = JsonlMetricsSink(args.metrics_jsonl)

    step, loss_ema = 0, None
    while step < args.max_steps:
        batch = sample_batch(args.batch_size)
        loss = loss_fn(batch)
        loss.backward()
        loss_value = float(loss.detach())
        if guard is not None:
            guard.step(loss_value)  # restores the backup on NaN/Inf
        else:
            opt.step()
        opt.zero_grad()
        if np.isfinite(loss_value):
            loss_ema = loss_value if loss_ema is None else 0.95 * loss_ema + 0.05 * loss_value
        step += 1
        if step % 10 == 0:
            progress = opt.tracker.global_progress
            ema_text = f"{loss_ema:.4f}" if loss_ema is not None else "n/a"
            logger.info(
                f"step {step} epoch {opt.local_epoch} loss {ema_text} "
                f"(swarm: {progress.num_peers} peers, {progress.samples_accumulated}/"
                f"{args.target_batch_size} samples)"
                + (f" [{guard.restores} NaN restores]" if guard is not None and guard.restores else "")
            )
            metrics_sink.log({
                "step": step, "epoch": opt.local_epoch, "loss": loss_value, "loss_ema": loss_ema,
                "num_peers": progress.num_peers, "samples_accumulated": progress.samples_accumulated,
                "time": time.time(),
            })

    # reached max_steps: leave the swarm cleanly so the process exits
    final_text = f"{loss_ema:.4f}" if loss_ema is not None else "n/a"
    logger.info(f"training finished after {step} steps at epoch {opt.local_epoch}, final loss {final_text}")
    metrics_sink.close()
    opt.shutdown()
    dht.shutdown()
    return opt


if __name__ == "__main__":
    main()
