"""Pipelined inference over the swarm (the port of examples/pipeline_inference.py, a
Petals-style demo). Serve a model's blocks on any mix of peers, then chain them
from a client, each block possibly on another machine, with DHT-based failover:

    # peer 1: host blocks 0 and 2 (prints the multiaddr to join)
    python -m hivemind_tpu_torch.examples.pipeline_inference --serve blk.0 blk.2

    # peer 2: host block 1
    python -m hivemind_tpu_torch.examples.pipeline_inference --serve blk.1 --initial_peers /ip4/…

    # anyone: run the pipeline
    python -m hivemind_tpu_torch.examples.pipeline_inference --num_blocks 3 --initial_peers /ip4/…

Servers run on the card unless ``--device cpu``; the client's embedding and head too.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--serve", nargs="*", default=None, help="block uids to host (server mode)")
    parser.add_argument("--expert_cls", default="transformer",
                        help="block class to serve; use causal_transformer or llama_block for --generate")
    parser.add_argument("--expert_kwargs", default=None,
                        help="JSON dict forwarded to the block class, e.g. '{\"num_kv_heads\": 2}' for GQA llama_block")
    parser.add_argument("--no_sessions", action="store_true",
                        help="decode by right-padded full recompute instead of KV-cache sessions")
    parser.add_argument("--generate", type=int, default=0,
                        help="greedy-decode this many tokens through the pipeline (causal blocks only)")
    parser.add_argument("--vocab_size", type=int, default=128)
    parser.add_argument("--prefix", default="blk.")
    parser.add_argument("--num_blocks", type=int, default=3)
    parser.add_argument("--hidden_dim", type=int, default=64)
    parser.add_argument("--seq_len", type=int, default=64)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--initial_peers", nargs="*", default=[])
    from hivemind_tpu_torch.utils.platform import add_device_arg, apply_device

    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = apply_device(args)

    import json
    import uuid

    import numpy as np
    import torch

    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.moe.client.remote_sequential import RemoteSequential
    from hivemind_tpu_torch.moe.server.server import Server
    from hivemind_tpu_torch.utils.logging import get_logger

    logger = get_logger("pipeline_demo")

    if args.serve:
        dht = DHT(initial_peers=args.initial_peers, start=True)
        for maddr in dht.get_visible_maddrs():
            logger.info(f"to join: --initial_peers {maddr}")
        server = Server.create(
            expert_uids=list(args.serve), expert_cls=args.expert_cls, hidden_dim=args.hidden_dim, dht=dht,
            expert_kwargs=json.loads(args.expert_kwargs) if args.expert_kwargs else None,
            optim_factory=lambda params: torch.optim.SGD(params, lr=1e-4), device=device, start=True,
        )
        logger.info(f"serving blocks {args.serve}; ctrl-c to stop")
        try:
            while True:
                time.sleep(5)
        except KeyboardInterrupt:
            server.shutdown()
            dht.shutdown()
        return None

    if not args.initial_peers:
        raise SystemExit("client mode needs --initial_peers of a serving swarm")
    dht = DHT(initial_peers=args.initial_peers, start=True)
    pipe = RemoteSequential(dht, args.prefix, args.num_blocks)

    if args.generate:
        # Petals-style decoding: the embedding and the tied LM head live on the client,
        # the block stack runs remotely. KV-cache sessions make every step O(context):
        # one prefill with the prompt, then one single-token chain per token
        # (--no_sessions recomputes the right-padded window, which causality makes exact)
        rng = np.random.RandomState(0)
        embedding = torch.as_tensor(rng.randn(args.vocab_size, args.hidden_dim) * 0.05, dtype=torch.float32,
                                    device=device)
        tokens = [1]  # BOS

        def embed(ids) -> torch.Tensor:
            return embedding[torch.as_tensor(ids, device=device)][None]

        def next_token(hidden_row) -> int:
            return int(torch.argmax(torch.as_tensor(hidden_row, dtype=torch.float32, device=device) @ embedding.T))

        started = time.perf_counter()
        if args.no_sessions:
            context = 64
            for _ in range(args.generate):
                window = tokens[-context:]
                hidden = pipe(embed(window + [0] * (context - len(window))))  # [1, 64, hid]
                tokens.append(next_token(hidden[0, len(window) - 1]))
        else:
            session = uuid.uuid4().hex
            out = pipe.decode_step(embed(tokens), session, reset=True)
            # re-prefill window when a session hits its capacity: half the advertised
            # per-session cache, so a restarted session has headroom
            capacity = pipe.decode_capacity() or 128
            window = max(1, min(64, capacity // 2))
            for remaining in range(args.generate, 0, -1):
                tokens.append(next_token(out[0, -1]))
                if remaining == 1:
                    break  # the last token needs no further step
                try:
                    out = pipe.decode_step(embed(tokens[-1:]), session)
                except Exception:
                    # session capacity (server --decode_max_len) reached: a fresh session
                    # prefilled with the recent window, the sliding context of --no_sessions
                    pipe.close_decode_session(session)
                    session = uuid.uuid4().hex
                    out = pipe.decode_step(embed(tokens[-window:]), session, reset=True)
        elapsed = time.perf_counter() - started
        mode = "right-padded recompute" if args.no_sessions else "KV-cache sessions"
        logger.info(f"generated {args.generate} tokens through {args.num_blocks} remote blocks in {elapsed:.2f}s "
                    f"({args.generate / elapsed:.1f} tok/s, {mode}, untrained weights): {tokens}")
        dht.shutdown()
        return tokens
    x = torch.as_tensor(np.random.RandomState(0).randn(args.batch_size, args.seq_len, args.hidden_dim),
                        dtype=torch.float32, device=device)
    started = time.perf_counter()
    out = pipe(x)
    elapsed = time.perf_counter() - started
    logger.info(f"pipeline of {args.num_blocks} remote blocks: {tuple(x.shape)} -> {tuple(out.shape)} in "
                f"{elapsed:.2f}s (|out| = {float(torch.linalg.norm(out)):.2f})")
    dht.shutdown()
    return out


if __name__ == "__main__":
    main()
