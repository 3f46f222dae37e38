"""Generate tokens from a Llama checkpoint served over the swarm (the port of
examples/llama_generate.py: BASELINE config #5 end to end, the Petals usage shape).

Servers: each hosts a range of the checkpoint's decoder layers (prints the
multiaddr to join); ``--mesh_devices N`` splits each block over N cards

    python -m hivemind_tpu_torch.examples.llama_generate --checkpoint /path/to/hf_llama \\
        --serve 0:16 --int8
    python -m hivemind_tpu_torch.examples.llama_generate --checkpoint /path/to/hf_llama \\
        --serve 16:32 --int8 --initial_peers /ip4/…

Client: keeps only the embedding, the final norm and the LM head

    python -m hivemind_tpu_torch.examples.llama_generate --checkpoint /path/to/hf_llama \\
        --generate 64 --prompt_ids 1 15043 3186 --initial_peers /ip4/…

Token ids in, token ids out. Everything runs on the card unless ``--device cpu``."""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True, help="HF-layout Llama directory")
    parser.add_argument("--serve", default=None, help="'start:stop' layer range to host (server mode); omit for client mode")
    parser.add_argument("--int8", action="store_true", help="serve int8 weight-only (4x less resident memory)")
    parser.add_argument("--mesh_devices", type=int, default=0, help="serve each block over this many local cards")
    parser.add_argument("--uid_prefix", default="llama.")
    parser.add_argument("--initial_peers", nargs="*", default=[])
    parser.add_argument("--generate", type=int, default=32)
    parser.add_argument("--prompt_ids", type=int, nargs="*", default=[1], help="prompt token ids (default: BOS only)")
    parser.add_argument("--decode_max_len", type=int, default=512)
    from hivemind_tpu_torch.utils.platform import add_device_arg, apply_device

    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = apply_device(args)

    import numpy as np

    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.moe.server.llama_loader import (
        LlamaCheckpointConfig,
        LlamaClientHead,
        generate_greedy,
        load_llama_blocks,
    )
    from hivemind_tpu_torch.utils.logging import get_logger

    logger = get_logger("llama_generate")
    config = LlamaCheckpointConfig.load(args.checkpoint)

    if args.serve is not None:
        from hivemind_tpu_torch.moe.server.mesh_backend import local_cards
        from hivemind_tpu_torch.moe.server.server import Server

        start, _, stop = args.serve.partition(":")
        layers = range(int(start or 0), int(stop or config.num_hidden_layers))
        backends, _config = load_llama_blocks(
            args.checkpoint, layers=layers, uid_prefix=args.uid_prefix, device=device,
            weight_quantization="int8" if args.int8 else None,
            mesh=local_cards(args.mesh_devices) if args.mesh_devices else None,
        )
        dht = DHT(initial_peers=args.initial_peers, start=True)
        server = Server(dht, backends, decode_max_len=args.decode_max_len)
        server.run_in_background(await_ready=True)
        for maddr in dht.get_visible_maddrs():
            logger.info(f"serving layers {layers.start}:{layers.stop}; join via --initial_peers {maddr}")
        try:
            while True:
                time.sleep(60)
        except KeyboardInterrupt:
            server.shutdown()
            dht.shutdown()
        return

    from hivemind_tpu_torch.moe.client.remote_sequential import RemoteSequential

    dht = DHT(initial_peers=args.initial_peers, start=True)
    head = LlamaClientHead.load(args.checkpoint, device=device)
    pipe = RemoteSequential(dht, args.uid_prefix, config.num_hidden_layers)
    prompt = np.asarray([args.prompt_ids], np.int64)
    logger.info(f"generating {args.generate} tokens through {config.num_hidden_layers} remote layers "
                f"(vocab {head.vocab_size})")
    started = time.perf_counter()
    ids = generate_greedy(head, pipe, prompt, args.generate)
    logger.info(f"{args.generate / (time.perf_counter() - started):.1f} tok/s")
    print(" ".join(str(t) for t in ids[0].tolist()))
    dht.shutdown()
    return ids


if __name__ == "__main__":
    main()
