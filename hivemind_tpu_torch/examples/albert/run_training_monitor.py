"""Training monitor: join the swarm as a non-training observer and report global
progress (the port of examples/albert/run_training_monitor.py; upstream:
examples/albert/run_training_monitor.py). It reads the progress records of port and
JAX peers alike.

    python -m hivemind_tpu_torch.examples.albert.run_training_monitor --initial_peers <maddr>"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_id", default="albert_demo")
    parser.add_argument("--initial_peers", nargs="*", required=True)
    parser.add_argument("--refresh_period", type=float, default=5.0)
    parser.add_argument("--max_reports", type=int, default=0,
                        help="exit after this many progress reports (0 = run forever)")
    parser.add_argument("--metrics_jsonl", default=None,
                        help="append each report as a JSON line (an offline wandb-style sink)")
    args = parser.parse_args(argv)

    from hivemind_tpu_torch.dht import DHT, Ed25519SignatureValidator
    from hivemind_tpu_torch.optim.progress_tracker import LocalTrainingProgress
    from hivemind_tpu_torch.utils.logging import get_logger
    from hivemind_tpu_torch.utils.profiling import JsonlMetricsSink
    from hivemind_tpu_torch.utils.timed_storage import get_dht_time

    logger = get_logger("monitor")
    metrics_sink = JsonlMetricsSink(args.metrics_jsonl)
    # progress records are signature-protected: without this validator their
    # signatures are never stripped and the records fail to deserialize
    dht = DHT(initial_peers=args.initial_peers, start=True, record_validators=[Ed25519SignatureValidator()])
    progress_key = f"{args.run_id}_progress"

    reports, reported = 0, []
    while True:
        time.sleep(args.refresh_period)
        result = dht.get(progress_key, latest=True)
        if result is None or not isinstance(result.value, dict):
            logger.info("no training peers visible yet")
            continue
        records = []
        for entry in result.value.values():
            try:
                records.append(LocalTrainingProgress.model_validate(entry.value))
            except Exception:
                continue
        if not records:
            continue
        epoch = max(r.epoch for r in records)
        samples = sum(r.samples_accumulated for r in records if r.epoch == epoch)
        sps = sum(r.samples_per_second for r in records if r.epoch == epoch)
        logger.info(f"epoch {epoch}: {len(records)} peers, {samples} samples accumulated, {sps:.0f} samples/s aggregate")
        metrics = {"epoch": epoch, "num_peers": len(records), "samples_accumulated": samples,
                   "samples_per_second": sps, "time": get_dht_time()}
        metrics_sink.log(metrics)
        reported.append(metrics)
        reports += 1
        if args.max_reports and reports >= args.max_reports:
            break

    metrics_sink.close()
    dht.shutdown()
    return reported


if __name__ == "__main__":
    main()
