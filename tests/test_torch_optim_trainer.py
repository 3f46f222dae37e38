"""The port's ALBERT recipe (``hivemind_tpu_torch.examples.albert``): its corpus
batches are the JAX example's for the same corpus, vocabulary and seed; the trainer
trains tiny ALBERT on the CPU through the collaborative Optimizer, and the monitor
reads its progress from the DHT."""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading

import numpy as np
import pytest
import torch

from hivemind_tpu_torch.compression import NoCompression
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.examples.albert import data, run_trainer, run_training_monitor
from hivemind_tpu_torch.models import AlbertConfig

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "albert"))
import data as jax_data  # noqa: E402  (the JAX example's data module)


@contextlib.contextmanager
def deadline(seconds: float):
    """Fail the test (TimeoutError at the blocked call) after ``seconds`` of wall time."""

    def _expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s deadline")

    previous = signal.signal(signal.SIGALRM, _expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


CORPUS = ("The swarm trains one model. Peers come and go; the model stays. " * 20
          + "Volunteers share gradients, averaging them in groups! ") * 3


def test_corpus_batches_are_the_jax_examples(tmp_path):
    """The same corpus, vocabulary file and seed: the same vocabulary, token stream and
    masked batches, and the sampler's tensors carry them to the device unchanged."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(CORPUS)
    ours = data.TextMLMDataset(str(corpus), vocab_size=64, seq_len=16, vocab_path=str(tmp_path / "vocab.txt"))
    theirs = jax_data.TextMLMDataset(str(corpus), vocab_size=64, seq_len=16, vocab_path=str(tmp_path / "vocab.txt"))
    assert ours.vocab == theirs.vocab and np.array_equal(ours.stream, theirs.stream)
    for seed in (0, 7):
        mine, reference = (dataset.sample_batch(np.random.RandomState(seed), 5) for dataset in (ours, theirs))
        assert all(np.array_equal(mine[key], reference[key]) for key in reference)
    sample = data.make_batch_sampler(AlbertConfig.tiny(vocab_size=64), 16, dataset_path=str(corpus),
                                     vocab_path=str(tmp_path / "vocab.txt"), seed=3, device="cpu")
    batch, reference = sample(4), theirs.sample_batch(np.random.RandomState(3), 4)
    assert all(torch.equal(batch[key], torch.from_numpy(reference[key])) for key in reference)
    synthetic = data.make_batch_sampler(AlbertConfig.tiny(), 32, seed=3, device="cpu")(2)
    assert synthetic["input_ids"].shape == (2, 32) and synthetic["mlm_mask"].dtype == torch.bool


def test_trainer_and_monitor_run_on_the_cpu():
    """A tiny-ALBERT trainer on the CPU (its own epochs: a swarm of one) passes epoch 2
    with a finite loss and averages its state losslessly; a monitor joined through the
    DHT reports its progress record."""
    bootstrap = DHT(start=True)
    peers = [str(m) for m in bootstrap.get_visible_maddrs()]
    finished = {}

    def train():
        finished["opt"] = run_trainer.main([
            "--tiny", "--device", "cpu", "--run_id", "albert_cpu", "--initial_peers", *peers, "--max_steps", "30",
            "--target_batch_size", "8", "--batch_size", "4", "--seq_len", "32", "--seed", "1", "--warmup_epochs", "2",
            "--matchmaking_time", "1.0"])

    thread = threading.Thread(target=train)
    try:
        with deadline(120):
            thread.start()
            reports = run_training_monitor.main(["--run_id", "albert_cpu", "--initial_peers", *peers,
                                                 "--refresh_period", "0.5", "--max_reports", "1"])
            thread.join(100)
        assert not thread.is_alive()
        opt = finished["opt"]
        assert opt.local_epoch >= 2
        assert all(torch.isfinite(p).all() for p in opt.params.values())
        # LAMB's state goes over a lossless wire (an fp16 one turns small second moments negative)
        assert isinstance(opt.state_averager.compression, NoCompression)
        assert isinstance(opt.state_averager.state_compression, NoCompression)
        assert reports and reports[0]["num_peers"] == 1
    finally:
        bootstrap.shutdown()


@pytest.mark.parametrize("flag", ["--model", "--hf_tokenizer", "--platform"])
def test_trainer_leaves_out_the_flags_of_later_slices(flag):
    with pytest.raises(SystemExit):
        run_trainer.main(["--device", "cpu", flag, "x"])
