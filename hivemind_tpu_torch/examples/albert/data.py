"""MLM batches for the collaborative ALBERT recipe (the port of
examples/albert/data.py, without its HuggingFace tier, which loads a tokenizer and a
dataset from disk).

:class:`TextMLMDataset` builds a frequency vocabulary from a local text corpus, encodes
it into one token stream, and samples BERT-style masked-LM batches (15% selection,
80/10/10 mask/random/keep) with a numpy ``RandomState``, as the JAX example does: the
same corpus, vocabulary and seed give the same batches in both packages. Every peer
trains ONE shared model, so all peers must share one token mapping: train from the
same corpus file or pass ``vocab_path`` (written by the first peer, loaded by the rest).
Without a corpus, the batches are synthetic, drawn on the device from a
``torch.Generator``.

A batch is ``{"input_ids", "labels", "mlm_mask"}`` of shape [batch, seq_len], as
``hivemind_tpu_torch.models.make_synthetic_mlm_batch`` makes it."""

from __future__ import annotations

import collections
import os
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

PAD, CLS, SEP, MASK, UNK = 0, 1, 2, 3, 4
NUM_SPECIAL = 5
_TOKEN_RE = re.compile(r"[\w']+|[^\w\s]")


def _apply_mlm_mask(labels: np.ndarray, selected: np.ndarray, rng: np.random.RandomState, mask_id: int,
                    vocab_size: int) -> np.ndarray:
    """BERT 80/10/10: of the selected positions, 80% -> [MASK], 10% -> random token,
    10% -> unchanged; the loss is taken on ALL selected positions."""
    roll = rng.rand(*labels.shape)
    input_ids = labels.copy()
    input_ids[selected & (roll < 0.8)] = mask_id
    random_positions = selected & (roll >= 0.8) & (roll < 0.9)
    input_ids[random_positions] = rng.randint(NUM_SPECIAL, vocab_size, size=int(random_positions.sum()))
    return input_ids


class TextMLMDataset:
    """Masked-LM batches from a local text file. See module docstring."""

    def __init__(self, path: str, vocab_size: int, seq_len: int, mask_prob: float = 0.15,
                 vocab_path: Optional[str] = None):
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            text = f.read()
        words = _TOKEN_RE.findall(text.lower())
        if not words:
            raise ValueError(f"corpus {path!r} contains no tokens")
        if vocab_path is not None and os.path.exists(vocab_path):
            with open(vocab_path, "r", encoding="utf-8") as f:
                word_list = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        else:
            counts = collections.Counter(words)
            word_list = [w for w, _ in counts.most_common(vocab_size - NUM_SPECIAL)]
            if vocab_path is not None:
                with open(vocab_path, "w", encoding="utf-8") as f:
                    f.write("\n".join(word_list) + "\n")
        self.vocab = {w: i + NUM_SPECIAL for i, w in enumerate(word_list[: vocab_size - NUM_SPECIAL])}
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.mask_prob = mask_prob
        self.stream = np.array([self.vocab.get(w, UNK) for w in words], dtype=np.int32)
        if len(self.stream) < seq_len:
            self.stream = np.tile(self.stream, seq_len // len(self.stream) + 1)

    def sample_batch(self, rng: np.random.RandomState, batch_size: int) -> Dict[str, np.ndarray]:
        starts = rng.randint(0, len(self.stream) - self.seq_len + 1, size=batch_size)
        labels = np.stack([self.stream[s : s + self.seq_len] for s in starts])
        selected = rng.rand(batch_size, self.seq_len) < self.mask_prob
        input_ids = _apply_mlm_mask(labels, selected, rng, MASK, self.vocab_size)
        return {"input_ids": input_ids, "labels": labels, "mlm_mask": selected}


def make_batch_sampler(config, seq_len: int, dataset_path: Optional[str] = None, vocab_path: Optional[str] = None,
                       seed: int = 0, device="cuda") -> Callable[[int], Dict[str, torch.Tensor]]:
    """The trainer's data entry point: ``sample(batch_size)`` gives a batch of tensors on
    ``device``, from the corpus when one is given, synthetic otherwise."""
    if dataset_path is not None:
        dataset = TextMLMDataset(dataset_path, config.vocab_size, seq_len, vocab_path=vocab_path)
        rng = np.random.RandomState(seed)

        def from_corpus(batch_size: int) -> Dict[str, torch.Tensor]:
            batch = dataset.sample_batch(rng, batch_size)
            return {key: torch.from_numpy(np.ascontiguousarray(value)).to(device) for key, value in batch.items()}

        return from_corpus

    from hivemind_tpu_torch.models import make_synthetic_mlm_batch

    generator = torch.Generator(device=device).manual_seed(seed)
    return lambda batch_size: make_synthetic_mlm_batch(generator, config, batch_size, seq_len)
