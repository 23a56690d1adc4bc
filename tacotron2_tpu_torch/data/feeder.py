"""Tacotron input pipeline: train.txt -> padded numpy batches.

Counterpart of tacotron2_tpu/data/feeder.py `TacotronFeeder` on its numpy
path (the JAX package's native loader falls back to `np.load`,
:149-153; the port has no native loader) for the default feeder options:

- the train/test split of sklearn's `train_test_split` (seed
  `tacotron_data_random_state`, test size `tacotron_test_size`), the test
  split rounded down to a batch multiple with the rest returned to train
  (feeder.py:90-101), computed here as sklearn computes it (a
  RandomState permutation: test first), since the GPU machine has no
  sklearn;
- length-bucketed groups of `batches_per_group` batches, sorted by mel
  length, then shuffled by batch;
- padding: inputs 0, mel targets -max_abs_value, stop tokens 1, lengths
  rounded up to the reduction factor and to the pad multiples;
- reference mels: emt4/emth rows take a random same-emotion row's mel as
  the emotion reference and their own as the speaker reference; other
  rows a random same-speaker row's as the speaker reference and their own
  as the emotion reference;
- `prefetch`, a background thread.

The emt_only, intercross, unpaired and debug (test_inputs, test_max_len,
remove_long_samples) options are not ported.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config import Config
from ..text import text_to_sequence


def _round_up(x: int, m: int) -> int:
    return x if x % m == 0 else x + m - x % m


def _round_down(x: int, m: int) -> int:
    return x if x % m == 0 else x - x % m


def train_test_split_indices(n: int, test_size, batch_size: int,
                             random_state: int):
    """sklearn.model_selection.train_test_split(arange(n), test_size,
    random_state) — ShuffleSplit: n_test = ceil(test_size · n) for a
    fraction (the count itself for an int, 0.25 for None), a RandomState
    permutation, test = its first n_test, train the next n - n_test — then
    the test split rounded down to a batch multiple, the rest to train."""
    if test_size is None:
        test_size = 0.25
    n_test = (int(math.ceil(test_size * n)) if isinstance(test_size, float)
              else int(test_size))
    perm = np.random.RandomState(random_state).permutation(n)
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    keep = _round_down(len(test_idx), batch_size)
    return (np.concatenate([train_idx, test_idx[keep:]]), test_idx[:keep])


class TacotronFeeder:
    """Batched example stream for Tacotron training."""

    def __init__(self, cfg: Config, metadata_path: str, *,
                 batches_per_group: Optional[int] = None,
                 pad_text_multiple: int = 1, pad_mel_multiple: int = 1,
                 seed: Optional[int] = None):
        self.cfg = cfg
        self.data_folder = os.path.dirname(metadata_path)
        self.pad_text_multiple = pad_text_multiple
        self.pad_mel_multiple = pad_mel_multiple
        self.batches_per_group = batches_per_group or cfg.data.batches_per_group
        self.cleaners = cfg.data.cleaners
        self.rng = np.random.default_rng(
            seed if seed is not None else cfg.train.tacotron_data_random_state)
        with open(metadata_path, encoding="utf-8") as f:
            meta = [line.strip().split("|") for line in f if line.strip()]
        self.metadata = meta
        hop_s = cfg.audio.effective_hop / cfg.audio.sample_rate
        hours = sum(int(m[6]) for m in meta) * hop_s / 3600
        print(f"Loaded metadata for {len(meta)} examples ({hours:.2f} hours)")
        train_idx, test_idx = train_test_split_indices(
            len(meta), cfg.train.tacotron_test_size,
            cfg.train.tacotron_batch_size,
            cfg.train.tacotron_data_random_state)
        self.train_meta = [meta[i] for i in train_idx]
        self.test_meta = [meta[i] for i in test_idx]
        self._train_offset = 0
        self._target_pad = (-cfg.audio.max_abs_value
                            if cfg.audio.symmetric_mels else 0.0)

    # ------------------------------------------------------------- examples

    def _load_mel(self, row) -> np.ndarray:
        return np.load(os.path.join(self.data_folder, row[0], "mels", row[2]))

    def _random_row_where(self, rows: List, pred) -> Optional[List]:
        cands = [m for m in rows if pred(m)]
        if not cands:
            return None
        return cands[int(self.rng.integers(len(cands)))]

    def _get_example(self, meta) -> Dict:
        """One example with its reference mels (feeder.py:332-450)."""
        dataset, text = meta[0], meta[7]
        emt_label, spk_label = meta[8], meta[9]
        inputs = np.asarray(text_to_sequence(text, self.cleaners), np.int32)
        mel = self._load_mel(meta)
        rows = self.train_meta
        if dataset in ("emt4", "emth"):
            ref_spk = mel
            row = self._random_row_where(
                rows, lambda m: m[0] in ("emt4", "emth") and m[8] == emt_label)
            ref_emt = self._load_mel(row) if row is not None else mel
        else:
            ref_emt = mel
            row = self._random_row_where(rows, lambda m: m[9] == spk_label)
            ref_spk = self._load_mel(row) if row is not None else mel
        return dict(inputs=inputs, mel_target=mel,
                    token_target=np.zeros((len(mel) - 1,), np.float32),
                    emt_label=int(emt_label), spk_label=int(spk_label),
                    ref_mel_emt=ref_emt, ref_mel_spk=ref_spk,
                    mel_length=len(mel))

    def _next_train_example(self) -> Dict:
        if self._train_offset >= len(self.train_meta):
            self._train_offset = 0
            perm = self.rng.permutation(len(self.train_meta))
            self.train_meta = [self.train_meta[i] for i in perm]
        meta = self.train_meta[self._train_offset]
        self._train_offset += 1
        return self._get_example(meta)

    # --------------------------------------------------------------- batches

    def _pad_batch(self, examples: List[Dict]) -> Dict[str, np.ndarray]:
        """Pad and stack one batch (feeder.py:458-585)."""
        r = self.cfg.tacotron.outputs_per_step
        lengths = np.asarray([len(e["inputs"]) for e in examples], np.int32)
        in_max = _round_up(int(lengths.max()), self.pad_text_multiple)
        inputs = np.stack([np.pad(e["inputs"], (0, in_max - len(e["inputs"])))
                           for e in examples])

        def pad_targets(key):
            max_len = max(len(e[key]) for e in examples)
            n = _round_up(_round_up(max_len, r), self.pad_mel_multiple)
            return np.stack([
                np.pad(e[key], ((0, n - len(e[key])), (0, 0)),
                       constant_values=self._target_pad)
                for e in examples]).astype(np.float32)

        tok_max = _round_up(
            _round_up(max(len(e["token_target"]) for e in examples) + 1, r),
            self.pad_mel_multiple)
        tokens = np.stack([
            np.pad(e["token_target"], (0, tok_max - len(e["token_target"])),
                   constant_values=1.0) for e in examples])
        return dict(
            inputs=inputs, input_lengths=lengths,
            mel_targets=pad_targets("mel_target"),
            stop_token_targets=tokens.astype(np.float32),
            targets_lengths=np.asarray([e["mel_length"] for e in examples],
                                       np.int32),
            emt_labels=np.asarray([e["emt_label"] for e in examples],
                                  np.int32),
            spk_labels=np.asarray([e["spk_label"] for e in examples],
                                  np.int32),
            ref_mel_emt=pad_targets("ref_mel_emt"),
            ref_mel_spk=pad_targets("ref_mel_spk"))

    def train_batches(self, batch_size: Optional[int] = None
                      ) -> Iterator[Dict]:
        """Infinite stream of length-bucketed, shuffled train batches."""
        n = batch_size or self.cfg.train.tacotron_batch_size
        while True:
            examples = [self._next_train_example()
                        for _ in range(n * self.batches_per_group)]
            examples.sort(key=lambda e: e["mel_length"])
            batches = [examples[i:i + n] for i in range(0, len(examples), n)]
            self.rng.shuffle(batches)
            for b in batches:
                if len(b) == n:
                    yield self._pad_batch(b)

    def test_batches(self, batch_size: Optional[int] = None) -> List[Dict]:
        """Fixed eval batches over the whole test split."""
        n = batch_size or self.cfg.train.tacotron_batch_size
        examples = [self._get_example(m) for m in self.test_meta]
        examples.sort(key=lambda e: e["mel_length"])
        return [self._pad_batch(examples[i:i + n])
                for i in range(0, len(examples), n) if i + n <= len(examples)]

    def prefetch(self, iterator: Iterator[Dict], depth: int = 8
                 ) -> Iterator[Dict]:
        """Batches from a background thread, `depth` ahead."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = object()

        def worker():
            try:
                for item in iterator:
                    q.put(item)
            finally:
                q.put(stop)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                return
            yield item
