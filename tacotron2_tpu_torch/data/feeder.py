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
  as the emotion reference; with `emt_only` a same-emotion emt4/emth
  row's as the emotion reference and no speaker reference; with
  `intercross_both` a same-speaker row's as the speaker reference and
  their own as the emotion reference (`intercross_spk_only`: emotion or
  speaker, drawn);
- `unpaired`: crossed references for the second decode pass, a random
  emotion and speaker class (of the classes present, without class "0"
  under `no_general`) and a random row of each, or the paired references
  with `up_ref_match_p`; their keys (ref_mel_up_emt / _spk,
  emt_up_labels / spk_up_labels) go into train batches only;
- the debug options: `remove_long_samples` (rows named *_021.wav or
  *_023.wav, or of 500 frames or more, dropped), `test_inputs` (constant
  30-frame examples) and `test_max_len` (longest rows first);
- `prefetch`, a background thread;
- `shard_by_host`: under a data-parallel group rank r of n takes the
  stride shard r::n of the train split and the shuffle stream seeded
  base + r (the test split stays whole on every rank), as the JAX feeder
  does over its processes;
- `create_fixed_eval_set`, the style-transfer eval manifest of `cli
  fixed-eval-set` (JAX :331): the same rows from the same seed.

The random draws come from one numpy Generator in the JAX feeder's
order, so that the two feeders give the same batches.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config import Config
from ..parallel.dist import rank_world
from ..text import text_to_sequence
from ..utils import log


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
                 emt_only: bool = False, intercross_both: bool = False,
                 intercross_spk_only: bool = False, unpaired: bool = False,
                 up_ref_match_p: bool = False, no_general: bool = False,
                 remove_long_samples: bool = False,
                 batches_per_group: Optional[int] = None,
                 pad_text_multiple: int = 1, pad_mel_multiple: int = 1,
                 seed: Optional[int] = None, test_inputs: bool = False,
                 test_max_len: bool = False, shard_by_host: bool = True):
        self.cfg = cfg
        self.data_folder = os.path.dirname(metadata_path)
        self.emt_only = emt_only
        self.intercross_both = intercross_both
        self.intercross_spk_only = intercross_spk_only
        self.unpaired = unpaired
        self.up_ref_match_p = up_ref_match_p
        self.test_inputs = test_inputs
        self.pad_text_multiple = pad_text_multiple
        self.pad_mel_multiple = pad_mel_multiple
        self.batches_per_group = batches_per_group or cfg.data.batches_per_group
        self.cleaners = cfg.data.cleaners
        self.rng = np.random.default_rng(
            seed if seed is not None else cfg.train.tacotron_data_random_state)
        with open(metadata_path, encoding="utf-8") as f:
            meta = [line.strip().split("|") for line in f if line.strip()]
        if remove_long_samples:
            before = len(meta)
            meta = [m for m in meta if not m[10].endswith(("_023.wav",
                                                           "_021.wav"))]
            meta = [m for m in meta if int(m[6]) < 500]
            print(f"Removed long samples: {before} -> {len(meta)}")
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
        # a data-parallel group's rank takes its stride shard of the train
        # split with its own shuffle stream; the test split is replicated
        # (JAX feeder.py:107-118)
        rank, world = rank_world()
        if shard_by_host and world > 1:
            self.train_meta = self.train_meta[rank::world]
            base = (seed if seed is not None
                    else cfg.train.tacotron_data_random_state)
            self.rng = np.random.default_rng(base + rank)
        if test_max_len:
            for rows in (self.train_meta, self.test_meta):
                rows.sort(key=lambda m: int(m[6]), reverse=True)
            print("TESTING MAX LENGTH FOR SAMPLES TO FIND MAX BATCH SIZE")
        emts, spks = sorted({m[8] for m in meta}), sorted({m[9] for m in meta})
        if no_general:
            emts = [e for e in emts if e != "0"]
            spks = [x for x in spks if x != "0"]
        self.emt_list, self.spk_list = emts, spks
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
        nm = self.cfg.audio.num_mels
        if self.test_inputs:
            mel = np.ones((30, nm), np.float32)
            return dict(
                inputs=np.asarray(text_to_sequence("hello", self.cleaners),
                                  np.int32),
                mel_target=mel, token_target=np.zeros((29,), np.float32),
                emt_label=int(emt_label), spk_label=int(spk_label),
                ref_mel_emt=mel, ref_mel_spk=mel,
                emt_up_label=int(float(emt_label)),
                spk_up_label=int(float(spk_label)),
                ref_mel_up_emt=mel, ref_mel_up_spk=mel, mel_length=30)
        inputs = np.asarray(text_to_sequence(text, self.cleaners), np.int32)
        mel = self._load_mel(meta)
        rows = self.train_meta
        load = lambda row: self._load_mel(row) if row is not None else mel
        emotional = lambda m: m[0] in ("emt4", "emth") and m[8] == emt_label
        if self.emt_only:
            ref_spk = np.zeros((1, nm), np.float32)
            ref_emt = load(self._random_row_where(rows, emotional))
        elif self.intercross_both or self.intercross_spk_only:
            chosen = (self.rng.choice(["emt", "spk"])
                      if self.intercross_spk_only else "spk")
            label, col = ((emt_label, 8) if chosen == "emt"
                          else (spk_label, 9))
            same = load(self._random_row_where(
                rows, lambda m: m[col] == label))
            ref_emt, ref_spk = ((same, mel) if chosen == "emt"
                                else (mel, same))
        elif dataset in ("emt4", "emth"):
            ref_spk = mel
            ref_emt = load(self._random_row_where(rows, emotional))
        else:
            ref_emt = mel
            ref_spk = load(self._random_row_where(
                rows, lambda m: m[9] == spk_label))
        up_emt = up_spk = np.zeros((1, nm), np.float32)
        emt_up, spk_up = emt_label, spk_label
        if self.unpaired:
            if self.up_ref_match_p:
                up_emt, up_spk = ref_emt, ref_spk
            else:
                emt_up = str(self.rng.choice(self.emt_list))
                spk_up = str(self.rng.choice(self.spk_list))
                row_e = self._random_row_where(rows,
                                               lambda m: m[8] == emt_up)
                row_s = self._random_row_where(rows,
                                               lambda m: m[9] == spk_up)
                if row_e is not None:
                    up_emt = self._load_mel(row_e)
                if row_s is not None:
                    up_spk = self._load_mel(row_s)
        return dict(inputs=inputs, mel_target=mel,
                    token_target=np.zeros((len(mel) - 1,), np.float32),
                    emt_label=int(emt_label), spk_label=int(spk_label),
                    ref_mel_emt=ref_emt, ref_mel_spk=ref_spk,
                    emt_up_label=int(float(emt_up)),
                    spk_up_label=int(float(spk_up)),
                    ref_mel_up_emt=up_emt, ref_mel_up_spk=up_spk,
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

    def _pad_batch(self, examples: List[Dict], train: bool
                   ) -> Dict[str, np.ndarray]:
        """Pad and stack one batch (feeder.py:458-585); a train batch of
        the unpaired feeder also carries the crossed references."""
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
        batch = dict(
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
        if train and self.unpaired:
            for k in ("emt", "spk"):
                batch[f"{k}_up_labels"] = np.asarray(
                    [e[f"{k}_up_label"] for e in examples], np.int32)
            for k in ("emt", "spk"):
                batch[f"ref_mel_up_{k}"] = pad_targets(f"ref_mel_up_{k}")
        return batch

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
                    yield self._pad_batch(b, train=True)

    def test_batches(self, batch_size: Optional[int] = None) -> List[Dict]:
        """Fixed eval batches over the whole test split."""
        n = batch_size or self.cfg.train.tacotron_batch_size
        examples = [self._get_example(m) for m in self.test_meta]
        examples.sort(key=lambda e: e["mel_length"])
        return [self._pad_batch(examples[i:i + n], train=False)
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


def create_fixed_eval_set(metadata_path: str, out_path: str, *,
                          n_texts: int = 5, n_refs_per_class: int = 5,
                          min_frames: int = 200, class_col: int = 8,
                          seed: int = 0) -> str:
    """A reproducible style-transfer eval manifest (reference feeder.py:
    585-687, `create_test_samps_fixed`): `n_texts` utterances longer than
    `min_frames` as the texts, each crossed with `n_refs_per_class`
    references of every class, in the synthesis metadata schema (train.txt
    columns, [12] the emotion reference 'dataset/mel', [13] a tag for the
    output names, [14] 'same': the speaker reference is the row's own mel)
    that `synthesize --mode synthesis` reads."""
    rng = np.random.default_rng(seed)
    with open(metadata_path, encoding="utf-8") as f:
        meta = [line.strip().split("|") for line in f if line.strip()]
    long_rows = [m for m in meta if int(m[6]) > min_frames] or meta
    by_class: Dict[str, list] = {}
    for m in long_rows:
        by_class.setdefault(m[class_col], []).append(m)

    text_rows = [long_rows[i] for i in
                 rng.choice(len(long_rows), min(n_texts, len(long_rows)),
                            replace=False)]
    out_rows = []
    for t_row in text_rows:
        for cls in sorted(by_class):
            cands = by_class[cls]
            picks = rng.choice(len(cands), min(n_refs_per_class, len(cands)),
                               replace=False)
            for k, ci in enumerate(picks):
                ref = cands[int(ci)]
                row = list(t_row[:12])
                row[8] = cls
                row += [f"{ref[0]}/{ref[2]}", f"e{cls}_{k + 1}", "same"]
                out_rows.append("|".join(str(x) for x in row))
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(out_rows) + "\n")
    log(f"Wrote {len(out_rows)} fixed eval rows -> {out_path}")
    return out_path
