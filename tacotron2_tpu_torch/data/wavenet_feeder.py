"""WaveNet input pipeline: (audio, mel) pairs -> cropped, normalized
batches.

Port of tacotron2_tpu/data/wavenet_feeder.py: `interp_to_unit` (:35) and
`WaveNetFeeder` (:41-229), in one process with `np.load` (the port has
no native loader):

- metadata: GTA map.txt rows `audio_path|mel_path|gta_mel_path|...` or
  preprocessing train.txt rows (files under <dataset>/audio and /mels);
- the split of `train_test_split_indices` (seed wavenet_data_random_state,
  the test split rounded down to a batch multiple);
- random crops to `max_time_steps` (or `max_time_sec`) aligned to hop
  boundaries, keeping len(x) = len(c) · hop;
- conditioning mels padded, clipped to the mel range and rescaled to
  [0, 1]; mulaw-quantize inputs one-hot encoded, scalar inputs [T, 1].

The random draws come in the JAX feeder's order from the same
`np.random.default_rng` seed, so one seed gives the same batches.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config import Config
from ..ops.mulaw import is_mulaw_quantize
from ..parallel.dist import rank_world
from .feeder import train_test_split_indices


def _ensure_divisible(length: int, divisor: int, lower: bool = True) -> int:
    if length % divisor == 0:
        return length
    return (length - length % divisor if lower
            else length + divisor - length % divisor)


def interp_to_unit(feats, cfg: Config):
    """[-max, max] (or [0, max]) → [0, 1] (reference _interp,
    feeder.py:427). Works on numpy arrays and torch tensors."""
    lo = -cfg.audio.max_abs_value if cfg.audio.symmetric_mels else 0.0
    return (feats - lo) / (cfg.audio.max_abs_value - lo)


class WaveNetFeeder:
    """Batched (x, y, c, g, input_lengths) stream for vocoder training."""

    def __init__(self, cfg: Config, metadata_path: str,
                 base_dir: Optional[str] = None, *, gta: bool = True,
                 batches_per_group: int = 64, seed: Optional[int] = None,
                 shard_by_host: bool = True):
        self.cfg = cfg
        self.gta = gta
        self.data_dir = os.path.dirname(metadata_path)
        self.base_dir = base_dir or self.data_dir
        self.batches_per_group = batches_per_group
        t = cfg.train
        self.rng = np.random.default_rng(
            seed if seed is not None else t.wavenet_data_random_state)
        with open(metadata_path, encoding="utf-8") as f:
            self.metadata = [line.strip().split("|") for line in f
                             if line.strip()]
        test_size = (t.wavenet_test_size if t.wavenet_test_size is not None
                     else t.wavenet_test_batches * t.wavenet_batch_size)
        train_idx, test_idx = train_test_split_indices(
            len(self.metadata), test_size, t.wavenet_batch_size,
            t.wavenet_data_random_state)
        self.train_meta = [self.metadata[i] for i in train_idx]
        self.test_meta = [self.metadata[i] for i in test_idx]
        self._train_offset = 0
        # a data-parallel group's rank takes its stride shard of the train
        # split with its own shuffle stream; the test split is replicated
        # (JAX wavenet_feeder.py:69-78)
        rank, world = rank_world()
        if shard_by_host and world > 1:
            self.train_meta = self.train_meta[rank::world]
            base = seed if seed is not None else t.wavenet_data_random_state
            self.rng = np.random.default_rng(base + rank)

    # -------------------------------------------------------------- loading

    def _resolve(self, row, kind: str) -> str:
        """A metadata row's audio or mel .npy: GTA map rows name them (the
        mel in column 2, the GTA mel); train.txt rows name files under
        <dataset>/audio and <dataset>/mels."""
        if row[0].endswith(".npy"):
            path = row[0] if kind == "audio" else row[2 if len(row) > 2
                                                      else 1]
            return (path if os.path.isabs(path)
                    else os.path.join(self.base_dir, path))
        sub = "audio" if kind == "audio" else "mels"
        name = row[1] if kind == "audio" else row[2]
        return os.path.join(self.data_dir, row[0], sub, name)

    def _load_example(self, row):
        x = np.load(self._resolve(row, "audio"))
        c = np.load(self._resolve(row, "mel"))
        g = int(float(row[9])) if len(row) > 9 else 0
        return x, c, g

    # ------------------------------------------------------------- batching

    def _assert_upsample_ready(self, x, c):
        hop = self.cfg.audio.effective_hop
        if len(x) != len(c) * hop:
            raise ValueError(f"hop misalignment: {len(x)} samples vs "
                             f"{len(c)} frames (hop {hop})")

    def _crop(self, x, c):
        """Random hop-aligned crop to max_time_steps (feeder.py:368-390)."""
        cfg = self.cfg
        hop = cfg.audio.effective_hop
        max_steps = cfg.train.max_time_steps
        if cfg.train.max_time_sec is not None:
            max_steps = int(cfg.train.max_time_sec * cfg.audio.sample_rate)
        self._assert_upsample_ready(x, c)
        if max_steps is not None and len(x) > max_steps:
            max_frames = _ensure_divisible(max_steps, hop, True) // hop
            start = int(self.rng.integers(0, len(c) - max_frames))
            x = x[start * hop: (start + max_frames) * hop]
            c = c[start: start + max_frames]
            self._assert_upsample_ready(x, c)
        return x, c

    def _pad_batch(self, examples) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        lengths = np.asarray([len(x) for x, _, _ in examples], np.int32)
        max_len = int(lengths.max())
        if is_mulaw_quantize(cfg.wavenet.input_type):
            xs = np.stack([np.pad(x, (0, max_len - len(x)),
                                  constant_values=127) for x, _, _ in examples])
            x_batch = np.eye(cfg.wavenet.quantize_channels,
                             dtype=np.float32)[xs]
            y_batch = xs.astype(np.int32)
        else:
            xs = np.stack([np.pad(x.astype(np.float32), (0, max_len - len(x)))
                           for x, _, _ in examples])
            x_batch = xs[:, :, None]
            y_batch = xs
        hop = cfg.audio.effective_hop
        spec_pad = -cfg.audio.max_abs_value if cfg.audio.symmetric_mels else 0.0
        max_frames = max_len // hop
        cs = []
        for _, c, _ in examples:
            c = np.pad(c, ((0, max_frames - len(c)), (0, 0)),
                       constant_values=spec_pad)
            if cfg.audio.clip_for_wavenet:
                c = np.clip(c, spec_pad, cfg.audio.max_abs_value)
            if cfg.audio.normalize_for_wavenet:
                c = interp_to_unit(c, cfg)
            cs.append(c)
        return dict(x=x_batch, y=y_batch, c=np.stack(cs).astype(np.float32),
                    g=np.asarray([g for _, _, g in examples], np.int32),
                    input_lengths=lengths)

    def _next_train_row(self):
        if self._train_offset >= len(self.train_meta):
            self._train_offset = 0
            perm = self.rng.permutation(len(self.train_meta))
            self.train_meta = [self.train_meta[i] for i in perm]
        row = self.train_meta[self._train_offset]
        self._train_offset += 1
        return row

    def train_batches(self, batch_size: Optional[int] = None
                      ) -> Iterator[Dict]:
        """Groups of batches_per_group batches: load, crop (in row order),
        sort by length, shuffle the batches, yield the full ones."""
        n = batch_size or self.cfg.train.wavenet_batch_size
        while True:
            rows = [self._next_train_row()
                    for _ in range(n * self.batches_per_group)]
            group = []
            for row in rows:
                x, c, g = self._load_example(row)
                x, c = self._crop(x, c)
                group.append((x, c, g))
            group.sort(key=lambda e: len(e[0]))
            batches = [group[i:i + n] for i in range(0, len(group), n)]
            self.rng.shuffle(batches)
            for b in batches:
                if len(b) == n:
                    yield self._pad_batch(b)

    def test_batches(self, batch_size: Optional[int] = None) -> List[Dict]:
        n = batch_size or self.cfg.train.wavenet_batch_size
        examples = []
        for row in self.test_meta:
            x, c, g = self._load_example(row)
            x, c = self._crop(x, c)
            examples.append((x, c, g))
        examples.sort(key=lambda e: len(e[0]))
        return [self._pad_batch(examples[i:i + n])
                for i in range(0, len(examples), n) if i + n <= len(examples)]
