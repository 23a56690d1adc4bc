"""TI-SV utterance windows for the discriminators' corpora.

Counterpart of tacotron2_tpu/disc/data_preprocess.py (reference code/
spk_disc/data_preprocess.py, save_spectrogram_tisv(_voxceleb), :93-197):
walk a corpus with one directory per speaker (wavs at any depth), split
each utterance by voice activity (`data.audio.split_silence`), take the
power log-mel spectrogram log10(mel · |STFT|² + 1e-6) of each voiced
interval long enough for a window, cut it into `tisv_frame` windows (every
one, or with `edges_only` the first and last, the VCTK variant), and save
one [n_windows, n_mels, tisv_frame] stack a speaker, `speaker<i>.npy`,
with a metadata.csv, under <out_dir>/{train,test}_tisv/ (speakers split
by `seed`). Speakers are processed in a pool of `n_jobs` worker
processes, started by spawning (a forked copy of a process with threads,
torch's or a caller's, can deadlock); one job runs in this process.
"""

from __future__ import annotations

import csv
import glob
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from ..config import AudioConfig
from ..data import audio
from ..ops import stft as _stft
from ..utils import log


def log_mel_windows(wav: np.ndarray, cfg: AudioConfig, *,
                    n_mels: int = 40, tisv_frame: int = 140,
                    top_db: float = 20.0, edges_only: bool = False
                    ) -> List[np.ndarray]:
    """The [n_mels, tisv_frame] log-mel windows of a waveform's voiced
    intervals longer than tisv_frame · hop + win_size samples
    (data_preprocess.py:118-129, 175-187)."""
    hop = cfg.effective_hop
    min_len = int(tisv_frame * hop + cfg.win_size)
    basis = _stft.mel_basis(cfg.sample_rate, cfg.n_fft, n_mels,
                            cfg.fmin, cfg.fmax).T  # [bins, n_mels]
    windows: List[np.ndarray] = []
    for start, end in audio.split_silence(wav, top_db=top_db):
        if end - start <= min_len:
            continue
        spec = np.abs(audio._stft_np(wav[start:end], cfg)) ** 2  # [T, bins]
        S = np.log10(spec @ basis + 1e-6).T  # [n_mels, T]
        if S.shape[1] < tisv_frame:
            continue
        if edges_only:
            windows.append(S[:, :tisv_frame])
            windows.append(S[:, -tisv_frame:])
        else:
            for j in range(S.shape[1] // tisv_frame):
                windows.append(S[:, j * tisv_frame:(j + 1) * tisv_frame])
    return windows


def _process_speaker(args_tuple) -> Tuple[str, int, Optional[str]]:
    (speaker_dir, out_path, cfg, n_mels, tisv_frame, top_db,
     edges_only) = args_tuple
    wavs = sorted(
        glob.glob(os.path.join(speaker_dir, "**", "*.wav"), recursive=True)
        + glob.glob(os.path.join(speaker_dir, "**", "*.WAV"), recursive=True))
    windows: List[np.ndarray] = []
    for path in wavs:
        try:
            wav = audio.load_wav(path, cfg.sample_rate)
        except Exception:  # an unreadable file is skipped, as the
            continue       # reference skips missing wavs
        windows.extend(log_mel_windows(wav, cfg, n_mels=n_mels,
                                       tisv_frame=tisv_frame, top_db=top_db,
                                       edges_only=edges_only))
    name = os.path.basename(speaker_dir.rstrip(os.sep))
    if not windows:
        return name, 0, None
    np.save(out_path, np.stack(windows).astype(np.float32),
            allow_pickle=False)
    return name, len(windows), out_path


def build_speaker_stacks(corpus_dir: str, out_dir: str, cfg: AudioConfig, *,
                         n_mels: int = 40, tisv_frame: int = 140,
                         top_db: float = 20.0, edges_only: bool = False,
                         test_fraction: float = 0.1, seed: int = 1234,
                         n_jobs: Optional[int] = None) -> dict:
    """Per-speaker TI-SV stacks under <out_dir>/{train,test}_tisv/, the
    speakers shuffled by `seed` and split 1 - test_fraction / test_fraction
    (the reference's 90/10, :107); each split's metadata.csv has the
    columns id,speaker_num,n_windows. Returns {split: its directory}."""
    speaker_dirs = sorted(p for p in glob.glob(os.path.join(corpus_dir, "*"))
                          if os.path.isdir(p))
    if not speaker_dirs:
        raise FileNotFoundError(
            f"no speaker directories under {corpus_dir!r}; expected "
            "<corpus>/<speaker>/**/*.wav")
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(speaker_dirs))
    n_test = int(len(speaker_dirs) * test_fraction)
    n_test = min(max(n_test, 1 if test_fraction > 0 else 0),
                 len(speaker_dirs) - 1)
    splits = {"train": [speaker_dirs[i] for i in order[:len(order) - n_test]],
              "test": [speaker_dirs[i] for i in order[len(order) - n_test:]]}

    result = {}
    for split, dirs in splits.items():
        if not dirs:
            continue
        split_dir = os.path.join(out_dir, f"{split}_tisv")
        os.makedirs(split_dir, exist_ok=True)
        tasks = [(d, os.path.join(split_dir, f"speaker{i}.npy"), cfg, n_mels,
                  tisv_frame, top_db, edges_only) for i, d in enumerate(dirs)]
        if n_jobs == 1 or len(tasks) == 1:
            rows = [_process_speaker(t) for t in tasks]
        else:
            with ProcessPoolExecutor(
                    max_workers=n_jobs,
                    mp_context=multiprocessing.get_context("spawn")) as ex:
                rows = list(ex.map(_process_speaker, tasks))
        kept = [(sid, n, p) for sid, n, p in rows if p is not None]
        with open(os.path.join(split_dir, "metadata.csv"), "w",
                  encoding="utf-8", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "speaker_num", "n_windows"])
            for i, (sid, n, p) in enumerate(kept):
                w.writerow([sid, f"speaker{i}", n])
        # stacks were written under the index before the filter: close gaps
        for i, (sid, n, p) in enumerate(kept):
            want = os.path.join(split_dir, f"speaker{i}.npy")
            if p != want:
                os.replace(p, want)
        dropped = [sid for sid, n, p in rows if p is None]
        if dropped:
            log(f"disc-preprocess[{split}]: dropped {len(dropped)} speakers "
                f"with no voiced windows: {dropped[:5]}...")
        log(f"disc-preprocess[{split}]: {len(kept)} speakers, "
            f"{sum(n for _, n, _ in kept)} windows -> {split_dir}")
        result[split] = split_dir
    return result
