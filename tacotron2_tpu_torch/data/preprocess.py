"""Offline preprocessing: corpus wavs -> mel .npy and the train.txt or
map.txt manifests.

The port's copy of tacotron2_tpu/data/preprocess.py (reference
code/datasets/preprocessor.py:15-199, wavenet_preprocessor.py and
datasets/metadata.py): per utterance load -> trim -> preemphasize ->
rescale -> mel (with optional linear and mulaw audio), the hop-aligned
audio padding and the 12-field train.txt row
  dataset|audio|mel|linear|spkemb|time_steps|mel_frames|text|emt|spk|basename|sex
(`process_utterance`, `build_from_path`, `write_metadata`); the 6-field
vocoder map.txt row of a bare wav folder (`wavenet_process_utterance`,
`wavenet_build_from_path`, `write_wavenet_metadata`); the corpus
manifests `path|text|emt_label|spk_id|sex` of `create_metadata` (the
ljspeech and folders layouts and the emt4, jessa, emth, librispeech and
vctk corpora) and `vctk_accent_relabel`. Mels are saved frames-major
[frames, num_mels], as the reference saves `mel_spectrogram.T`.

Utterances are processed in a pool of `n_jobs` worker processes, started
by spawning (a forked copy of a process with threads, torch's or a
caller's, can deadlock), or in this process with `serial`. A spawned
worker re-imports the caller's main module: a script that calls these
functions runs them under `if __name__ == "__main__":`.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import AudioConfig, Config
from ..ops import mulaw as mulaw_ops
from . import audio


def _map(fn, jobs, n_jobs: int, serial: bool) -> list:
    """fn over jobs, in this process or in a pool of spawned workers."""
    if serial:
        return [fn(j) for j in jobs]
    with ProcessPoolExecutor(
            max_workers=n_jobs,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(fn, jobs))


@dataclass
class UtteranceSpec:
    """One metadata row: path|text|emt_label|spk_id|sex (datasets/metadata.py)."""

    audio_path: str
    text: str
    emt_label: int
    spk_label: int
    sex: str
    dataset: str
    index: int


def assign_speaker_labels(rows: List[List[str]], dataset: str) -> List[int]:
    """Reference speaker-id policy (preprocessor.py:53-58): emt4→0, emth→1,
    other datasets offset by 1 over sorted unique speaker strings."""
    if dataset == "emt4":
        return [0] * len(rows)
    if dataset == "emth":
        return [1] * len(rows)
    spk_ids = sorted(frozenset(r[3] for r in rows))
    return [spk_ids.index(r[3]) + 1 for r in rows]


def process_utterance(spec: UtteranceSpec, cfg: AudioConfig, mel_dir: str,
                      audio_dir: Optional[str] = None,
                      linear_dir: Optional[str] = None,
                      input_type: str = "raw",
                      quantize_channels: int = 2 ** 16
                      ) -> Optional[Tuple]:
    """One wav → mel .npy (+ optional audio/linear) → train.txt row.

    Reference: _process_utterance (preprocessor.py:78-199).
    """
    try:
        aud = audio.load_wav(spec.audio_path, cfg.sample_rate)
    except (FileNotFoundError, OSError):
        print(f"missing wav {spec.audio_path}; skipping")
        return None
    if cfg.trim_silence:
        aud = audio.trim_silence(aud, cfg)
    if len(aud) < cfg.effective_hop * 3:
        return None

    preem = audio.preemphasis(aud, cfg.preemphasis, cfg.preemphasize)
    if cfg.rescale:
        aud = aud / np.abs(aud).max() * cfg.rescaling_max
        preem = preem / np.abs(preem).max() * cfg.rescaling_max
        if (np.abs(aud) > 1).any() or (np.abs(preem) > 1).any():
            raise RuntimeError(f"audio has invalid value: {spec.audio_path}")

    # waveform target for wavenet (preprocessor.py:120-144)
    if mulaw_ops.is_mulaw_quantize(input_type):
        out = np.asarray(mulaw_ops.mulaw_quantize(aud, quantize_channels - 1))
        start, end = audio.start_and_end_indices(out, cfg.silence_threshold)
        aud, preem, out = aud[start:end], preem[start:end], out[start:end]
        constant = int(mulaw_ops.mulaw_quantize(np.zeros(1), quantize_channels - 1)[0])
        out_dtype = np.int16
    elif mulaw_ops.is_mulaw(input_type):
        out = np.asarray(mulaw_ops.mulaw(aud, quantize_channels - 1))
        constant = float(mulaw_ops.mulaw(np.zeros(1), quantize_channels - 1)[0])
        out_dtype = np.float32
    else:
        out, constant, out_dtype = aud, 0.0, np.float32

    mel = audio.mel_spectrogram(preem, cfg).astype(np.float32)  # [frames, mels]
    mel_frames = mel.shape[0]
    if cfg.clip_mels_length and mel_frames > cfg.max_mel_frames:
        return None

    # hop alignment: audio padded right to a whole number of hops then clipped
    # to mel_frames·hop — the upsampling invariant (preprocessor.py:160-182)
    l_pad, r_pad = audio.pad_lr(aud, cfg)
    out = np.pad(out, (l_pad, r_pad), mode="constant", constant_values=constant)
    assert len(out) >= mel_frames * cfg.effective_hop
    out = out[: mel_frames * cfg.effective_hop]
    assert len(out) % cfg.effective_hop == 0
    time_steps = len(out)

    mel_filename = f"mel-{spec.index}.npy"
    audio_filename = f"audio-{spec.index}.npy"
    linear_filename = f"linear-{spec.index}.npy"
    np.save(os.path.join(mel_dir, mel_filename), mel, allow_pickle=False)
    if audio_dir is not None:
        np.save(os.path.join(audio_dir, audio_filename),
                out.astype(out_dtype), allow_pickle=False)
    if linear_dir is not None:
        lin = audio.linear_spectrogram(preem, cfg).astype(np.float32)
        np.save(os.path.join(linear_dir, linear_filename), lin, allow_pickle=False)

    basename = os.path.basename(spec.audio_path)
    return (spec.dataset, audio_filename, mel_filename, linear_filename,
            "spkemb-none.npy", time_steps, mel_frames, spec.text,
            spec.emt_label, spec.spk_label, basename, spec.sex)


def build_from_path(cfg: Config, metadata_path: str, in_dir: str, out_dir: str,
                    dataset: str, n_jobs: int = os.cpu_count() or 4,
                    serial: bool = False, write_audio: bool = False,
                    write_linear: bool = False, limit: Optional[int] = None
                    ) -> List[Tuple]:
    """Process a whole corpus; returns train.txt rows (reference build_from_path)."""
    mel_dir = os.path.join(out_dir, dataset, "mels")
    os.makedirs(mel_dir, exist_ok=True)
    audio_dir = linear_dir = None
    if write_audio:
        audio_dir = os.path.join(out_dir, dataset, "audio")
        os.makedirs(audio_dir, exist_ok=True)
    if write_linear:
        linear_dir = os.path.join(out_dir, dataset, "linear")
        os.makedirs(linear_dir, exist_ok=True)

    with open(metadata_path, encoding="utf-8") as f:
        rows = [line.strip().split("|") for line in f if line.strip()]
    if limit:
        rows = rows[:limit]
    spk_labels = assign_speaker_labels(rows, dataset)

    specs = []
    for i, (row, spk) in enumerate(zip(rows, spk_labels)):
        path = row[0] + ".wav" if dataset == "emt4" and not row[0].endswith(".wav") \
            else row[0]
        specs.append(UtteranceSpec(
            audio_path=os.path.join(in_dir, path), text=row[1],
            emt_label=int(row[2]) if len(row) > 2 and row[2] else 0,
            spk_label=spk, sex=row[4] if len(row) > 4 else "U",
            dataset=dataset, index=i))

    fn = partial(process_utterance, cfg=cfg.audio, mel_dir=mel_dir,
                 audio_dir=audio_dir, linear_dir=linear_dir,
                 input_type=cfg.wavenet.input_type,
                 quantize_channels=cfg.wavenet.quantize_channels)
    return [r for r in _map(fn, specs, n_jobs, serial) if r is not None]


def wavenet_process_utterance(wav_path: str, index: str, cfg: AudioConfig,
                              mel_dir: str, wav_dir: str,
                              input_type: str = "raw",
                              quantize_channels: int = 2 ** 16
                              ) -> Optional[Tuple]:
    """One wav → (audio.npy, mel.npy) pair for standalone (non-GTA) vocoder
    training. Reference: wavenet_preprocessor._process_utterance
    (datasets/wavenet_preprocessor.py:39-156)."""
    try:
        aud = audio.load_wav(wav_path, cfg.sample_rate)
    except (FileNotFoundError, OSError):
        print(f"missing wav {wav_path}; skipping")
        return None
    if cfg.trim_silence:
        aud = audio.trim_silence(aud, cfg)
    preem = audio.preemphasis(aud, cfg.preemphasis, cfg.preemphasize)
    if cfg.rescale:
        aud = aud / np.abs(aud).max() * cfg.rescaling_max
        preem = preem / np.abs(preem).max() * cfg.rescaling_max

    if mulaw_ops.is_mulaw_quantize(input_type):
        out = np.asarray(mulaw_ops.mulaw_quantize(aud, quantize_channels - 1))
        start, end = audio.start_and_end_indices(out, cfg.silence_threshold)
        aud, preem, out = aud[start:end], preem[start:end], out[start:end]
        constant = int(mulaw_ops.mulaw_quantize(np.zeros(1),
                                                quantize_channels - 1)[0])
        out_dtype = np.int16
    elif mulaw_ops.is_mulaw(input_type):
        out = np.asarray(mulaw_ops.mulaw(aud, quantize_channels - 1))
        constant = float(mulaw_ops.mulaw(np.zeros(1), quantize_channels - 1)[0])
        out_dtype = np.float32
    else:
        out, constant, out_dtype = aud, 0.0, np.float32

    mel = audio.mel_spectrogram(preem, cfg).astype(np.float32)
    mel_frames = mel.shape[0]
    if cfg.clip_mels_length and mel_frames > cfg.max_mel_frames:
        return None
    l_pad, r_pad = audio.pad_lr(aud, cfg)
    out = np.pad(out, (l_pad, r_pad), mode="constant", constant_values=constant)
    out = out[: mel_frames * cfg.effective_hop]
    assert len(out) % cfg.effective_hop == 0
    time_steps = len(out)

    audio_filename = os.path.join(wav_dir, f"audio-{index}.npy")
    mel_filename = os.path.join(mel_dir, f"mel-{index}.npy")
    np.save(audio_filename, out.astype(out_dtype), allow_pickle=False)
    np.save(mel_filename, mel, allow_pickle=False)
    # 6-field map row: audio|mel|mel|speaker_id|time_steps|mel_frames
    # (wavenet_preprocessor.py:149-156)
    return (audio_filename, mel_filename, mel_filename, "<no_g>",
            time_steps, mel_frames)


def wavenet_build_from_path(cfg: Config, input_dir: str, out_dir: str,
                            n_jobs: int = os.cpu_count() or 4,
                            serial: bool = False,
                            limit: Optional[int] = None) -> List[Tuple]:
    """Whole wav folder → audio/mel npy pairs + map rows for non-GTA vocoder
    training. Reference: wavenet_preprocess.preprocess
    (code/wavenet_preprocess.py:10-16)."""
    # absolute paths so the map rows resolve regardless of the training cwd
    # (the feeder joins relative rows against the map's own directory)
    out_dir = os.path.abspath(out_dir)
    mel_dir = os.path.join(out_dir, "mels")
    wav_dir = os.path.join(out_dir, "audio")
    os.makedirs(mel_dir, exist_ok=True)
    os.makedirs(wav_dir, exist_ok=True)
    wavs = sorted(f for f in os.listdir(input_dir) if f.endswith(".wav"))
    if limit:
        wavs = wavs[:limit]
    jobs = [(os.path.join(input_dir, f), os.path.splitext(f)[0])
            for f in wavs]
    fn = partial(_wavenet_job, cfg=cfg, mel_dir=mel_dir, wav_dir=wav_dir)
    return [r for r in _map(fn, jobs, n_jobs, serial) if r is not None]


def _wavenet_job(job, cfg: Config, mel_dir: str, wav_dir: str):
    wav_path, index = job
    return wavenet_process_utterance(
        wav_path, index, cfg.audio, mel_dir, wav_dir,
        input_type=cfg.wavenet.input_type,
        quantize_channels=cfg.wavenet.quantize_channels)


def write_wavenet_metadata(rows: Sequence[Tuple], out_dir: str,
                           cfg: Config) -> str:
    """Write map.txt + stats (reference wavenet_preprocess.py:18-29)."""
    path = os.path.join(out_dir, "map.txt")
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write("|".join(str(x) for x in r) + "\n")
    steps = sum(int(r[4]) for r in rows)
    hours = steps / cfg.audio.sample_rate / 3600
    print(f"Wrote {len(rows)} utterances, {steps} audio timesteps "
          f"({hours:.2f} hours) -> {path}")
    return path


def create_metadata(in_dir: str, out_path: str, layout: str = "ljspeech",
                    emt_label: int = 0, sex: str = "U") -> str:
    """Generic corpus manifest in place of the reference's per-corpus
    `create_metadata_*` one-offs (datasets/metadata.py:12-261). Emits
    `path|text|emt_label|spk_id|sex` rows consumable by `build_from_path`.

    Layouts:
    - ljspeech: `metadata.csv` rows `id|raw_text|normalized_text`, wavs under
      `wavs/` — single speaker, neutral emotion.
    - folders: one subdirectory per speaker, each with `*.wav` + matching
      `*.txt` transcripts (vctk/librispeech-style flattened).
    - emt4 / jessa / emth / librispeech / vctk: the reference's
      per-corpus functions (datasets/metadata.py:12-229), reimplemented
      against the same on-disk layouts.
    """
    corpus = {"emt4": _metadata_emt4, "jessa": _metadata_jessa,
              "emth": _metadata_emth, "librispeech": _metadata_librispeech,
              "vctk": _metadata_vctk}
    if layout in corpus:
        rows = corpus[layout](in_dir)
        with open(out_path, "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")
        print(f"Wrote {len(rows)} metadata rows -> {out_path}")
        return out_path
    rows = []
    if layout == "ljspeech":
        with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("|")
                if len(parts) < 2:
                    continue
                text = parts[2] if len(parts) > 2 else parts[1]
                rows.append(f"wavs/{parts[0]}.wav|{text}|{emt_label}|0|{sex}")
    elif layout == "folders":
        for spk in sorted(os.listdir(in_dir)):
            spk_dir = os.path.join(in_dir, spk)
            if not os.path.isdir(spk_dir):
                continue
            for f in sorted(os.listdir(spk_dir)):
                if not f.endswith(".wav"):
                    continue
                txt = os.path.join(spk_dir, f[:-4] + ".txt")
                if not os.path.exists(txt):
                    continue
                with open(txt, encoding="utf-8") as tf:
                    text = tf.read().strip()
                rows.append(f"{spk}/{f}|{text}|{emt_label}|{spk}|{sex}")
    else:
        raise ValueError(f"unknown layout {layout}")
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    print(f"Wrote {len(rows)} metadata rows -> {out_path}")
    return out_path


def _walk_audio(folder_wav: str):
    """All audio files under a tree as (relpath, walk root, basename).

    relpath is relative to folder_wav's PARENT (i.e. it includes the walk
    root's own directory name), independent of nesting depth — so the
    per-corpus functions can join it onto their in_dir directly."""
    base = os.path.dirname(os.path.abspath(folder_wav))
    out = []
    for root, _, files in os.walk(folder_wav, topdown=True):
        for f in sorted(files):
            if not (f.endswith(".wav") or f.endswith(".flac")):
                continue
            rel = os.path.relpath(os.path.join(os.path.abspath(root), f),
                                  base)
            out.append((rel.replace("\\", "/"), root, f))
    return out


def _metadata_emt4(in_dir: str):
    """STCM-101/Zo layout (metadata.py:12-39): wavs under Wav/, scripts +
    emotion labels in ../all_txt_wav.txt rows `filename|script|emt`."""
    table = {}
    with open(os.path.join(in_dir, "all_txt_wav.txt"), encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) >= 3:
                table[int(parts[0])] = (parts[1], int(float(parts[2])))
    rows = []
    for rel, _, fname in _walk_audio(os.path.join(in_dir, "Wav")):
        script, emt = table[int(fname.split(".")[0])]
        rows.append(f"{rel}|{script}|{emt}|0|F")
    return rows


def _metadata_jessa(in_dir: str):
    """Jessa layout (metadata.py:41-73): wavs under wave16kNormalized/,
    per-folder tab-separated transcripts in TextScripts_UTF8/<folder>.txt."""
    wav_root = os.path.join(in_dir, "wave16kNormalized")
    rows = []
    cache = {}
    for rel, root, fname in _walk_audio(wav_root):
        folder = os.path.basename(root)
        if folder not in cache:
            table = {}
            path = os.path.join(in_dir, "TextScripts_UTF8", folder + ".txt")
            # utf-8-sig: a UTF-8 BOM decodes to one '﻿', which the
            # -sig codec strips (slicing bytes off the first key would
            # mangle it instead)
            with open(path, encoding="utf-8-sig") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2:
                        table[parts[0]] = parts[1]
            cache[folder] = table
        script = cache[folder][fname.split(".")[0]]
        rows.append(f"{rel}|{script}|0|1|F")
    return rows


def _metadata_emth(in_dir: str):
    """Harriton layout (metadata.py:75-111): tab-separated all_txt_wav.txt;
    emotion from the filename's leading digit with the Zo-alignment swap
    (harriton angry=1 -> zo 2, sad=2 -> 1, 3 -> 3; metadata.py:89-92)."""
    swap = {"1": 2, "2": 1, "3": 3}
    table = {}
    with open(os.path.join(in_dir, "all_txt_wav.txt"), encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                table[parts[0]] = (parts[1], swap.get(parts[0][:1], 0))
    rows = []
    for rel, _, fname in _walk_audio(os.path.join(in_dir,
                                                  "Wave16kNormalized")):
        script, emt = table[fname.split(".")[0]]
        rows.append(f"{rel}|{script}|{emt}|1|M")
    return rows


def _metadata_librispeech(in_dir: str):
    """LibriSpeech layout (metadata.py:113-168): train-clean-100/<spk>/<book>
    with <spk>-<book>.trans.txt transcripts and SPEAKERS.TXT sexes."""
    sexes = {}
    spk_path = os.path.join(in_dir, "SPEAKERS.TXT")
    if os.path.exists(spk_path):
        with open(spk_path, encoding="utf-8") as f:
            for line in f:
                if line.startswith(";"):
                    continue
                parts = [x.strip() for x in line.split("|")]
                if len(parts) >= 2 and parts[0].isdigit():
                    sexes[int(parts[0])] = parts[1]
    rows = []
    wav_root = os.path.join(in_dir, "train-clean-100")
    for rel, root, fname in _walk_audio(wav_root):
        spk = os.path.basename(os.path.dirname(root))
        book = os.path.basename(root)
        trans = os.path.join(root, f"{spk}-{book}.trans.txt")
        name = fname.split(".")[0]
        script = None
        with open(trans, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if parts[0] == name:
                    script = " ".join(parts[1:])
                    break
        if script is None:  # utterance missing from the trans file
            continue
        sex = sexes.get(int(spk), "N")
        rows.append(f"{spk}/{book}/{fname}|{script}|0|{spk}|{sex}")
    return rows


def _read_speaker_info(path: str):
    """VCTK speaker-info.csv: ID-indexed rows with SEX/ACCENTS/REGION."""
    info = {}
    with open(path, encoding="utf-8") as f:
        header = [h.strip().upper() for h in f.readline().split(",")]
        idx = {h: i for i, h in enumerate(header)}
        for line in f:
            parts = [x.strip() for x in line.split(",")]
            if not parts[0] or not parts[0].isdigit():
                continue
            info[int(parts[0])] = dict(
                sex=parts[idx.get("SEX", 1)] if len(parts) > 1 else "N",
                accent=parts[idx.get("ACCENTS", 2)] if len(parts) > 2 else "NA",
                region=parts[idx.get("REGION", 3)] if len(parts) > 3 else "NA")
    return info


def _metadata_vctk(in_dir: str):
    """VCTK layout (metadata.py:170-229): wav48/<pNNN>/*.wav, txt/<pNNN>/
    transcripts, speaker-info.csv; strips wrapping quotes; emits the
    7-column variant with accent|region."""
    info = _read_speaker_info(os.path.join(in_dir, "speaker-info.csv"))
    rows = []
    wav_root = os.path.join(in_dir, "wav48")
    for rel, root, fname in _walk_audio(wav_root):
        spk_name = os.path.basename(root)
        spk_id = int(spk_name[1:])
        meta = info.get(spk_id, dict(sex="N", accent="NA", region="NA"))
        name = fname.split(".")[0]
        txt = os.path.join(in_dir, "txt", spk_name, name + ".txt")
        if not os.path.exists(txt):
            continue
        with open(txt, encoding="utf-8") as f:
            script = f.read()
        # reference order preserved on purpose: quotes are stripped BEFORE
        # the trailing-newline [:-1], so `"...."\n` keeps its end quote
        # (metadata.py:216-226 — faithful to the reference's own quirk)
        if script.startswith('"'):
            script = script[1:]
        if script.endswith('"'):
            script = script[:-1]
        rows.append(f"wav48/{spk_name}/{fname}|{script[:-1]}|0|{spk_id}|"
                    f"{meta['sex']}|{meta['accent']}|{meta['region']}")
    return rows


def vctk_accent_relabel(train_path: str, speaker_info_csv: str,
                        out_path: str) -> str:
    """Rewrite a VCTK train.txt with accent-index emt labels
    (vctk_metadata_accent, metadata.py:232-261): the emt column (index 8)
    becomes the speaker's accent id in the sorted unique accent list."""
    info = _read_speaker_info(speaker_info_csv)
    accents = sorted({v["accent"] for v in info.values()})
    out = []
    with open(train_path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            name = parts[10].split("_")[0][1:]
            try:
                parts[8] = str(accents.index(info[int(name)]["accent"]))
            except (KeyError, ValueError):
                print("couldn't find speaker:", name)
                continue
            out.append("|".join(parts))
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")
    print(f"Wrote {len(out)} accent-relabeled rows -> {out_path}")
    return out_path


def write_metadata(rows: Sequence[Tuple], out_dir: str, cfg: Config,
                   filename: str = "train.txt") -> str:
    """Write train.txt + summary stats (reference preprocess.py:54-76)."""
    path = os.path.join(out_dir, filename)
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write("|".join(str(x) for x in r) + "\n")
    frames = sum(int(r[6]) for r in rows)
    steps = sum(int(r[5]) for r in rows)
    hours = steps / cfg.audio.sample_rate / 3600
    print(f"Wrote {len(rows)} utterances, {frames} mel frames, "
          f"{steps} audio timesteps ({hours:.2f} hours) -> {path}")
    return path
