"""Command line of the PyTorch port: `python -m tacotron2_tpu_torch.cli serve`.

Port of tacotron2_tpu/cli.py `serve` (:382): text → wav through one
`TextToWavProgram` per padded-text bucket, built on first use and cached.
Weights are the JAX package's flax msgpack checkpoints (Tacotron
{params, batch_stats}, WaveNet EMA params), read without flax. Sentences
come from --text-list / --sentence, or from stdin, one per line; wavs land
in <output-dir>/serve/speech-NNNNN.wav.

    python -m tacotron2_tpu_torch.cli serve \
        --checkpoint artifacts/e2e_demo_r5/taco_ckpt.msgpack \
        --wavenet-checkpoint artifacts/e2e_demo_r5/wn_ckpt.msgpack \
        --ref-mel-emt ref.npy --sentence "abcdefg hij"
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time
import wave

import numpy as np

from .config import get_config


def log(msg: str) -> None:
    print(f"[tacotron2_tpu_torch] {msg}", flush=True)


def save_wav(wav: np.ndarray, path: str, sr: int) -> None:
    """Peak-normalize to int16 and write a mono wav (the JAX package's
    data/audio.py save_wav semantics, with the stdlib writer)."""
    wav = np.asarray(wav, np.float32)
    if wav.size == 0:
        wav = np.zeros(1, np.float32)
    pcm = (wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))).astype(
        "<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def make_serve_fn(args):
    """Returns (run, out_dir): run(sentences) synthesizes through the
    bucketed programs and returns the written wav paths."""
    from .convert import load_checkpoints
    from .synth.pipeline import TextToWavProgram
    from .text import text_to_sequence

    cfg = get_config(args.preset, args.hparams)
    out_dir = os.path.join(args.output_dir, "serve")
    os.makedirs(out_dir, exist_ok=True)
    tparams, stats, wparams = load_checkpoints(args.checkpoint,
                                               args.wavenet_checkpoint)
    nm = cfg.audio.num_mels
    ref = (np.load(args.ref_mel_emt) if args.ref_mel_emt
           else np.zeros((args.t_ref, nm), np.float32))
    ref_spk = np.load(args.ref_mel_spk) if args.ref_mel_spk else ref
    buckets = sorted(int(b) for b in args.buckets.split(","))
    programs = {}

    def program_for(seq_len: int) -> TextToWavProgram:
        t_in = next((b for b in buckets if b >= seq_len), None)
        if t_in is None:
            raise ValueError(f"cleaned text length {seq_len} exceeds largest "
                             f"bucket {buckets[-1]} (raise --buckets)")
        if t_in not in programs:
            t0 = time.time()
            programs[t_in] = TextToWavProgram(
                cfg, tparams, stats, wparams, batch=args.serve_batch,
                steps=args.steps, t_in=t_in, t_ref=args.t_ref,
                device=args.device, seed=args.seed)
            log(f"serve: built bucket t_in={t_in} batch={args.serve_batch} "
                f"steps={args.steps} in {time.time() - t0:.1f}s")
        return programs[t_in]

    counter = [len(glob.glob(os.path.join(out_dir, "speech-*.wav")))]

    def run(sentences):
        seq_len = max(len(text_to_sequence(s, cfg.data.cleaners))
                      for s in sentences)
        prog = program_for(seq_len)
        refs = [ref[:args.t_ref]] * len(sentences)
        refs_s = [ref_spk[:args.t_ref]] * len(sentences)
        t0 = time.time()
        wavs = prog.synthesize(sentences, refs, refs_s)
        dt = time.time() - t0
        paths = []
        for w in wavs:
            path = os.path.join(out_dir, f"speech-{counter[0]:05d}.wav")
            save_wav(w, path, cfg.audio.sample_rate)
            paths.append(path)
            counter[0] += 1
        audio_s = sum(len(w) for w in wavs) / cfg.audio.sample_rate
        log(f"serve: {len(wavs)} utts in {dt:.2f}s "
            f"({audio_s / max(dt, 1e-9):.2f}x realtime) -> {out_dir}")
        return paths

    return run, out_dir


def cmd_serve(args):
    run, _ = make_serve_fn(args)
    if args.text_list:
        with open(args.text_list, encoding="utf-8") as f:
            run([line.strip() for line in f if line.strip()])
    elif args.sentence:
        run([args.sentence])
    else:
        for line in sys.stdin:
            if not line.strip():
                break
            run([line.strip()])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tacotron2_tpu_torch")
    p.add_argument("--preset", default="default")
    p.add_argument("--hparams", default="",
                   help="dotted config overrides, e.g. tacotron.max_iters=500")
    sub = p.add_subparsers(dest="command", required=True)
    sv = sub.add_parser("serve", help="text -> wav through TextToWavProgram")
    sv.add_argument("--checkpoint", required=True,
                    help="Tacotron flax msgpack ({params, batch_stats})")
    sv.add_argument("--wavenet-checkpoint", required=True,
                    help="WaveNet flax msgpack (EMA params)")
    sv.add_argument("--output-dir", default=".")
    sv.add_argument("--text-list", default=None)
    sv.add_argument("--sentence", default=None)
    sv.add_argument("--ref-mel-emt", default=None)
    sv.add_argument("--ref-mel-spk", default=None)
    sv.add_argument("--serve-batch", type=int, default=8)
    sv.add_argument("--steps", type=int, default=250)
    sv.add_argument("--t-ref", type=int, default=64)
    sv.add_argument("--buckets", default="64,128,256")
    sv.add_argument("--device", default="cuda")
    sv.add_argument("--seed", type=int, default=0)
    sv.set_defaults(func=cmd_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
