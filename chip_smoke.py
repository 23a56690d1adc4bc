#!/usr/bin/env python3
"""Run the PyTorch port's text→wav serving path on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its wall seconds:

1. the device, and its name and power limit as nvidia-smi reports them;
2. build both CUDA kernels (`csrc/decoder.cu`, `csrc/sampler.cu`) with
   nvcc for sm_90a, in parallel;
3. load the trained r5 checkpoints (artifacts/e2e_demo_r5/*.msgpack) with
   the port's own msgpack reader and weight bridge, in the configuration
   scripts/train_e2e_demo_r5_tpu.py trained them with;
4. serve 8 held-out texts at the full default width through
   `TextToWavProgram` (memory pass → decode kernel → postnet → silence
   mask → upsample → sampler kernel), with every kernel launch counter set
   to 0 just before and read just after; print the samples kept after
   trimming, their audio seconds and the realtime factor; check stop
   steps, wav lengths, finiteness, and the free-run mel against the
   ground-truth mel;
5. hold each kernel against its plain PyTorch version on the serve run's
   own inputs and random numbers;
6. time each kernel and its plain version and print the `kernels` line.

The last line is {"ok": true, "device": {...}}; any failure raises and
exits non-zero before it. Without a CUDA device it exits with code 2 and
prints no result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
R5 = os.path.join(ROOT, "artifacts", "e2e_demo_r5")
HELD_ROWS = list(range(128, 136))   # 8 of the 32 held-out utterances
T_IN, T_REF = 128, 64
# scripts/train_e2e_demo_r5_tpu.py:235-236: int(1.25 * chars_hi * frames
# per char / r) with chars_hi=80, char_dur=0.06 s, 16 kHz, hop 200, r=1
MAX_STEPS = int(1.25 * 80 * (0.06 * 16000 / 200) / 1)
SAMPLER_WINDOW = 512

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# scripts/make_tiny_dataset.py:53-100 draws the corpus texts this way
ALIGN_CHARS = "abcdefghij"


def held_out_texts(n_total=160, n_train=128, chars=(40, 80), seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n_total):
        n = int(rng.integers(chars[0], chars[1] + 1))
        idx = rng.integers(0, len(ALIGN_CHARS), n)
        texts.append("".join(ALIGN_CHARS[j] for j in idx))
    return texts[n_train:]


def time_resample(mel, n_out):
    """scripts/train_e2e_demo_r5_tpu.py:41 — linear resample of a [T, M]
    mel onto n_out frames."""
    import numpy as np
    n_in = len(mel)
    pos = np.linspace(0.0, n_in - 1.0, n_out)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w = (pos - i0)[:, None].astype(np.float32)
    return (1.0 - w) * mel[i0] + w * mel[i1]


def r5_config():
    """The config scripts/train_e2e_demo_r5_tpu.py:117-135,142 builds:
    defaults, bf16 compute, all-VMEM sampler delay lines, and the corpus'
    audio config (trim_silence=False)."""
    from tacotron2_tpu_torch.config import Config
    cfg = Config()
    return cfg.replace(
        tacotron=dataclasses.replace(cfg.tacotron, compute_dtype="bfloat16",
                                     use_fused_train_decoder=True),
        wavenet=dataclasses.replace(cfg.wavenet, compute_dtype="bfloat16",
                                    use_fused_train_stack=True,
                                    sampler_hbm_delay_threshold=0),
        audio=dataclasses.replace(cfg.audio, trim_silence=False))


def phase(n, name):
    print(f"[phase {n}] {name}", flush=True)
    return time.time()


def done(n, t0):
    print(f"[phase {n}] {time.time() - t0:.3f} s", flush=True)


def cuda_ms(fn, reps):
    """Median CUDA-event time of fn() in ms over `reps` runs (one warm-up
    run happened before, in the phase that checked the result)."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def first_fire(stops, r, K, steps):
    """Per row: the step the sticky stop flag first fires (or None) and the
    steps the early-stop rule runs."""
    import numpy as np
    s = stops.reshape(stops.shape[0], steps, r)
    fired = (s > 0.5).all(-1)
    out = []
    for row in fired:
        hit = np.nonzero(row)[0]
        f = int(hit[0]) if len(hit) else None
        run = steps if f is None else min(steps, (f // K + 1) * K)
        out.append((f, run))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from tacotron2_tpu_torch.convert import load_checkpoints
    from tacotron2_tpu_torch.native import build
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
    from tacotron2_tpu_torch.text import text_to_sequence

    t_start = time.time()
    # full-precision f32 matmuls and convolutions in the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device
    t0 = phase(1, "device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"device {kind} x{count}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; python {sys.version.split()[0]}",
          flush=True)
    done(1, t0)

    # ---- 2. build both kernels, one nvcc each, started together
    t0 = phase(2, "build kernels (nvcc, sm_90a)")
    paths = build.build(["decoder", "sampler"])
    for name, path in paths.items():
        print(f"built {name}: {os.path.relpath(path, ROOT)}")
        for line in build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    done(2, t0)

    # ---- 3. r5 checkpoints through the port's reader and bridge
    t0 = phase(3, "load r5 checkpoints")
    cfg = r5_config()
    tparams, stats, wparams = load_checkpoints(
        os.path.join(R5, "taco_ckpt.msgpack"),
        os.path.join(R5, "wn_ckpt.msgpack"))
    B = len(HELD_ROWS)
    prog = TextToWavProgram(cfg, tparams, stats, wparams, batch=B,
                            steps=MAX_STEPS, t_in=T_IN, t_ref=T_REF,
                            device="cuda", seed=1234, keep_intermediates=True)
    print(f"memory width {prog.memory_width}, decode weights "
          f"{prog.dec_params.l1_wp.dtype}, steps {MAX_STEPS}, "
          f"t_audio {prog.t_audio}")
    done(3, t0)

    # ---- 4. serve held-out texts at full width
    t0 = phase(4, f"serve {B} held-out texts")
    with open(os.path.join(R5, "report.json")) as f:
        report = json.load(f)
    held = held_out_texts()
    assert [len(t) for t in held] == report["held_text_chars"], \
        "held-out texts do not match report.json"
    texts = [held[i - 128] for i in HELD_ROWS]
    seqs = [text_to_sequence(t, cfg.data.cleaners) for t in texts]
    ids = np.zeros((B, T_IN), np.int64)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
    lengths = np.asarray([len(s) for s in seqs])
    gt = [np.load(os.path.join(R5, "corpus", "mels", f"mel-{i}.npy"))
          for i in HELD_ROWS]
    refs = np.stack([m[:T_REF] for m in gt]).astype(np.float32)

    dk.launches = 0
    wk.launches = 0
    torch.cuda.synchronize()
    ts = time.time()
    samples, wav_len, mel, stops, mel_len = prog(ids, lengths, refs, refs)
    torch.cuda.synchronize()
    serve_s = time.time() - ts
    launches = {"tacotron_decoder": dk.launches, "wavenet_sampler": wk.launches}
    print(f"serve: {serve_s:.3f} s for {B} utterances; launches {launches}")
    assert all(n > 0 for n in launches.values()), launches

    samples, wav_len = samples.cpu().numpy(), wav_len.cpu().numpy()
    mel, mel_len = mel.cpu().numpy(), mel_len.cpu().numpy()
    stops = stops.cpu().numpy()
    kept = int(wav_len.sum())
    audio_s = kept / cfg.audio.sample_rate
    print(f"serve: {kept} samples kept after trimming = {audio_s:.4f} s of "
          f"audio at {cfg.audio.sample_rate} Hz; realtime factor "
          f"{audio_s / serve_s:.4f}")
    assert samples.shape == (B, prog.t_audio) and mel.shape[0] == B
    assert np.isfinite(samples).all() and np.isfinite(mel).all()
    corrs = []
    for b in range(B):
        n = int(wav_len[b])
        rms = float(np.sqrt(np.mean(samples[b, :n] ** 2))) if n else 0.0
        fm = mel[b, :int(mel_len[b])]
        c = float(np.corrcoef(time_resample(fm, len(gt[b])).ravel(),
                              gt[b].ravel())[0, 1])
        corrs.append(c)
        print(f"row {HELD_ROWS[b]}: chars {len(texts[b])} stop step "
              f"{int(mel_len[b])} (gt {len(gt[b])} frames) wav "
              f"{n} samples rms {rms:.4f} free-run mel corr {c:.4f} "
              f"(TPU run {report['taco_freerun_corr'][HELD_ROWS[b] - 128]})")
        assert int(mel_len[b]) < prog.frames, f"row {b}: stop never fired"
        assert n == int(mel_len[b]) * prog.hop and 0.0 < rms < 1.0
    # The TPU run recorded 0.965-0.977 on these texts. Prenet dropout stays
    # on at inference and draws other random numbers here, and bf16 rounds
    # differently, so the gate is loose: a decoder with a wiring fault
    # (wrong gate order, transposed weights) scores far below 0.9.
    print(f"free-run mel corr: min {min(corrs):.4f} mean "
          f"{np.mean(corrs):.4f}")
    assert min(corrs) >= 0.9, corrs
    done(4, t0)

    # ---- 5. each kernel against its plain version, same inputs and noise
    t0 = phase(5, "kernels vs plain versions")
    im = prog.intermediates
    tc = cfg.tacotron
    r, K = tc.outputs_per_step, tc.early_stop_block
    dargs = (prog.dec_params, cfg, im["keys"], im["memory"], im["mask"],
             im["drop"])
    dkw = dict(steps=MAX_STEPS, early_stop_block=K)
    f_k, s_k = dk.decode(*dargs, **dkw, kernel_weights=prog.dec_kernel)
    f_p, s_p = dk.decode_plain(*dargs, **dkw)
    torch.cuda.synchronize()
    f_k, s_k, f_p, s_p = (x.cpu().numpy() for x in (f_k, s_k, f_p, s_p))
    n32 = 32 * r
    dec_err = float(max(np.abs(f_k[:, :n32] - f_p[:, :n32]).max(),
                        np.abs(s_k[:, :n32] - s_p[:, :n32]).max()))
    fk, fp = first_fire(s_k, r, K, MAX_STEPS), first_fire(s_p, r, K, MAX_STEPS)
    print(f"decoder: max |kernel - plain| over the first 32 steps "
          f"{dec_err:.3e}; stop steps kernel {[f for f, _ in fk]} plain "
          f"{[f for f, _ in fp]}")
    # bf16 weights are upcast to f32 on both sides and all sums are f32:
    # they differ only in summation order (~1e-6 relative per product over
    # sums of up to 2,560 terms), which 32 recurrent steps carry to ~1e-5
    # (measured 1.5e-05 on these inputs); 1e-3 leaves room for that and
    # fails on any wiring fault, which moves frames by O(0.1-1).
    assert dec_err <= 1e-3, dec_err
    # the rerun repeats the serve run's decode bit for bit (no atomics;
    # every sum has a fixed order)
    assert np.array_equal(s_k, stops), "decode kernel is not deterministic"
    for b in range(B):
        assert fk[b][0] is not None and fp[b][0] is not None
        # over hundreds of steps the order differences may move a stop
        # decision that sits near 0.5 by a step or two
        assert abs(fk[b][0] - fp[b][0]) <= 2, (b, fk[b], fp[b])
        n = min(fk[b][0], fp[b][0]) * r
        c = float(np.corrcoef(f_k[b, :n].ravel(), f_p[b, :n].ravel())[0, 1])
        assert c >= 0.99, (b, c)

    W = SAMPLER_WINDOW
    c_w = im["c_up"][:, :W].contiguous()
    z_w = im["z"][:, :W].contiguous()
    y_k = wk.sample(prog.sampler_params, cfg, c_w, z_w,
                    kernel_weights=prog.sampler_kernel)
    y_p = wk.sample_plain(prog.sampler_params, cfg, c_w, z_w)
    torch.cuda.synchronize()
    y_k, y_p = y_k.cpu().numpy(), y_p.cpu().numpy()
    smp_err = float(np.abs(y_k - y_p).max())
    print(f"sampler: max |kernel - plain| over the first {W} samples "
          f"{smp_err:.3e}; kernel equals the serve run's samples: "
          f"{bool(np.array_equal(y_k, samples[:, :W]))}")
    # f32 weights and sums on both sides, different summation order; each
    # sample feeds back, so allow 1e-3 on samples in [-1, 1].
    assert smp_err <= 1e-3, smp_err
    assert np.array_equal(y_k, samples[:, :W]), "kernel is not deterministic"
    done(5, t0)

    # ---- 6. times and bounds
    t0 = phase(6, "time kernels and plain versions")
    dec_ms = cuda_ms(lambda: dk.decode(
        *dargs, **dkw, kernel_weights=prog.dec_kernel), 3)
    dec_plain_ms = cuda_ms(lambda: dk.decode_plain(*dargs, **dkw), 1)
    smp_ms = cuda_ms(lambda: wk.sample(prog.sampler_params, cfg, c_w, z_w,
                                       kernel_weights=prog.sampler_kernel), 3)
    smp_plain_ms = cuda_ms(
        lambda: wk.sample_plain(prog.sampler_params, cfg, c_w, z_w), 1)

    # decoder bound: each input read once, the output written once, and
    # the operations of the steps each row runs under the early-stop rule
    dp = prog.dec_params
    T, M = im["memory"].shape[1:]
    U, P, mels = tc.decoder_lstm_units, tc.prenet_layers[-1], cfg.audio.num_mels
    A, KW = dp.wq.shape[1], dp.loc_k.shape[0]
    FO = r * mels + r
    steps_run = sum(run for _, run in fk)
    w_bytes = sum(t.numel() * t.element_size() for t in dp)
    d_bytes = (w_bytes + sum(im[k].numel() * 4 for k in ("keys", "memory",
                                                          "mask"))
               + steps_run * 2 * P * 4 + B * MAX_STEPS * FO * 4)
    mac_bf16 = (mels * P + P * P + (P + M + U) * 4 * U + 2 * U * 4 * U
                + U * A + (U + M) * FO)
    op_f32 = T * A * (2 * KW + 4) + 2 * T * M + 6 * T + 20 * U
    d_ops_s = steps_run * (2 * mac_bf16 / BF16_FLOPS + op_f32 / F32_FLOPS)
    d_bytes_s = d_bytes / HBM_BYTES_PER_S

    # sampler bound over the timed window
    wn = cfg.wavenet
    R, G, S, C = (wn.residual_channels, wn.gate_channels,
                  wn.skip_out_channels, wn.cin_channels)
    s_w_bytes = sum(t.numel() * 4 for t in (
        prog.sampler_params.first_w, prog.sampler_params.first_b,
        prog.sampler_params.final1_w, prog.sampler_params.final1_b,
        prog.sampler_params.final2_w, prog.sampler_params.final2_b))
    s_w_bytes += sum(t.numel() * 4 for lp in prog.sampler_params.layers
                     for t in lp)
    s_bytes = s_w_bytes + B * W * (C + 1 + 1) * 4
    s_flops = B * W * 2 * (wn.layers * ((3 * R + C) * G + (G // 2) * (S + R))
                           + S * S + S * 2)
    s_ops_s = s_flops / F32_FLOPS
    s_bytes_s = s_bytes / HBM_BYTES_PER_S

    kernels = [
        {"name": "tacotron_decoder", "route": "cuda",
         "source": "tacotron2_tpu_torch/csrc/decoder.cu",
         "replaces": "tacotron2_tpu/ops/tacotron_decoder_kernel.py:842",
         "launches": launches["tacotron_decoder"], "max_abs_err": dec_err,
         "ms": dec_ms, "plain_ms": dec_plain_ms,
         "bound_ms": 1e3 * max(d_ops_s, d_bytes_s),
         "bound_by": "operations" if d_ops_s >= d_bytes_s else "bytes",
         "library_ms": None},
        {"name": "wavenet_sampler", "route": "cuda",
         "source": "tacotron2_tpu_torch/csrc/sampler.cu",
         "replaces": "tacotron2_tpu/ops/wavenet_kernel.py:180",
         "launches": launches["wavenet_sampler"], "max_abs_err": smp_err,
         "ms": smp_ms, "plain_ms": smp_plain_ms,
         "bound_ms": 1e3 * max(s_ops_s, s_bytes_s),
         "bound_by": "operations" if s_ops_s >= s_bytes_s else "bytes",
         "library_ms": None},
    ]
    print(f"decoder timed on the serve inputs: B={B}, T_in={T}, "
          f"{MAX_STEPS} steps, {steps_run} row-steps run; sampler timed "
          f"on the first {W} samples of the serve inputs, B={B}")
    done(6, t0)
    print(f"total {time.time() - t_start:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
