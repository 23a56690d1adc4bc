"""Where the time of one serve call goes, stage by stage, on one CUDA GPU.

    python scripts/profile_torch_serve.py

Builds the program chip_smoke.py builds (r5 checkpoints, 8 held-out texts,
t_in 128, 480 decode steps), runs one warm-up call, then runs the stages of
`TextToWavProgram._forward` one by one on the same inputs with a CUDA event
around each: memory pass, decode kernel, postnet + stop-length + silence
mask + rescale, upsample, sampler kernel over the full length (the
program's bf16 cache and weights, then f32 for comparison); and the
load-time re-layout of each kernel's weights (`pack_weights`), which the
program does once when it is built. The Griffin-Lim route
(`TextToWavProgram(vocoder="griffin_lim")`) shares the stages up to the
silence mask and then inverts the masked mel through the Griffin-Lim
kernel (`griffin_lim` stage). Prints one JSON line with each stage's
milliseconds and, for a call of each program, the device's busy share
from a torch.profiler trace (the sum of the CUDA kernels' times over the
wall time), or null where the profiler reports no device time.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from tacotron2_tpu_torch.convert import load_checkpoints
    from tacotron2_tpu_torch.models.tacotron.decoder import drop_masks
    from tacotron2_tpu_torch.ops import griffin_lim as gl
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
    from tacotron2_tpu_torch.text import text_to_sequence

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.r5_config()
    au, tc = cfg.audio, cfg.tacotron
    B, dev = len(cs.HELD_ROWS), "cuda"
    tp, st, wp = load_checkpoints(os.path.join(cs.R5, "taco_ckpt.msgpack"),
                                  os.path.join(cs.R5, "wn_ckpt.msgpack"))
    prog = TextToWavProgram(cfg, tp, st, wp, batch=B, steps=cs.MAX_STEPS,
                            t_in=cs.T_IN, device=dev, seed=1234)
    held = cs.held_out_texts()
    seqs = [text_to_sequence(held[i - 128], cfg.data.cleaners)
            for i in cs.HELD_ROWS]
    ids = np.zeros((B, cs.T_IN), np.int64)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
    lens = np.asarray([len(s) for s in seqs])
    refs = np.stack([
        np.load(os.path.join(cs.R5, "corpus", "mels", f"mel-{i}.npy"))
        [:cs.T_REF] for i in cs.HELD_ROWS]).astype(np.float32)
    prog(ids, lens, refs, refs)                      # warm-up
    torch.cuda.synchronize()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def busy_share(program):
        """(wall ms, device busy share) of one profiled call."""
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            program(ids, lens, refs, refs)
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
        return wall_ms, (dev_us / 1e3 / wall_ms if dev_us else None)

    wall_ms, busy = busy_share(prog)
    prog_gl = TextToWavProgram(cfg, tp, st, None, batch=B,
                               steps=cs.MAX_STEPS, t_in=cs.T_IN,
                               t_ref=cs.T_REF, device=dev,
                               vocoder="griffin_lim")
    prog_gl(ids, lens, refs, refs)                   # warm-up
    torch.cuda.synchronize()
    gl_wall_ms, gl_busy = busy_share(prog_gl)

    ms = {}

    def stage(name, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        ms[name] = a.elapsed_time(b)
        return out

    t = lambda x, dt=None: torch.as_tensor(x, device=dev, dtype=dt)
    g = torch.Generator(dev).manual_seed(1)
    with torch.no_grad():
        # load-time work, done once when the program is built
        stage("decoder_pack_weights", lambda: dk.pack_weights(prog.dec_params))
        stage("sampler_pack_weights", lambda: wk.pack_weights(
            prog.sampler_params, cfg, cache_dtype=prog.cache_dtype,
            weight_dtype=prog.weight_dtype))
        kw32 = wk.pack_weights(prog.sampler_params, cfg)
        keys, mem, mask, _, _ = stage("memory_pass", lambda: (
            prog.taco.synthesis_memory_ext(t(ids), t(lens), t(refs),
                                           t(refs))))
        drop = drop_masks(cfg, B, cs.MAX_STEPS, g, dev)
        frames, stops, _ = stage("decode_kernel", lambda: dk.decode(
            prog.dec_params, cfg, keys, mem, mask, drop,
            steps=cs.MAX_STEPS, early_stop_block=tc.early_stop_block,
            emit_alignments=False, kernel_weights=prog.dec_kernel))

        def tail():
            _, mel = prog.taco.postnet_pass(frames)
            fired = stops >= 0.5
            first = torch.argmax(fired.float(), dim=1)
            n = torch.where(fired.any(1), first,
                            torch.full_like(first, prog.frames))
            n = torch.clamp(n, min=tc.outputs_per_step)
            idx = torch.arange(prog.frames, device=dev)[None, :, None]
            lo = -au.max_abs_value
            mel = torch.where(idx < n[:, None, None], mel,
                              torch.full_like(mel, lo))
            return mel, (torch.clamp(mel, lo, au.max_abs_value) - lo) / (
                au.max_abs_value - lo)
        mel, c = stage("postnet_mask_rescale", tail)
        stage("griffin_lim", lambda: gl.inv_mel_spectrogram(mel, au))
        c_up = stage("upsample", lambda: prog.wavenet.upsample(c))
        z = torch.randn(B, prog.t_audio, generator=g, device=dev)
        stage("sampler_kernel", lambda: wk.sample(
            prog.sampler_params, cfg, c_up, z,
            kernel_weights=prog.sampler_kernel))
        stage("sampler_kernel_f32", lambda: wk.sample(
            prog.sampler_params, cfg, c_up, z, kernel_weights=kw32))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "batch": B, "t_audio": prog.t_audio,
                      "sampler_dtypes": [str(prog.cache_dtype),
                                         str(prog.weight_dtype)],
                      "stage_ms": ms, "profiled_call_wall_ms": wall_ms,
                      "device_busy_share": busy,
                      "griffin_lim_program": {
                          "profiled_call_wall_ms": gl_wall_ms,
                          "device_busy_share": gl_busy}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
