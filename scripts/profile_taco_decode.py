"""Where the decode's step goes: the clock cycles of each phase of a step
of csrc/decoder_rows.cu (built with -DTACO_ROWS_PROFILE, which has thread
0 of the first CTA add up each phase's cycles), in µs a step, on
chip_smoke.py's serve inputs (the r5 weights, the memory pass of the 8
held-out texts, B 8, T_in 128), one launch of 320 steps without early
stop, bf16 and f32 decode weights. Needs one CUDA device and nvcc:

    python scripts/profile_taco_decode.py [--teacher-forced]

With --teacher-forced, the teacher-forced train mode (kernel 4a) instead,
at chip_smoke.py phase 16's shapes (the first train batch, B 16, T_in 96,
one launch of 448 steps, tfr-0.5 coins, seeded dropout and zoneout masks),
bf16 and f32 train weights: its prenet phase includes the teacher frame's
write, and each phase its residual writes.

The phases end at the step's barriers: a phase's time includes its wait
for the slowest warp, and A-D the cluster barriers' waits. The measuring
build keeps more registers live than the kernel the port runs; it prints
its own total beside the plain build's time of the same launch.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("prenet", "L1 and its cells", "barrier A", "h1 gather",
          "L2 and its cells", "wq", "barrier B", "h2 gather, q sum",
          "energies", "barrier C", "softmax", "context", "proj", "barrier D",
          "ctx gather, proj sum", "outputs")
STEPS = 320


def main(argv):
    sys.path.insert(0, REPO)
    sys.path.insert(1, os.path.join(REPO, "scripts"))
    import torch

    import chip_smoke as cs
    from time_torch_kernels import _serve_inputs, _train_inputs
    from tacotron2_tpu_torch.native import build
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk

    teacher_forced = argv == ["--teacher-forced"]
    if teacher_forced:
        cfg, dp32, keys, mem, mask, teacher, coins, drop, zmask = \
            _train_inputs(REPO, cs.TRAIN_BATCH)
        steps = teacher.shape[0]
    else:
        cfg, (tp, _, _), _, keys, mem, mask, drop, _ = _serve_inputs(REPO)
        steps = STEPS
    B, T, M = mem.shape
    plain_so = build.build(["decoder_rows"])["decoder_rows"]
    so = os.path.join(tempfile.mkdtemp(), "decoder_rows_profile.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                    "-DTACO_ROWS_PROFILE", "-o", so,
                    os.path.join(build.CSRC, "decoder_rows.cu")], check=True,
                   capture_output=True)
    ghz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0]) / 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    d_s = drop[:, :steps].contiguous()
    empty = torch.empty
    scratch = {}

    def keep_scratch(*a, **k):   # the launch's scratch holds the cycles
        x = empty(*a, **k)
        if k.get("dtype") == torch.uint8:
            scratch["x"] = x
        return x

    for wd in ("bfloat16", "float32"):
        cfg_w = cfg.with_overrides(f"tacotron.fused_decoder_dtype={wd}")
        if teacher_forced:
            with torch.no_grad():
                dp = tk.cast_params(dp32, getattr(torch, wd))
            kw = dk.pack_weights(dp)
            run = lambda: tk.teacher_forced_train_fwd(
                dp, cfg_w, keys, mem, mask, teacher, coins, d_s, zmask,
                kernel_weights=kw)
        else:
            dp = dk.extract_decoder_params(tp, cfg_w, device="cuda")
            kw = dk.pack_weights(dp)
            run = lambda: dk.decode(dp, cfg_w, keys, mem, mask, d_s,
                                    steps=steps, early_stop_block=0,
                                    emit_alignments=False,
                                    kernel_weights=kw)
        times = {}
        for name, lib in (("plain", plain_so), ("profile", so)):
            build._libs["decoder_rows"] = ctypes.CDLL(lib)
            dk._rows_argtypes_set = False
            run()
            torch.empty = keep_scratch
            try:
                times[name] = cs.cuda_ms(run, 1)
            finally:
                torch.empty = empty
        cycles = scratch["x"][:8 * len(PHASES)].view(torch.int64).tolist()
        us = {n: round(c / steps / (ghz * 1e3), 3)
              for n, c in zip(PHASES, cycles)}
        plan = dk.rows_plan(dk.rows_widths(cfg_w, M, T), kw.rows.cs,
                            wd == "float32")
        print(json.dumps({"mode": ("teacher-forced train" if teacher_forced
                                   else "autoregressive"),
                          "weights": wd, "B": B, "T_in": T, "steps": steps,
                          "cs": kw.rows.cs, "plan": plan,
                          "ms": times["plain"],
                          "profile_build_ms": times["profile"],
                          "us_a_step": us,
                          "total_us_a_step": round(sum(us.values()), 3)}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
