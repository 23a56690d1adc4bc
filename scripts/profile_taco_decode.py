"""Where the serve decode's step goes: the clock cycles of each phase of a
step of csrc/decoder_rows.cu (built with -DTACO_ROWS_PROFILE, which has
thread 0 of the first CTA add up each phase's cycles), in µs a step, on
chip_smoke.py's serve inputs (the r5 weights, the memory pass of the 8
held-out texts, B 8, T_in 128), one launch of 320 steps without early
stop, bf16 and f32 decode weights. Needs one CUDA device and nvcc:

    python scripts/profile_taco_decode.py

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


def main():
    sys.path.insert(0, REPO)
    sys.path.insert(1, os.path.join(REPO, "scripts"))
    import torch

    import chip_smoke as cs
    from time_torch_kernels import _serve_inputs
    from tacotron2_tpu_torch.native import build
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk

    cfg, (tp, _, _), _, keys, mem, mask, drop, _ = _serve_inputs(REPO)
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
    d320 = drop[:, :STEPS].contiguous()
    empty = torch.empty
    scratch = {}

    def keep_scratch(*a, **k):   # the launch's scratch holds the cycles
        x = empty(*a, **k)
        if k.get("dtype") == torch.uint8:
            scratch["x"] = x
        return x

    for wd in ("bfloat16", "float32"):
        cfg_w = cfg.with_overrides(f"tacotron.fused_decoder_dtype={wd}")
        dp = dk.extract_decoder_params(tp, cfg_w, device="cuda")
        kw = dk.pack_weights(dp)
        run = lambda: dk.decode(dp, cfg_w, keys, mem, mask, d320,
                                steps=STEPS, early_stop_block=0,
                                emit_alignments=False, kernel_weights=kw)
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
        us = {n: round(c / STEPS / (ghz * 1e3), 3)
              for n, c in zip(PHASES, cycles)}
        plan = dk.rows_plan(dk.rows_widths(cfg_w, M, T), kw.rows.cs,
                            wd == "float32")
        print(json.dumps({"weights": wd, "B": B, "T_in": T, "steps": STEPS,
                          "cs": kw.rows.cs, "plan": plan,
                          "ms": times["plain"],
                          "profile_build_ms": times["profile"],
                          "us_a_step": us,
                          "total_us_a_step": round(sum(us.values()), 3)}),
              flush=True)


if __name__ == "__main__":
    main()
