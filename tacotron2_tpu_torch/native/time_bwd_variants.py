"""Time variants of the teacher-forced backward kernel
(tacotron2_tpu_torch/csrc/decoder_bwd.cu) against each other on one GPU.

    python -m tacotron2_tpu_torch.native.time_bwd_variants [--work DIR]

Each variant is a copy of the package under DIR (default scratch_chip/,
git-ignored) whose decoder_bwd.cu differs from the checkout's by one
textual edit: `current` (as checked in), `rowdot_inline` (the row-dot
helper inlined at its six calls), `rows4` / `rows16` (weight rows a warp
keeps in flight), `lstm_bwd_noinline`. Each runs in its own process,
builds its kernels, runs the train forward kernel at the r5 training
shapes (B 16, T_in 96, 448 steps, default widths, random weights and
inputs from seed 0) and times the backward kernel on its residuals (the
median of 5 CUDA-event timings); the variants go in turns, forward then
backward through the list. Prints the card's name and power limit, each
variant's ptxas register and spill report, its time, and a checksum of
its gate gradients, which must agree across variants.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NOINLINE = "__device__ __noinline__ void rowdot("
VARIANTS = {
    "current": lambda s: s,
    "rowdot_inline": lambda s: s.replace(NOINLINE, "__device__ void rowdot("),
    "rows4": lambda s: s.replace("constexpr int ROWS = 8;",
                                 "constexpr int ROWS = 4;"),
    "rows16": lambda s: s.replace("constexpr int ROWS = 8;",
                                  "constexpr int ROWS = 16;"),
    "lstm_bwd_noinline": lambda s: s.replace(
        "__device__ void lstm_bwd(", "__device__ __noinline__ void lstm_bwd("),
}

CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.models.tacotron.decoder import (Decoder, drop_masks,
                                                         zoneout_masks)
from tacotron2_tpu_torch.native import build
from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
build.build(["decoder", "decoder_bwd"])
report = [l.strip() for l in build.build_logs.get("decoder_bwd", "")
          .splitlines() if "spill" in l or "registers" in l]
cfg, dev = Config(), torch.device("cuda")
g = torch.Generator().manual_seed(0)
B, T, S, M = 16, 96, 448, 1024
dec = Decoder(cfg, M)
with torch.no_grad():
    for p in dec.parameters():
        p.copy_(torch.randn(p.shape, generator=g) / max(1, p.shape[0]) ** 0.5)
dp = tk.cast_params(tk.extract_params_traced(dec.to(dev), cfg),
                    torch.bfloat16)
kw = dk.pack_weights(dp)
keys = torch.randn(B, T, 128, generator=g).to(dev) * 0.3
memory = torch.randn(B, T, M, generator=g).to(dev) * 0.3
mask = torch.ones(B, T, dtype=torch.bool, device=dev)
teacher = torch.randn(S, B, 80, generator=g).to(dev)
coins = torch.ones(S, dtype=torch.int32)
gd = torch.Generator(device=dev).manual_seed(1)
drop, zm = drop_masks(cfg, B, S, gd, dev), zoneout_masks(cfg, B, S, gd, dev)
*_, res = tk.teacher_forced_train_fwd(dp, cfg, keys, memory, mask, teacher,
                                      coins, drop, zm, kernel_weights=kw)
dout = torch.randn(B, S, 81, generator=g).to(dev) * 1e-3
dal = torch.randn(B, S, T, generator=g).to(dev) * 1e-3
args = (dp, cfg, res, keys, memory, mask, coins, drop, zm, dout, dal)
out = tk.teacher_forced_bwd(*args, kernel_weights=kw)
ms = []
for _ in range(5):
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    tk.teacher_forced_bwd(*args, kernel_weights=kw)
    e1.record()
    torch.cuda.synchronize()
    ms.append(e0.elapsed_time(e1))
print(json.dumps({"ms": sorted(ms)[2], "report": report,
                  "checksum": float(out["dz1"].double().abs().sum())}))
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=os.path.join(ROOT, "scratch_chip"))
    work = ap.parse_args().work
    src = os.path.join(ROOT, "tacotron2_tpu_torch")
    base = open(os.path.join(src, "csrc", "decoder_bwd.cu")).read()
    roots = {}
    for name, edit in VARIANTS.items():
        text = edit(base)
        if name != "current" and text == base:
            raise SystemExit(f"variant {name}: the edit matched nothing")
        root = os.path.join(work, f"bwd_{name}")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(src, os.path.join(root, "tacotron2_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        with open(os.path.join(root, "tacotron2_tpu_torch", "csrc",
                               "decoder_bwd.cu"), "w") as f:
            f.write(text)
        roots[name] = root
    child = os.path.join(work, "time_decoder_bwd_child.py")
    with open(child, "w") as f:
        f.write(CHILD)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    names = list(VARIANTS)
    for name in names + names[::-1]:
        r = subprocess.run([sys.executable, child, roots[name]],
                           capture_output=True, text=True)
        lines = [x for x in r.stdout.splitlines() if x.startswith("{")]
        if r.returncode or not lines:
            raise SystemExit(f"variant {name} failed:\n{r.stderr[-3000:]}")
        print(name, json.loads(lines[-1]), flush=True)


if __name__ == "__main__":
    main()
