#!/usr/bin/env python3
"""WaveNet training from a fresh init at the r5 shapes, by route: the loss
and gradient norm of each of 48 steps through the fused stack (kernels 5a
and 5b, bf16), the layer loop in bf16 and the layer loop in f32 (no stack
kernel; cuDNN and autograd), on the same batches, init and dropout seeds
as chip_smoke.py's phase 19. Shows whether a swing of the loss is the
kernels' or the model's. Needs a CUDA device:

    python3 scripts/wavenet_train_trajectories.py
"""

import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(steps: int = 48):
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from tacotron2_tpu_torch.native import build
    from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer
    build.build(["wavenet_train"])
    print(torch.cuda.get_device_name(0))
    pairs = cs.r5_wavenet_rows(os.path.join(cs.R5, "corpus"), cs.WN_ROWS)
    rng = np.random.default_rng(cs.SEED)
    F = cs.WN_CROP_FRAMES

    def crops():
        return cs.wavenet_batch(pairs, [int(rng.integers(0, len(m) - F + 1))
                                        for _, m in pairs])

    first = crops()
    batches = [crops() for _ in range(steps)]
    for fused, dt in ((True, "bfloat16"), (False, "bfloat16"),
                      (False, "float32")):
        cfg = cs.r5_config()
        cfg = cfg.replace(wavenet=dataclasses.replace(
            cfg.wavenet, use_fused_train_stack=fused, compute_dtype=dt))
        trainer = WaveNetTrainer(cfg)
        state = trainer.init_state(torch.Generator().manual_seed(cs.SEED),
                                   first)
        gen = torch.Generator().manual_seed(cs.SEED + 1)
        out = []
        t0 = time.time()
        for b in batches:
            state, m = trainer.train_step(state, b, gen)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        print(f"fused stack {fused}, {dt}: {time.time() - t0:.2f} s")
        print("  loss " + " ".join(f"{x:.3f}" for x, _ in out))
        print("  grad_norm " + " ".join(f"{g:.1f}" for _, g in out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
