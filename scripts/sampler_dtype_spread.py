"""How far the sampler kernel's draws lie from its plain version's, next to
how far the plain version lies from itself, for each cache and weight dtype.

    python scripts/sampler_dtype_spread.py

For random weights (chip_smoke.py's `random_wavenet_tree`, SEED) of the
`paper` preset's mixture-of-logistics WaveNet (20 layers; without and with
the legacy √0.5 scalings; 4 layers) and of the default Gaussian WaveNet,
runs the kernel over 256 samples of 8 rows, then replays its trajectory
through the plain version on the GPU and on the CPU (same inputs, sums in
other orders) and prints, per dtype pair: the largest sample difference
kernel-GPU, GPU-CPU and kernel-CPU, the largest logit difference GPU-CPU,
and for MoL the draws that differ by more than 2e-3 kernel-GPU and GPU-CPU.
Needs one CUDA device.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import torch

    import chip_smoke as cs
    from tacotron2_tpu_torch.config import get_config
    from tacotron2_tpu_torch.models.wavenet.distributions import draw_noise
    from tacotron2_tpu_torch.models.wavenet.sampler import \
        extract_sampler_params
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk

    torch.backends.cuda.matmul.allow_tf32 = False
    B, W, dev = 8, 256, "cuda"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    cases = [("paper MoL, 20 layers", "paper", ""),
             ("paper MoL, 20 layers, legacy scalings", "paper",
              "wavenet.legacy=true,wavenet.residual_legacy=true"),
             ("paper MoL, 4 layers", "paper", "wavenet.layers=4"),
             ("default Gaussian, 20 layers", "default", "")]
    f32, bf16 = torch.float32, torch.bfloat16
    for label, preset, over in cases:
        cfg = get_config(preset, over)
        sp = extract_sampler_params(cs.random_wavenet_tree(cfg, cs.SEED),
                                    cfg, device=dev)
        g = torch.Generator(dev).manual_seed(3)
        c_up = torch.rand(B, W, cfg.wavenet.cin_channels, generator=g,
                          device=dev)
        noise = draw_noise(cfg, B, W, g, dev)
        for cd, wd in ((f32, f32), (bf16, f32), (f32, bf16), (bf16, bf16)):
            dts = dict(cache_dtype=cd, weight_dtype=wd)
            y_k = wk.sample(sp, cfg, c_up, noise,
                            kernel_weights=wk.pack_weights(sp, cfg, **dts))
            y_g, h_g = wk.teacher_forced_replay(sp, cfg, c_up, noise, y_k,
                                                **dts)
            y_c, h_c = wk.teacher_forced_replay(
                cs.to_cpu(sp), cfg, c_up.cpu(), noise.cpu(), y_k.cpu(),
                **dts)
            y_c, h_c = y_c.to(dev), h_c.to(dev)
            d = lambda a, b: float((a - b).abs().max())
            msg = (f"{label}, cache {str(cd)[6:]}, weights {str(wd)[6:]}: "
                   f"samples kernel-GPU {d(y_k, y_g):.3e} GPU-CPU "
                   f"{d(y_g, y_c):.3e} kernel-CPU {d(y_k, y_c):.3e}; logits "
                   f"GPU-CPU {d(h_g, h_c):.3e}")
            if cfg.wavenet.out_channels > 2:
                n = lambda a, b: int(((a - b).abs() > 2e-3).sum())
                msg += (f"; draws apart by > 2e-3 of {B * W}: kernel-GPU "
                        f"{n(y_k, y_g)} GPU-CPU {n(y_g, y_c)}")
            print(msg, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
