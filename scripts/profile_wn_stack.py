"""Split the WaveNet training stack's kernels (5a, 5b) by launch kind.

    python scripts/profile_wn_stack.py [PORT_ROOT ...]

Each PORT_ROOT holds a copy of `tacotron2_tpu_torch/` (default: this
repository), each timed in its own process, so two versions can be split
in one call on the same GPU. At chip_smoke.py phase 19's shapes (B 16 crops
of 8,000 samples of the r5 train split, N = 128,000 rows, the r5 EMA
weights, 20 layers), in bf16 and f32 weights: one forward and one backward
pass under `torch.profiler` (`chip_smoke.stack_launch_split`), whose
device times are summed by kernel name over the 20 layers. A version that
launches one weight-gradient kernel a product (the earlier 13-launch
backward, with its `colsum_kernel` and `split_sum_kernel`) is split by
product; the PyTorch operations the wrappers run around the kernels
(padding, casts, slices) are "other". Then, as a diagnostic only, the same
products through `torch.matmul` on operands of the same shapes and type
(TF32 off), a layer's each timed with CUDA events and multiplied by 20: the port never
calls them, and no single PyTorch call computes a layer. Prints one JSON
object a root. Needs one CUDA device.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the earlier 13-launch backward's kernels beside the current ones
OLD_KINDS = ("colsum_kernel", "split_sum_kernel")


def matmul_ms(N, C, G, S, Ci, L, dt):
    """Each product of a layer through torch.matmul, ms × L."""
    import torch
    dev = torch.device("cuda")
    Ch = G // 2
    shapes = {
        "fwd taps+cin [N, 3C+Ci]·[3C+Ci, G]": (N, 3 * C + Ci, G),
        "fwd out|skip [N, Ch]·[Ch, C+S]": (N, Ch, C + S),
        "bwd dh [N, C+S]·[C+S, Ch]": (N, C + S, Ch),
        "bwd dc [N, G]·[G, Ci]": (N, G, Ci),
        "bwd dx [N, 3G]·[3G, C]": (N, 3 * G, C),
        "bwd taps' dW 3 × [C, N]·[N, G]": (C, N, G),
        "bwd cin dW [Ci, N]·[N, G]": (Ci, N, G),
        "bwd out|skip dW [Ch, N]·[N, C+S]": (Ch, N, C + S),
    }
    out = {}
    for name, (m, k, n) in shapes.items():
        a = torch.randn(m, k, device=dev).to(dt)
        b = torch.randn(k, n, device=dev).to(dt)
        torch.matmul(a, b)
        reps = 3 if name.startswith("bwd taps") else 1
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(5 * reps):
            torch.matmul(a, b)
        t1.record()
        torch.cuda.synchronize()
        out[name] = t0.elapsed_time(t1) / 5 * L
        del a, b
    return out


def one(root):
    sys.path.insert(0, root)
    sys.path.insert(1, REPO)
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    import tacotron2_tpu_torch
    from tacotron2_tpu_torch import convert
    from tacotron2_tpu_torch.convert import load_checkpoints
    from tacotron2_tpu_torch.models.wavenet.modules import round_bf16
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer

    assert tacotron2_tpu_torch.__file__.startswith(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, dev = cs.r5_config(), torch.device("cuda")
    _, _, wp = load_checkpoints(os.path.join(cs.R5, "taco_ckpt.msgpack"),
                                os.path.join(cs.R5, "wn_ckpt.msgpack"))
    B, F = len(cs.WN_ROWS), cs.WN_CROP_FRAMES
    pairs = cs.r5_wavenet_rows(os.path.join(cs.R5, "corpus"), cs.WN_ROWS)
    rng = np.random.default_rng(cs.SEED)
    batch = cs.wavenet_batch(pairs, [int(rng.integers(0, len(m) - F + 1))
                                     for _, m in pairs])
    model = convert.wavenet_from_flax(cfg, wp, dev, trainable=True)
    b = WaveNetTrainer(cfg).batch_to_device(batch)
    with torch.no_grad():
        c_up = model.upsample(b["c"])
        x0 = model.input_convolution(round_bf16(b["x"]), round_bf16)
    T = x0.shape[1]
    x2 = x0.transpose(0, 1).reshape(T * B, -1).contiguous()
    c2 = round_bf16(c_up).transpose(0, 1).reshape(T * B, -1).contiguous()
    sp = wtk.StackParams(*(t.detach() for t in wtk.extract_stack_params(
        model.residual_blocks, cfg)))
    g = torch.Generator(dev).manual_seed(0)
    dskip = torch.randn(T * B, cfg.wavenet.skip_out_channels, generator=g,
                        device=dev) * 1e-3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"root": root, "card": smi, "N": T * B}
    wn = cfg.wavenet
    for dt in ("bfloat16", "float32"):
        plan = wtk.make_plan(cfg.replace(wavenet=dataclasses.replace(
            wn, compute_dtype=dt)), B)
        _, ka = wtk.stack_fwd_cuda(plan, sp, x2, c2, cs.SEED)
        kinds = cs.STACK_KINDS + OLD_KINDS
        fwd = cs.stack_launch_split(
            lambda: wtk.stack_fwd_cuda(plan, sp, x2, c2, cs.SEED), kinds)
        bwd = cs.stack_launch_split(
            lambda: wtk.stack_bwd_cuda(plan, sp, ka, c2, dskip, cs.SEED),
            kinds, by_product=True)
        out[dt] = {
            "fwd": fwd, "bwd": bwd,
            "fwd_total_ms": sum(v[0] for v in fwd.values()),
            "bwd_total_ms": sum(v[0] for v in bwd.values()),
            "torch_matmul_ms_x20": matmul_ms(
                T * B, wn.residual_channels, wn.gate_channels,
                wn.skip_out_channels, wn.cin_channels, plan.L,
                torch.bfloat16 if dt == "bfloat16" else torch.float32)}
        del ka
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        one(os.path.abspath(argv[1]))
        return 0
    for root in argv or [REPO]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
