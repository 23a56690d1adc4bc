"""How far the Griffin-Lim kernel and its plain version lie from a float64
reconstruction, iteration by iteration.

    python scripts/griffin_lim_accuracy.py

For each input and each iteration count it prints the largest and the
root-mean-square sample difference of kernel vs plain (f32, DFT products),
plain vs float64 and kernel vs float64 (float64: chip_smoke.py's
torch.stft / torch.istft Griffin-Lim in double precision, from the same
start). Inputs, at the r5 audio width (n_fft 2048, hop 200, win 800):
white noise of 33 frames (tests/test_torch_cuda.py's shape) from the
zero-phase and from a random-phase start, and the 8 ground-truth mels of
chip_smoke.py's held-out rows padded to 321 frames (its eval batch's
shape) from the zero-phase start. Needs one CUDA device and
artifacts/e2e_demo_r5.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def report(tag, S, re0, im0, n_fft, hop, win, iters_list, lengths=None):
    import torch

    import chip_smoke as cs
    from tacotron2_tpu_torch.ops import griffin_lim_kernel as glk
    for it in iters_list:
        yk = glk.fused_griffin_lim(S, re0, im0, n_fft, hop, win, it)
        yp = glk.griffin_lim_plain(S, re0, im0, n_fft, hop, win, it)
        yd = cs.library_griffin_lim(S.double(), n_fft, hop, win, it,
                                    re0.double(), im0.double())
        torch.cuda.synchronize()
        d = {"kernel-plain": (yk - yp).double(), "plain-f64": yp - yd,
             "kernel-f64": yk - yd}
        stats = "; ".join(
            f"{k} max {float(v.abs().max()):.3e} rms "
            f"{float(v.pow(2).mean().sqrt()):.3e}" for k, v in d.items())
        b, n = divmod(int(d["kernel-plain"].abs().argmax()), yk.shape[1])
        where = ("" if lengths is None else
                 f"; kernel-plain max at row {b} frame {n // hop} of "
                 f"{lengths[b]} real")
        print(f"{tag} iters {it}: samples up to "
              f"{float(yd.abs().max()):.3e}; {stats}{where}", flush=True)


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from tacotron2_tpu_torch.ops import stft as tst
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    a = cs.r5_config().audio
    hop, win, n_fft = a.hop_size, a.win_size, a.n_fft
    iters_list = (0, 1, 2, 4, 8)
    g = torch.Generator(dev).manual_seed(0)
    y = torch.randn(2, hop * 32, generator=g, device=dev)
    S = tst.stft_mag(y, n_fft, hop, win)
    phase = torch.rand(S.shape, generator=g, device=dev) * 6.2831855
    shape = (n_fft, hop, win, iters_list)
    report("noise [2, 33] zero-phase", S, S, torch.zeros_like(S), *shape)
    report("noise [2, 33] random-phase", S, S * torch.cos(phase),
           S * torch.sin(phase), *shape)
    gt = [np.load(os.path.join(cs.R5, "corpus", "mels", f"mel-{i}.npy"))
          for i in cs.HELD_ROWS]
    F = -(-max(x.shape[0] for x in gt) // 64) * 64 + 1
    batch = np.stack([np.pad(x, ((0, F - x.shape[0]), (0, 0)),
                             constant_values=-a.max_abs_value) for x in gt])
    S = cs.gl_magnitudes(batch.astype(np.float32), a, dev)
    report(f"ground-truth mels [8, {F}] zero-phase", S, S,
           torch.zeros_like(S), *shape, [x.shape[0] for x in gt])
    return 0


if __name__ == "__main__":
    sys.exit(main())
