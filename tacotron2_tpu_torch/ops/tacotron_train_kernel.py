"""The teacher-forced Tacotron decode, eval mode, as a CUDA kernel.

Port of tacotron2_tpu/ops/tacotron_train_kernel.py's `build_train_fwd`
(:118, pallas_call at :325) with `train_zoneout=False`, as
`_fused_teacher_forced_fn` (models/tacotron/decoder.py:183-221) runs it for
GTA synthesis and `embed`: frames and stop logits, and the alignments.
The per-step residuals feed only the backward, which JAX drops in eval
(:207-217); they come with Tacotron training, as do the Bernoulli zoneout
and `build_train_bwd`.

- `teacher_forced_fwd` launches the teacher-forced mode of
  `csrc/decoder.cu` (`decoder_kernel<true>`, its note has the design) for
  CUDA tensors, all steps in one launch, and raises if it cannot;
- `teacher_forced_fwd_plain` is its plain version,
  `models/tacotron/decoder.py:teacher_forced`; CPU tensors take it.

The weights are `ops/tacotron_decoder_kernel.py`'s: `extract_params` casts
them to `tacotron.fused_train_dtype` (bf16 by default; the kernel takes
bf16, the plain version either) and `pack_weights` lays them out for the
cluster once. With bf16 weights both round every activation to bf16
where it enters a product and sum in f32, as `build_train_fwd` does.
Prenet dropout arrives as multipliers drawn by the caller
(`models/tacotron/decoder.py:drop_masks`).

On a CUDA device the kernel runs whatever `use_fused_train_decoder` says:
that flag chooses between two TPU implementations of one function (the
Pallas kernel or the flax scan), as `use_fused_decoder` does for the
autoregressive decode, which the port ignores alike. What the JAX dispatch
sends to the scan instead (`decoder.py:312-315`: `emt_attn`, smoothing
attention, unequal prenet widths) the port refuses.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..models.tacotron.decoder import (DecoderParams, init_decoder_state,
                                      round_bf16, teacher_forced)
from . import tacotron_decoder_kernel as dk

# kernel launches made by `teacher_forced_fwd` (the count a run reads to
# show that its main path went through the CUDA kernel)
launches = 0


def train_weight_dtype(cfg: Config) -> torch.dtype:
    return (torch.bfloat16 if cfg.tacotron.fused_train_dtype == "bfloat16"
            else torch.float32)


def check_config(cfg: Config) -> None:
    """Raise on what the teacher-forced decode does not take."""
    tc = cfg.tacotron
    P = tc.prenet_layers[-1]
    if cfg.gst.emt_attn:
        raise ValueError("the teacher-forced decode has no emt_attn scorers")
    if tc.smoothing:
        raise ValueError("the teacher-forced decode takes softmax attention "
                         "only, not smoothing")
    if tuple(tc.prenet_layers) != (P, P):
        raise ValueError("the teacher-forced decode takes two prenet layers "
                         f"of equal width, not {tuple(tc.prenet_layers)}")


def extract_params(params, cfg: Config, *, device="cuda") -> DecoderParams:
    """Flax Tacotron params -> DecoderParams in the train weight dtype."""
    check_config(cfg)
    return dk.extract_decoder_params(params, cfg, device=device,
                                     weight_dtype=train_weight_dtype(cfg))


def teacher_forced_fwd_plain(dp: DecoderParams, cfg: Config, keys, memory,
                             mask, teacher, coins, drop):
    """The kernel's plain PyTorch version (same contract as
    `teacher_forced_fwd`)."""
    check_config(cfg)
    return teacher_forced(dp, cfg, keys, memory, mask, teacher, coins, drop)


def teacher_forced_fwd(dp: DecoderParams, cfg: Config, keys, memory, mask,
                       teacher, coins, drop, *,
                       kernel_weights: dk.KernelWeights | None = None):
    """Teacher-forced decode of steps = teacher.shape[0] steps. keys [B, T,
    A], memory [B, T, M], mask [B, T], teacher [steps, B, mels], coins
    [steps] (1: step t takes teacher[t]), drop [B, steps, 2, P]. Returns
    (frames [B, steps*r, mels], stop logits [B, steps*r], alignments [B, T,
    steps]). CPU tensors take the plain version with `dp`; CUDA tensors
    launch the kernel with `kernel_weights` (`dk.pack_weights(dp)`) or
    raise."""
    check_config(cfg)
    if memory.device.type == "cpu":
        return teacher_forced(dp, cfg, keys, memory, mask, teacher, coins,
                              drop)
    if kernel_weights is None:
        raise ValueError("the teacher-forced kernel takes kernel_weights="
                         "pack_weights(dp), built once per set of weights")
    return _teacher_forced_cuda(kernel_weights, cfg, keys, memory, mask,
                                teacher, coins, drop)


def _teacher_forced_cuda(kw: dk.KernelWeights, cfg: Config, keys, memory,
                         mask, teacher, coins, drop):
    global launches
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r, P = tc.outputs_per_step, tc.prenet_layers[-1]
    B, T, M = memory.shape
    dev = memory.device
    steps = teacher.shape[0]
    if steps < 1 or teacher.shape != (steps, B, mels) or teacher.device != dev:
        raise ValueError(f"teacher must be [steps, B, mels] on {dev}, got "
                         f"{tuple(teacher.shape)} on {teacher.device}")
    if coins.shape != (steps,):
        raise ValueError(f"coins must be [{steps}], got {tuple(coins.shape)}")
    if drop.shape != (B, steps, 2, P) or drop.device != dev:
        raise ValueError(f"drop must be [B, steps, 2, P] on {dev}")
    # the memory and the location taps enter their products in bf16, as
    # in the TPU kernel; the kernel rounds the activations itself
    kw = kw._replace(wp=round_bf16(kw.wp))
    L = dk.prepare_launch(kw, cfg, keys, round_bf16(memory), mask,
                          teacher_forced=True)
    state = dk.pack_state(init_decoder_state(cfg, B, T, M, dev), P, kw.cs)
    out = torch.empty(B, steps, r * mels + r, device=dev)
    align = torch.empty(B, steps, T, device=dev)
    dk.launch(L, cfg, drop.to(torch.float32).contiguous(), state, state, out,
              align, None, None, t0=0, nsteps=steps, s_total=steps,
              teacher=teacher.to(torch.float32).contiguous(),
              coins=coins.to(device=dev, dtype=torch.int32).contiguous())
    launches += 1
    return (out[..., :r * mels].reshape(B, steps * r, mels),
            out[..., r * mels:].reshape(B, steps * r), align.transpose(1, 2))
