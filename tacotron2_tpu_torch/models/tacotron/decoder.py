"""Tacotron autoregressive decoder (PyTorch, eager).

Counterpart of tacotron2_tpu/models/tacotron/decoder.py: `decoder_step` is
`DecoderCell` (:48) at synthesis — prenet with dropout always on, two
zoneout LSTMs (EMA mix), location-sensitive attention with the window
constraint, fused frame + stop projection with the stop sigmoid — and
`autoregressive` is `Decoder.autoregressive` (:367) run as a Python loop.

This eager loop is the plain version of the CUDA decode kernel
(`ops/tacotron_decoder_kernel.py`, `csrc/decoder.cu`) and follows its
contract exactly:

- prenet dropout comes in as multipliers `drop [B, steps, 2, P]`
  (0 or 1/keep, drawn by the caller), so kernel and plain see the same
  random numbers;
- `early_stop_block=K > 0` applies the TPU kernel's block rule per row:
  after each K steps a row whose sticky stop flag has fired (all r stop
  probs > 0.5, or any with `stop_at_any`) stops; its later steps read as
  frames 0 and stop probability 1.0, as the TPU kernel writes skipped steps.
  The TPU kernel stops a block only when every row has fired; per row, the
  rows still decoding are unchanged and a stopped row's tail is what the
  TPU kernel would have written had the whole batch stopped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...config import Config
from .attention import attention_step, fold_location


class DecoderParams(NamedTuple):
    """Matmul-ready decoder weights (JAX `DecoderParams` minus emt_attn).

    Matmul weights carry the decode weight dtype (bf16 or f32); biases and
    attention vectors are f32. `l1_b`/`l2_b` hold the folded forget bias.
    """

    pre_w0: torch.Tensor   # [mels, P]
    pre_b0: torch.Tensor   # [P]
    pre_w1: torch.Tensor   # [P, P]
    pre_b1: torch.Tensor   # [P]
    l1_wp: torch.Tensor    # [P, 4U]
    l1_wc: torch.Tensor    # [M, 4U]
    l1_wh: torch.Tensor    # [U, 4U]
    l1_b: torch.Tensor     # [4U]
    l2_wx: torch.Tensor    # [U, 4U]
    l2_wh: torch.Tensor    # [U, 4U]
    l2_b: torch.Tensor     # [4U]
    wq: torch.Tensor       # [U, A]
    loc_k: torch.Tensor    # [K, F]
    loc_b: torch.Tensor    # [F]
    wloc: torch.Tensor     # [F, A]
    v_a: torch.Tensor      # [A]
    b_a: torch.Tensor      # [A]
    proj_wo: torch.Tensor  # [U, FO]  FO = r*mels + r ([frames | stops])
    proj_wc: torch.Tensor  # [M, FO]
    proj_b: torch.Tensor   # [FO]


def drop_masks(cfg: Config, batch: int, steps: int, generator=None,
               device="cuda") -> torch.Tensor:
    """Prenet dropout multipliers [B, steps, 2, P]: 1/keep where a uniform
    draw is below keep, else 0 (all ones at dropout_rate 0)."""
    tc = cfg.tacotron
    P = tc.prenet_layers[-1]
    keep = 1.0 - float(tc.dropout_rate)
    shape = (batch, steps, 2, P)
    if keep >= 1.0:
        return torch.ones(shape, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    return (u < keep).float() * (1.0 / keep)


def _lstm(z, c, h, zo: float):
    i, j, f, o = z.chunk(4, dim=-1)
    nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(j)
    nh = torch.sigmoid(o) * torch.tanh(nc)
    return (1 - zo) * nc + zo * c, (1 - zo) * nh + zo * h


def stop_fired(stop_probs, stop_at_any: bool):
    """[B, r] stop probabilities -> [B] bool (TacoTestHelper rule)."""
    sp = stop_probs.max(-1).values if stop_at_any else stop_probs.min(-1).values
    return sp > 0.5


def autoregressive(dp: DecoderParams, cfg: Config, keys, memory, mask,
                   steps: int, drop, early_stop_block: int = 0):
    """Free-running decode. keys [B, T, A], memory [B, T, M], mask [B, T]
    (bool or 1/0), drop [B, steps, 2, P]. Returns (frames [B, steps*r,
    mels] f32, stop_probs [B, steps*r] f32)."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r = tc.outputs_per_step
    B, T, _ = memory.shape
    U, zo = tc.decoder_lstm_units, float(tc.zoneout_rate)
    K = int(early_stop_block)
    if K <= 0 or K >= steps:
        K = 0
    dev = memory.device
    w = {k: v.float() for k, v in dp._asdict().items()}
    wp, b_eff = fold_location(dp.loc_k, dp.loc_b, dp.wloc, dp.b_a)
    keys_eff = keys.float() + b_eff
    memory = memory.float()
    maskf = mask.float().to(dev)
    l1_w = torch.cat([w["l1_wp"], w["l1_wc"], w["l1_wh"]], 0)
    l2_w = torch.cat([w["l2_wx"], w["l2_wh"]], 0)
    proj_w = torch.cat([w["proj_wo"], w["proj_wc"]], 0)

    z = lambda *s: torch.zeros(*s, device=dev)
    c1, h1, c2, h2 = z(B, U), z(B, U), z(B, U), z(B, U)
    ctx, cum, xprev = z(B, memory.shape[2]), z(B, T), z(B, mels)
    pmax = torch.zeros(B, dtype=torch.long, device=dev)
    frames_out = z(B, steps, r * mels)
    stops_out = torch.ones(B, steps, r, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    fired = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(steps):
        if K and t % K == 0 and t > 0:
            active = active & ~fired
            if not bool(active.any()):
                break
        hp = torch.relu(xprev @ w["pre_w0"] + w["pre_b0"]) * drop[:, t, 0]
        hp = torch.relu(hp @ w["pre_w1"] + w["pre_b1"]) * drop[:, t, 1]
        c1, h1 = _lstm(torch.cat([hp, ctx, h1], -1) @ l1_w + w["l1_b"],
                       c1, h1, zo)
        c2, h2 = _lstm(torch.cat([h1, h2], -1) @ l2_w + w["l2_b"],
                       c2, h2, zo)
        q = h2 @ w["wq"]
        ctx, _, cum, pmax = attention_step(
            q, keys_eff, memory, maskf, cum, pmax, wp, w["v_a"],
            constraint=tc.synthesis_constraint,
            ctype=tc.synthesis_constraint_type, win=tc.attention_win_size)
        proj = torch.cat([h2, ctx], -1) @ proj_w + w["proj_b"]
        frames, sp = proj[:, :r * mels], torch.sigmoid(proj[:, r * mels:])
        keep = active[:, None]
        frames_out[:, t] = torch.where(keep, frames, frames_out[:, t])
        stops_out[:, t] = torch.where(keep, sp, stops_out[:, t])
        xprev = frames[:, (r - 1) * mels:]
        if K:
            fired = fired | stop_fired(sp, tc.stop_at_any)
    return (frames_out.reshape(B, steps * r, mels),
            stops_out.reshape(B, steps * r))
