"""Tacotron decoder (PyTorch, eager): the autoregressive and the
teacher-forced decode.

Counterpart of tacotron2_tpu/models/tacotron/decoder.py at synthesis:
prenet with dropout always on, two zoneout LSTMs (EMA mix),
location-sensitive attention, fused frame + stop projection.
`decode_block` runs K free-running steps, with the window constraint and
the stop sigmoid, from an explicit `DecoderKernelState`
(Decoder.autoregressive with initial_state / return_state, :367);
`autoregressive` is a loop of blocks. `teacher_forced` is
Decoder.teacher_forced with train=False (:299): each step's input frame
comes from the teacher or the previous step by a per-step coin, no window
constraint, stop logits.

These are the plain versions of the CUDA decode kernel
(`ops/tacotron_decoder_kernel.py`, `ops/tacotron_train_kernel.py`,
`csrc/decoder.cu`) and follow its contract exactly:

- prenet dropout comes in as multipliers `drop [B, steps, 2, P]`
  (0 or 1/keep, drawn by the caller), so kernel and plain see the same
  random numbers;
- `early_stop_block=K` applies the TPU kernel's batch-wide block rule
  (see `autoregressive`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...config import Config
from .attention import attention_step, fold_location, identity


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




class DecoderKernelState(NamedTuple):
    """The decoder's carried state between blocks (JAX
    `DecoderKernelState`, ops/tacotron_decoder_kernel.py:239, without the
    emt_attn context and without the TPU's lane padding)."""

    xprev: torch.Tensor  # [B, mels] f32 last frame of the previous step
    c1: torch.Tensor     # [B, U] f32
    h1: torch.Tensor     # [B, U] f32
    c2: torch.Tensor     # [B, U] f32
    h2: torch.Tensor     # [B, U] f32
    ctx: torch.Tensor    # [B, M] f32 attention context
    cum: torch.Tensor    # [B, T] f32 cumulative alignments
    pmax: torch.Tensor   # [B] int32 previous argmax (window constraint)


def init_decoder_state(cfg: Config, batch: int, T: int, M: int,
                       device="cuda") -> DecoderKernelState:
    """Zero carry for a fresh batch (JAX `init_decoder_state`,
    ops/tacotron_decoder_kernel.py:258)."""
    U, mels = cfg.tacotron.decoder_lstm_units, cfg.audio.num_mels
    z = lambda *s: torch.zeros(*s, device=device)
    return DecoderKernelState(
        xprev=z(batch, mels), c1=z(batch, U), h1=z(batch, U),
        c2=z(batch, U), h2=z(batch, U), ctx=z(batch, M), cum=z(batch, T),
        pmax=torch.zeros(batch, dtype=torch.int32, device=device))


class _Cell(NamedTuple):
    """One decode step's operands, in f32 (weights upcast once), and the
    rounding of a product's inputs (see `_step`)."""

    w: dict
    l1_w: torch.Tensor
    l2_w: torch.Tensor
    proj_w: torch.Tensor
    wp: torch.Tensor
    keys_eff: torch.Tensor
    memory: torch.Tensor
    mask: torch.Tensor
    rnd: object


def round_bf16(x):
    """x rounded to bf16 (to nearest even), kept in f32."""
    return x.to(torch.bfloat16).float()


def _cell(dp: DecoderParams, keys, memory, mask,
          round_inputs: bool = False) -> _Cell:
    w = {k: v.float() for k, v in dp._asdict().items()}
    wp, b_eff = fold_location(dp.loc_k, dp.loc_b, dp.wloc, dp.b_a)
    rnd = round_bf16 if round_inputs else identity
    return _Cell(w, torch.cat([w["l1_wp"], w["l1_wc"], w["l1_wh"]], 0),
                 torch.cat([w["l2_wx"], w["l2_wh"]], 0),
                 torch.cat([w["proj_wo"], w["proj_wc"]], 0), rnd(wp),
                 keys.float() + b_eff, rnd(memory.float()),
                 mask.float().to(memory.device), rnd)


def _step(cell: _Cell, cfg: Config, x, drop_t, state: DecoderKernelState,
          constraint: bool):
    """One decoder step on input frame x [B, mels] with prenet multipliers
    drop_t [B, 2, P]: prenet, both zoneout LSTMs (EMA mix), attention, the
    fused frame + stop projection. Returns (proj [B, r*mels + r] with the
    stop logits last, align [B, T], the state after the step, whose xprev
    is the step's last frame).

    `cell.rnd` rounds every activation where it enters a product — the
    frame, both prenet inputs, the LSTM inputs, the query's and the
    projection's, the cumulative weights of the location features, the
    alignment of the context — as the TPU train kernel does with bf16
    weights (the memory and the location taps are rounded once in
    `_cell`); sums and the carried state stay f32."""
    tc = cfg.tacotron
    r, mels = tc.outputs_per_step, cfg.audio.num_mels
    zo = float(tc.zoneout_rate)
    w, rnd = cell.w, cell.rnd
    _, c1, h1, c2, h2, ctx, cum, pmax = state
    hp = torch.relu(rnd(x) @ w["pre_w0"] + w["pre_b0"]) * drop_t[:, 0]
    hp = torch.relu(rnd(hp) @ w["pre_w1"] + w["pre_b1"]) * drop_t[:, 1]
    c1, h1 = _lstm(rnd(torch.cat([hp, ctx, h1], -1)) @ cell.l1_w
                   + w["l1_b"], c1, h1, zo)
    c2, h2 = _lstm(rnd(torch.cat([h1, h2], -1)) @ cell.l2_w + w["l2_b"],
                   c2, h2, zo)
    ctx, align, cum, pmax = attention_step(
        rnd(h2) @ w["wq"], cell.keys_eff, cell.memory, cell.mask, cum, pmax,
        cell.wp, w["v_a"], constraint=constraint,
        ctype=tc.synthesis_constraint_type, win=tc.attention_win_size,
        rnd=rnd)
    proj = rnd(torch.cat([h2, ctx], -1)) @ cell.proj_w + w["proj_b"]
    xprev = proj[:, (r - 1) * mels:r * mels]
    return proj, align, DecoderKernelState(xprev, c1, h1, c2, h2, ctx, cum,
                                           pmax)


def decode_block(dp: DecoderParams, cfg: Config, keys, memory, mask,
                 state: DecoderKernelState, drop):
    """K = drop.shape[1] free-running steps from `state`. keys [B, T, A],
    memory [B, T, M], mask [B, T] (bool or 1/0), drop [B, K, 2, P].
    Returns (frames [B, K*r, mels], stop_probs [B, K*r], alignments
    [B, T, K], the state after the block), all f32."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r = tc.outputs_per_step
    B = memory.shape[0]
    K = drop.shape[1]
    cell = _cell(dp, keys, memory, mask)
    state = state._replace(pmax=state.pmax.long())
    frames_l, stops_l, aligns_l = [], [], []
    for t in range(K):
        proj, align, state = _step(cell, cfg, state.xprev, drop[:, t], state,
                                   tc.synthesis_constraint)
        frames_l.append(proj[:, :r * mels])
        stops_l.append(torch.sigmoid(proj[:, r * mels:]))
        aligns_l.append(align)
    state = state._replace(pmax=state.pmax.to(torch.int32))
    return (torch.stack(frames_l, 1).reshape(B, K * r, mels),
            torch.stack(stops_l, 1).reshape(B, K * r),
            torch.stack(aligns_l, 2), state)


def autoregressive(dp: DecoderParams, cfg: Config, keys, memory, mask,
                   steps: int, drop, early_stop_block: int = 0,
                   emit_alignments: bool = True):
    """Free-running decode of `steps` steps as a loop of `decode_block`.

    early_stop_block=K (0 < K < steps) applies the TPU kernel's rule
    (tacotron_decoder_kernel.py:1053-1070): every row decodes until the
    first K-step boundary at which every row's sticky stop flag has fired
    (all r stop probs > 0.5, or any with `stop_at_any`); the steps after it
    read as frames 0, stop probability 1.0 and alignments 0. Returns
    (frames [B, steps*r, mels], stop_probs [B, steps*r], alignments
    [B, T, steps] or None)."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r = tc.outputs_per_step
    B, T, M = memory.shape
    K = int(early_stop_block)
    if K <= 0 or K >= steps:
        K = steps
    dev = memory.device
    state = init_decoder_state(cfg, B, T, M, dev)
    frames = torch.zeros(B, steps * r, mels, device=dev)
    stops = torch.ones(B, steps * r, device=dev)
    aligns = torch.zeros(B, T, steps, device=dev)
    fired = torch.zeros(B, dtype=torch.bool, device=dev)
    for t0 in range(0, steps, K):
        n = min(K, steps - t0)
        f, s, a, state = decode_block(dp, cfg, keys, memory, mask, state,
                                      drop[:, t0:t0 + n])
        frames[:, t0 * r:(t0 + n) * r] = f
        stops[:, t0 * r:(t0 + n) * r] = s
        aligns[:, :, t0:t0 + n] = a
        fired |= stop_fired(s.reshape(B, n, r), tc.stop_at_any).any(1)
        if K < steps and bool(fired.all()):
            break
    return frames, stops, (aligns if emit_alignments else None)


def teacher_inputs(targets, r: int):
    """Mel targets [B, T_out, mels] (T_out a multiple of r) -> the teacher
    frames [T_out/r, B, mels] f32: zeros for step 0, then the last frame of
    each r-group but the last (JAX `Decoder.teacher_forced`,
    decoder.py:353-356)."""
    B, _, mels = targets.shape
    tf = targets[:, r - 1::r].float()
    return torch.cat([tf.new_zeros(B, 1, mels), tf[:, :-1]],
                     1).transpose(0, 1).contiguous()


def teacher_forced(dp: DecoderParams, cfg: Config, keys, memory, mask,
                   teacher, coins, drop):
    """Teacher-forced decode in eval mode (JAX `Decoder.teacher_forced` with
    train=False, decoder.py:299-420): step t takes teacher[t] where
    coins[t] is set, else the previous step's last frame — one coin per
    step, shared by the batch. Zoneout is the EMA mix; the attention is the
    masked softmax with cumulative weights, no window constraint.

    keys [B, T, A], memory [B, T, M], mask [B, T], teacher [steps, B, mels],
    coins [steps] (0/1), drop [B, steps, 2, P]. With bf16 weights every
    activation is rounded to bf16 where it enters a product, as the TPU
    kernel `build_train_fwd` does (see `_step`). Returns (frames [B,
    steps*r, mels], stop logits [B, steps*r], alignments [B, T, steps]),
    all f32."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r = tc.outputs_per_step
    B, T, M = memory.shape
    steps = teacher.shape[0]
    cell = _cell(dp, keys, memory, mask,
                 round_inputs=dp.l1_wp.dtype == torch.bfloat16)
    state = init_decoder_state(cfg, B, T, M, memory.device)
    state = state._replace(pmax=state.pmax.long())
    teacher = teacher.float()
    frames_l, stops_l, aligns_l = [], [], []
    for t, coin in enumerate(coins.tolist()):
        x = teacher[t] if coin else state.xprev
        proj, align, state = _step(cell, cfg, x, drop[:, t], state, False)
        frames_l.append(proj[:, :r * mels])
        stops_l.append(proj[:, r * mels:])
        aligns_l.append(align)
    return (torch.stack(frames_l, 1).reshape(B, steps * r, mels),
            torch.stack(stops_l, 1).reshape(B, steps * r),
            torch.stack(aligns_l, 2))
