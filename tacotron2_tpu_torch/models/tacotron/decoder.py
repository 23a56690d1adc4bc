"""Tacotron decoder (PyTorch, eager): the autoregressive and the
teacher-forced decode, and the teacher-forced decode's backward.

Counterpart of tacotron2_tpu/models/tacotron/decoder.py: prenet with
dropout always on, two zoneout LSTMs, location-sensitive attention, fused
frame + stop projection. `decode_block` runs K free-running steps, with
the window constraint and the stop sigmoid, from an explicit
`DecoderKernelState` (Decoder.autoregressive with initial_state /
return_state, :367); `autoregressive` is a loop of blocks.
`teacher_forced` is Decoder.teacher_forced with train=False (:299): each
step's input frame comes from the teacher or the previous step by a
per-step coin, no window constraint, stop logits, EMA zoneout;
`teacher_forced_train` the same in train mode (Bernoulli zoneout, and the
per-step residuals), and `teacher_forced_bwd_plain` its reverse-time
backward. `Decoder` holds the decoder's parameters in flax layout.

The `Tacotron_emt_attn` variant (`gst.emt_attn`) adds a second attention,
over the emotion reference's sequence (`emt_memory`), whose context feeds
LSTM1 at the next step (JAX decoder.py:97-129): `EmtParams` holds its
weights, `emt_operands` lays out one call's operands, and every plain
decode (`decode_block`, `autoregressive`, `teacher_forced`,
`teacher_forced_train`) takes them as `emt`; the teacher-forced ones then
also return the emt attention's alignments (JAX decoder.py:299-420).

The prenet is a list of layers, each with its own width and its own row
of dropout multipliers. `DecoderParams` holds the kernels' prenet, two
layers of one width (`kernel_prenet`); any other prenet comes to the plain
decode as `prenet`, a tuple of (kernel, bias) pairs, and its
`DecoderParams` leaves the prenet fields None.

These are the plain versions of the CUDA kernels
(`ops/tacotron_decoder_kernel.py`, `ops/tacotron_train_kernel.py`,
`csrc/decoder.cu`, `csrc/decoder_bwd.cu`) and follow their contract
exactly:

- prenet dropout comes in as multipliers `drop [B, steps, 2, P]`
  (0 or 1/keep, drawn by the caller), and train-mode zoneout as masks
  `zmask [B, steps, 4, U]` (`zoneout_masks`), so kernel and plain see the
  same random numbers;
- `early_stop_block=K` applies the TPU kernel's batch-wide block rule
  (see `autoregressive`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ...config import Config
from ...parallel import dist
from .attention import (SimpleBahdanauAttention, attention_step,
                        emt_context, fold_location, identity,
                        location_features)
from .modules import REF_EMB, Dense, MultiheadStyleAttention


class DecoderParams(NamedTuple):
    """Matmul-ready decoder weights (JAX `DecoderParams` without its
    emt_attn fields, which are `EmtParams`).

    Matmul weights carry the decode weight dtype (bf16 or f32); biases and
    attention vectors are f32. `l1_b`/`l2_b` hold the folded forget bias.
    The prenet fields are the kernels' prenet (`kernel_prenet`), None for
    any other, which the plain decode takes as `prenet`.
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


class EmtParams(NamedTuple):
    """The emt_attn decoder's own weights (the emt fields of JAX
    `DecoderParams`, ops/tacotron_decoder_kernel.py:68-91, and the
    style_tokens variant's, which the TPU kernel does not run). The
    products of the step loop (emt_w2, mh_q_w, mh_out_w) carry the decode
    weight dtype; the rest is f32, l1_we too (`emt_operands` casts its
    step-loop copy). Fields of another variant are None.

    simple (SimpleBahdanauAttention, attention.py:104): emt_w1/emt_b1 on
    the emt memory, emt_w2/emt_b2 on the query, emt_v the score vector.
    multihead and style_tokens (GST MultiheadStyleAttention with the mlp
    scorer, the query LSTM2's output, for style_tokens joined with the
    one-hot emotion label): mh_q_w [Q, units], mh_k_w [V, units], their
    biases, the score vector mh_v [hd], gain mh_g and bias mh_b; multihead
    then the attn_emt_out Dense mh_out_w [H*V, 128], mh_out_b.
    """

    l1_we: torch.Tensor            # [E, 4U] context_emt rows of LSTM1
    l1_wr: torch.Tensor = None     # [R, 4U] ref_spk rows (simple,
                                   # style_tokens; None with emt_only)
    emt_w1: torch.Tensor = None    # [V, A2]
    emt_b1: torch.Tensor = None    # [A2]
    emt_w2: torch.Tensor = None    # [U, A2]
    emt_b2: torch.Tensor = None    # [A2]
    emt_v: torch.Tensor = None     # [A2]
    mh_q_w: torch.Tensor = None    # [U (+ n_emt), units]
    mh_q_b: torch.Tensor = None    # [units]
    mh_k_w: torch.Tensor = None    # [V, units]
    mh_k_b: torch.Tensor = None    # [units]
    mh_v: torch.Tensor = None      # [hd]
    mh_g: torch.Tensor = None      # []
    mh_b: torch.Tensor = None      # [hd]
    mh_out_w: torch.Tensor = None  # [H*V, 128]
    mh_out_b: torch.Tensor = None  # [128]


class EmtOperands(NamedTuple):
    """One call's emt-attention operands (`emt_operands`), f32 unless
    stated: the keys with every constant folded in, the score rows, the
    values, and the weights the step loop reads."""

    ekeys: torch.Tensor    # [B, Te, A2]
    score: torch.Tensor    # [nh, A2] nh = 1 (simple) or H masked rows
    emem: torch.Tensor     # [B, Te, V]
    rs_add: torch.Tensor   # [B, 4U] ref_spk's LSTM1 addend, or None
    l1_we: torch.Tensor    # [E, 4U] decode weight dtype
    wq: torch.Tensor       # [U, A2] query weight, decode weight dtype
    out_w: torch.Tensor    # [H*V, 128] (multihead) or None
    out_b: torch.Tensor    # [128] or None


def emt_context_width(cfg: Config) -> int:
    """E, the width of context_emt (JAX `DecoderCell.emt_context_size`,
    decoder.py:77): 2·reference_depth for simple, 128 (the attn_emt_out
    Dense) for multihead, num_heads·2·reference_depth for style_tokens;
    0 without emt_attn."""
    gst = cfg.gst
    if not gst.emt_attn:
        return 0
    if gst.emt_attn_type == "simple":
        return 2 * gst.reference_depth
    if gst.emt_attn_type == "multihead":
        return REF_EMB
    return gst.num_heads * 2 * gst.reference_depth


def ref_rows(cfg: Config, emt_only: bool = False) -> int:
    """R, LSTM1's ref_spk rows: under emt_attn the 128-wide speaker
    embedding joins LSTM1's input (simple, style_tokens) unless emt_only;
    multihead adds it to context_emt instead (JAX decoder.py:97-106)."""
    gst = cfg.gst
    return (REF_EMB if gst.emt_attn and not emt_only
            and gst.emt_attn_type != "multihead" else 0)


def emt_operands(ep: EmtParams, cfg: Config, emt_memory, ref_spk=None,
                 labels=None) -> EmtOperands:
    """Per call, the constants of the emt attention folded as the TPU block
    kernel folds them (tacotron_decoder_kernel.py:733-779): simple's keys
    emt_memory @ W1 + b1 + b2, without the score bias V.b (it shifts every
    energy alike, which the softmax cancels); multihead's key projection
    plus k_b + q_b + the score bias tiled over the heads, and H score rows,
    row h the normed v (g·v/|v|) in head h's columns and 0 elsewhere;
    style_tokens the same with the label's query rows (constant over the
    decode) also in the keys. ref_spk [B, R] enters LSTM1 through its own
    rows (simple, style_tokens) or added to context_emt (multihead): either
    way a constant addend rs_add [B, 4U]. labels: [B] emotion ids
    (style_tokens)."""
    gst = cfg.gst
    emem = emt_memory.float().contiguous()
    f = lambda x: x.float()
    rs_add = None
    if ep.emt_w1 is not None:
        ekeys = emem @ f(ep.emt_w1) + f(ep.emt_b1) + f(ep.emt_b2)
        score = f(ep.emt_v)[None]
        wq, out_w, out_b = ep.emt_w2, None, None
        if ep.l1_wr is not None and ref_spk is not None:
            rs_add = ref_spk.float() @ f(ep.l1_wr)
    else:
        H = gst.num_heads
        units = ep.mh_k_w.shape[1]
        hd = units // H
        U = cfg.tacotron.decoder_lstm_units
        ekeys = (emem @ f(ep.mh_k_w) + f(ep.mh_k_b) + f(ep.mh_q_b)
                 + f(ep.mh_b).repeat(H))
        if ep.mh_out_w is None:            # style_tokens: the label query
            if labels is None:
                raise ValueError("emt_attn_type=style_tokens decodes with "
                                 "emotion labels")
            onehot = torch.nn.functional.one_hot(
                labels.long().to(emem.device), gst.n_emt).float()
            ekeys = ekeys + (onehot @ f(ep.mh_q_w[U:]))[:, None, :]
        v = f(ep.mh_v)
        nv = f(ep.mh_g) * v * torch.rsqrt(torch.sum(v * v))
        score = emem.new_zeros(H, units)
        for h in range(H):
            score[h, h * hd:(h + 1) * hd] = nv
        wq, out_w, out_b = ep.mh_q_w[:U], ep.mh_out_w, ep.mh_out_b
        if ref_spk is not None:
            rows = ep.l1_we if out_w is not None else ep.l1_wr
            if rows is not None:
                rs_add = ref_spk.float() @ f(rows)
    return EmtOperands(ekeys.contiguous(), score.contiguous(), emem, rs_add,
                       ep.l1_we.to(wq.dtype), wq.contiguous(), out_w, out_b)


def kernel_prenet(cfg: Config) -> bool:
    """Whether the prenet is the kernels' own: two layers of one width
    (the TPU kernels assert (P, P), ops/tacotron_decoder_kernel.py:374)."""
    layers = tuple(cfg.tacotron.prenet_layers)
    return layers == (layers[-1], layers[-1])


def drop_masks(cfg: Config, batch: int, steps: int, generator=None,
               device="cuda") -> torch.Tensor:
    """Prenet dropout multipliers [B, steps, L, P], one row a prenet layer
    (L layers, P the widest; layer i reads the first prenet_layers[i] of
    its row): 1/keep where a uniform draw is below keep, else 0 (all ones
    at dropout_rate 0). The kernels' prenet (P, P) takes [B, steps, 2,
    P]. In a data-parallel step (`parallel.dist`) the rank's rows of the
    global batch's draw."""
    tc = cfg.tacotron
    keep = 1.0 - float(tc.dropout_rate)
    shape = (batch, steps, len(tc.prenet_layers), max(tc.prenet_layers))
    if keep >= 1.0:
        return torch.ones(shape, device=device)
    u = dist.rand_rows(shape, generator, device)
    return (u < keep).float() * (1.0 / keep)


def zoneout_masks(cfg: Config, batch: int, steps: int, generator=None,
                  device="cuda") -> torch.Tensor:
    """Train-mode zoneout masks [B, steps, 4, U] bool for (c1, h1, c2, h2):
    True (the new state is taken) where a uniform draw is below 1 - z, as
    the TPU train kernel draws them (tacotron_train_kernel.py:212-236); all
    True at zoneout_rate 0; in a data-parallel step the rank's rows of the
    global batch's draw."""
    U = cfg.tacotron.decoder_lstm_units
    zo = float(cfg.tacotron.zoneout_rate)
    shape = (batch, steps, 4, U)
    if zo <= 0.0:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return dist.rand_rows(shape, generator, device) < 1.0 - zo


def _lstm(z, c, h, zo: float, m=None):
    """LSTM update from gates z (i, j, f, o); zoneout is the EMA mix, or
    with masks m [B, 2, U] (c, h) the Bernoulli select of train mode."""
    i, j, f, o = z.chunk(4, dim=-1)
    nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(j)
    nh = torch.sigmoid(o) * torch.tanh(nc)
    if m is not None:
        return torch.where(m[:, 0], nc, c), torch.where(m[:, 1], nh, h)
    return (1 - zo) * nc + zo * c, (1 - zo) * nh + zo * h


def _lstm_bwd(z, c_prev, dh, dc, m):
    """Backward of one train-mode `_lstm` (JAX `build_train_bwd`'s
    lstm_bwd, :506-528) from its gates z and previous cell c_prev, with
    the gradients dh, dc of its outputs and its masks m [B, 2, U]. Returns
    (dz, dh_prev, dc_prev), dh_prev the part that zoned out."""
    i, j, f, o = z.chunk(4, dim=-1)
    si, sf, so, tj = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), \
        torch.tanh(j)
    tnc = torch.tanh(sf * c_prev + si * tj)
    m_c, m_h = m[:, 0].float(), m[:, 1].float()
    dnh = dh * m_h
    dnc = dc * m_c + dnh * so * (1.0 - tnc * tnc)
    dz = torch.cat([dnc * tj * si * (1.0 - si),
                    dnc * si * (1.0 - tj * tj),
                    dnc * c_prev * sf * (1.0 - sf),
                    dnh * tnc * so * (1.0 - so)], -1)
    return dz, dh * (1.0 - m_h), dc * (1.0 - m_c) + dnc * sf


def stop_fired(stop_probs, stop_at_any: bool):
    """[B, r] stop probabilities -> [B] bool (TacoTestHelper rule)."""
    sp = stop_probs.max(-1).values if stop_at_any else stop_probs.min(-1).values
    return sp > 0.5




class DecoderKernelState(NamedTuple):
    """The decoder's carried state between blocks (JAX
    `DecoderKernelState`, ops/tacotron_decoder_kernel.py:239, without the
    TPU's lane padding). ctx_emt is None without emt_attn."""

    xprev: torch.Tensor  # [B, mels] f32 last frame of the previous step
    c1: torch.Tensor     # [B, U] f32
    h1: torch.Tensor     # [B, U] f32
    c2: torch.Tensor     # [B, U] f32
    h2: torch.Tensor     # [B, U] f32
    ctx: torch.Tensor    # [B, M] f32 attention context
    cum: torch.Tensor    # [B, T] f32 cumulative alignments
    pmax: torch.Tensor   # [B] int32 previous argmax (window constraint)
    ctx_emt: torch.Tensor | None = None  # [B, E] f32 emt-attention context


def init_decoder_state(cfg: Config, batch: int, T: int, M: int,
                       device="cuda") -> DecoderKernelState:
    """Zero carry for a fresh batch (JAX `init_decoder_state`,
    ops/tacotron_decoder_kernel.py:258); ctx_emt [B, E] under emt_attn."""
    U, mels = cfg.tacotron.decoder_lstm_units, cfg.audio.num_mels
    E = emt_context_width(cfg)
    z = lambda *s: torch.zeros(*s, device=device)
    return DecoderKernelState(
        xprev=z(batch, mels), c1=z(batch, U), h1=z(batch, U),
        c2=z(batch, U), h2=z(batch, U), ctx=z(batch, M), cum=z(batch, T),
        pmax=torch.zeros(batch, dtype=torch.int32, device=device),
        ctx_emt=z(batch, E) if E else None)


class Casts(NamedTuple):
    """What a route rounds to bf16 with bf16 weights besides every product
    input, the memory and the location taps (which every route rounds):
    the keys with their folded bias, v_a, and the energies' tanh where it
    meets v_a. Each route follows the TPU kernel it stands for."""

    keys: bool
    v_a: bool
    tanh: bool


# the teacher-forced routes (`build_train_fwd`: f32 keys and v_a, :345-346)
TEACHER_FORCED = Casts(False, False, False)
# the whole decode (`build_decoder_kernel`, its default energy_mode "vpu":
# keys cast, v_a a f32 row, _attention_operands :229-236)
WHOLE = Casts(True, False, False)
# the block kernel (`build_decoder_block_kernel`, keys and v_a cast,
# `_tiled_attention_operands` :305-318) at the energy_mode JAX resolves
# (:399-406): "vmat" without emt_attn, which also rounds the tanh before
# its v_a product (:561-571), and "vpu" with it
BLOCK = Casts(True, True, True)
BLOCK_EMT = Casts(True, True, False)


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
    v_a: torch.Tensor
    rnd_tanh: object
    emt: EmtOperands | None = None
    prenet: tuple = ()


def round_bf16(x):
    """x rounded to bf16 (to nearest even), kept in f32. Where x needs a
    gradient the rounding passes it through unchanged (x + (r - x) is r
    exactly: r - x is exact for neighbours), as the CUDA backward takes
    it."""
    r = x.to(torch.bfloat16).float()
    return x + (r - x).detach() if x.requires_grad else r


def prenet_of(dp: DecoderParams, prenet=None) -> tuple:
    """The prenet's (kernel, bias) pairs: `prenet` where given, else the
    two layers of `dp`."""
    if prenet is not None:
        return tuple(prenet)
    if dp.pre_w0 is None:
        raise ValueError("a prenet other than two layers of one width comes "
                         "to the plain decode as `prenet`")
    return ((dp.pre_w0, dp.pre_b0), (dp.pre_w1, dp.pre_b1))


def _cell(dp: DecoderParams, keys, memory, mask,
          round_inputs: bool = False, emt: EmtOperands | None = None,
          casts: Casts = TEACHER_FORCED, prenet=None) -> _Cell:
    w = {k: v.float() for k, v in dp._asdict().items() if v is not None}
    layers = tuple((k.float(), b.float()) for k, b in prenet_of(dp, prenet))
    wp, b_eff = fold_location(dp.loc_k, dp.loc_b, dp.wloc, dp.b_a)
    rnd = round_bf16 if round_inputs else identity
    rc = lambda on, x: rnd(x) if on else x
    # LSTM1's rows [prenet | context | context_emt | hidden]
    l1 = [w["l1_wp"], w["l1_wc"], w["l1_wh"]]
    if emt is not None:
        l1.insert(2, emt.l1_we.float())
        emt = emt._replace(
            wq=emt.wq.float(), ekeys=rnd(emt.ekeys), emem=rnd(emt.emem),
            out_w=None if emt.out_w is None else emt.out_w.float())
    return _Cell(w, torch.cat(l1, 0),
                 torch.cat([w["l2_wx"], w["l2_wh"]], 0),
                 torch.cat([w["proj_wo"], w["proj_wc"]], 0), rnd(wp),
                 rc(casts.keys, keys.float() + b_eff), rnd(memory.float()),
                 mask.float().to(memory.device), rnd,
                 rc(casts.v_a, w["v_a"]), rnd if casts.tanh else identity,
                 emt, layers)


def _step(cell: _Cell, cfg: Config, x, drop_t, state: DecoderKernelState,
          constraint: bool, zm_t=None):
    """One decoder step on input frame x [B, mels] with prenet multipliers
    drop_t [B, L, P]: prenet, both zoneout LSTMs (EMA mix, or with train
    masks zm_t [B, 4, U] the Bernoulli select), attention, the fused frame
    + stop projection. Returns (proj [B, r*mels + r] with the stop logits
    last, align [B, T], the state after the step, whose xprev is the
    step's last frame, and the step's first and last prenet outputs h0d,
    hpre, gates z1, z2 and query q, which the backward reads, and under
    emt_attn align_emt, the emt attention's weights [B, Te] (simple) or
    zeros [B, 1] (the multi-head types), as JAX records them).

    `cell.rnd` rounds every activation where it enters a product — the
    frame, both prenet inputs, the LSTM inputs, the query's and the
    projection's, the cumulative weights of the location features, the
    alignment of the context, and under emt_attn the emt query's input,
    the emt alignment and multihead's joined contexts — as the TPU kernels
    do with bf16 weights (the memory, the location taps and the emt keys
    and memory are rounded once in `_cell`, and the keys, v_a and the
    energies' tanh as the route's `Casts` say); sums and the carried state
    stay f32. With f32 weights nothing is rounded. The alignments are the
    softmax, or with `tacotron.smoothing` the normalised sigmoids.

    Under emt_attn (`cell.emt`) LSTM1 also takes the previous step's
    context_emt (and ref_spk, as the constant rs_add), and after LSTM2 the
    emt attention gives the next one (JAX decoder.py:97-129)."""
    tc = cfg.tacotron
    r, mels = tc.outputs_per_step, cfg.audio.num_mels
    zo = float(tc.zoneout_rate)
    w, rnd, emt = cell.w, cell.rnd, cell.emt
    c1, h1, c2, h2 = state.c1, state.h1, state.c2, state.h2
    ctx, cum, pmax, ctx_emt = state.ctx, state.cum, state.pmax, state.ctx_emt
    h, outs = x, []
    for i, (pw, pb) in enumerate(cell.prenet):
        h = torch.relu(rnd(h) @ pw + pb) * drop_t[:, i, :pw.shape[1]]
        outs.append(h)
    h0d, hpre = outs[0], outs[-1]
    x1 = [hpre, ctx, h1] if emt is None else [hpre, ctx, ctx_emt, h1]
    z1 = rnd(torch.cat(x1, -1)) @ cell.l1_w + w["l1_b"]
    if emt is not None and emt.rs_add is not None:
        z1 = z1 + emt.rs_add
    c1, h1 = _lstm(z1, c1, h1, zo, None if zm_t is None else zm_t[:, :2])
    z2 = rnd(torch.cat([h1, h2], -1)) @ cell.l2_w + w["l2_b"]
    c2, h2 = _lstm(z2, c2, h2, zo, None if zm_t is None else zm_t[:, 2:])
    extra = {}
    if emt is not None:
        ctx_emt, w_emt = emt_context(rnd(h2) @ emt.wq, emt.ekeys, emt.score,
                                     emt.emem, rnd)
        if emt.out_w is not None:
            ctx_emt = rnd(ctx_emt) @ emt.out_w + emt.out_b.float()
        extra["align_emt"] = (w_emt[:, 0]
                              if cfg.gst.emt_attn_type == "simple"
                              else w_emt.new_zeros(w_emt.shape[0], 1))
    q = rnd(h2) @ w["wq"]
    ctx, align, cum, pmax = attention_step(
        q, cell.keys_eff, cell.memory, cell.mask, cum, pmax, cell.wp,
        cell.v_a, constraint=constraint, ctype=tc.synthesis_constraint_type,
        win=tc.attention_win_size, rnd=rnd, rnd_tanh=cell.rnd_tanh,
        smoothing=tc.smoothing)
    proj = rnd(torch.cat([h2, ctx], -1)) @ cell.proj_w + w["proj_b"]
    xprev = proj[:, (r - 1) * mels:r * mels]
    return (proj, align,
            DecoderKernelState(xprev, c1, h1, c2, h2, ctx, cum, pmax,
                               ctx_emt),
            dict(h0d=h0d, hpre=hpre, z1=z1, z2=z2, q=q, **extra))


def decode_block(dp: DecoderParams, cfg: Config, keys, memory, mask,
                 state: DecoderKernelState, drop,
                 emt: EmtOperands | None = None, *,
                 casts: Casts | None = None, prenet=None):
    """K = drop.shape[1] free-running steps from `state`. keys [B, T, A],
    memory [B, T, M], mask [B, T] (bool or 1/0), drop [B, K, L, P], under
    emt_attn `emt` (`emt_operands`), and `prenet` where it is not dp's.
    Returns (frames [B, K*r, mels], stop_probs [B, K*r], alignments [B, T,
    K], the state after the block), all f32. With bf16 weights it rounds what `casts` says (default: the
    TPU block kernel at its default energy_mode, `BLOCK` or `BLOCK_EMT`;
    `WHOLE` steps the whole decode's function)."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    casts = casts or (BLOCK if emt is None else BLOCK_EMT)
    r = tc.outputs_per_step
    B = memory.shape[0]
    K = drop.shape[1]
    if (emt is None) != (state.ctx_emt is None):
        raise ValueError("an emt_attn decode needs both emt operands and "
                         "state.ctx_emt; any other decode neither")
    cell = _cell(dp, keys, memory, mask, dp.l1_wp.dtype == torch.bfloat16,
                 emt, casts, prenet)
    state = state._replace(pmax=state.pmax.long())
    frames_l, stops_l, aligns_l = [], [], []
    for t in range(K):
        proj, align, state, _ = _step(cell, cfg, state.xprev, drop[:, t],
                                      state, tc.synthesis_constraint)
        frames_l.append(proj[:, :r * mels])
        stops_l.append(torch.sigmoid(proj[:, r * mels:]))
        aligns_l.append(align)
    state = state._replace(pmax=state.pmax.to(torch.int32))
    return (torch.stack(frames_l, 1).reshape(B, K * r, mels),
            torch.stack(stops_l, 1).reshape(B, K * r),
            torch.stack(aligns_l, 2), state)


def autoregressive(dp: DecoderParams, cfg: Config, keys, memory, mask,
                   steps: int, drop, early_stop_block: int = 0,
                   emit_alignments: bool = True,
                   emt: EmtOperands | None = None, prenet=None):
    """Free-running decode of `steps` steps as a loop of `decode_block`.

    early_stop_block=K (0 < K < steps) applies the TPU kernel's rule
    (tacotron_decoder_kernel.py:1053-1070): every row decodes until the
    first K-step boundary at which every row's sticky stop flag has fired
    (all r stop probs > 0.5, or any with `stop_at_any`); the steps after it
    read as frames 0, stop probability 1.0 and alignments 0. `emt` and
    `prenet`: as `decode_block`. With bf16 weights it rounds as the TPU
    whole-decode kernel does (`WHOLE`). Returns (frames [B, steps*r, mels], stop_probs
    [B, steps*r], alignments [B, T, steps] or None)."""
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
                                      drop[:, t0:t0 + n], emt, casts=WHOLE,
                                      prenet=prenet)
        frames[:, t0 * r:(t0 + n) * r] = f
        stops[:, t0 * r:(t0 + n) * r] = s
        aligns[:, :, t0:t0 + n] = a
        fired |= stop_fired(s.reshape(B, n, r), tc.stop_at_any).any(1)
        if K < steps and bool(fired.all()):
            break
    return frames, stops, (aligns if emit_alignments else None)


def teacher_forced_route(cfg: Config) -> str:
    """The route of the teacher-forced decode (training, its eval forward,
    GTA, `embed`), chosen from the config before anything is launched:
    "plain" (`teacher_forced` / `teacher_forced_train`, on any device and
    on its tensors) under `tacotron.smoothing`, `gst.emt_attn` or a prenet
    other than the kernels' (P, P), as the JAX package sends each of them
    to its flax scan and not to a kernel (tacotron2_tpu/models/tacotron/
    decoder.py:311-316); else "kernel" (ops/tacotron_train_kernel.py)."""
    plain = (cfg.tacotron.smoothing or cfg.gst.emt_attn
             or not kernel_prenet(cfg))
    return "plain" if plain else "kernel"


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
                   teacher, coins, drop, *, emt: EmtOperands | None = None,
                   prenet=None):
    """Teacher-forced decode in eval mode (JAX `Decoder.teacher_forced` with
    train=False, decoder.py:299-420): step t takes teacher[t] where
    coins[t] is set, else the previous step's last frame — one coin per
    step, shared by the batch. Zoneout is the EMA mix; the attention is the
    masked softmax with cumulative weights, no window constraint.

    keys [B, T, A], memory [B, T, M], mask [B, T], teacher [steps, B, mels],
    coins [steps] (0/1), drop [B, steps, L, P]. With bf16 weights every
    activation is rounded to bf16 where it enters a product, as the TPU
    kernel `build_train_fwd` does (see `_step`). Returns (frames [B,
    steps*r, mels], stop logits [B, steps*r], alignments [B, T, steps]),
    all f32. Under emt_attn (`emt`, the call's `emt_operands`) LSTM1 takes
    the emt attention's context, and a fourth output is its alignments
    [B, Te, steps] (simple) or zeros [B, 1, steps] (JAX decoder.py:
    132-146); `prenet` where it is not dp's."""
    frames, stops, aligns, res = _teacher_forced(
        dp, cfg, keys, memory, mask, teacher, coins, drop, None, emt=emt,
        prenet=prenet)
    if emt is None:
        return frames, stops, aligns
    return frames, stops, aligns, res["align_emt"]


def teacher_forced_train(dp: DecoderParams, cfg: Config, keys, memory,
                         mask, teacher, coins, drop, zmask,
                         bf16_inputs: bool | None = None, *,
                         emt: EmtOperands | None = None, prenet=None):
    """`teacher_forced` in train mode, the plain version of the train
    forward (JAX `build_train_fwd` with train_zoneout=True, :118):
    Bernoulli zoneout from zmask [B, steps, 4, U] bool (`zoneout_masks`),
    and the residuals the backward reads. Returns (frames, stop logits,
    alignments, res); res holds, all f32 and [B, steps, ·]: out (the
    projection: frames | stop logits), align, cum_pre (the cumulative
    alignments before the step), q (the attention query), z1, z2 (LSTM
    gates, forget bias folded), h0d, hpre (prenet outputs after dropout),
    ctx, h1, c1, h2, c2 (the state after the step). Differentiable in dp,
    keys and memory: autograd through it is the reference the fused
    backward is held to. `bf16_inputs` rounds the activations as with bf16
    weights (default: when dp's weights are bf16), for f32 weights that
    hold bf16 values and need f32 gradients. `emt` and `prenet` as in
    `teacher_forced`; under emt_attn res also holds align_emt, the emt
    alignments [B, Te or 1, steps]."""
    return _teacher_forced(dp, cfg, keys, memory, mask, teacher, coins,
                           drop, zmask, bf16_inputs, emt=emt, prenet=prenet)


def _teacher_forced(dp, cfg, keys, memory, mask, teacher, coins, drop,
                    zmask, bf16_inputs=None, *, emt=None, prenet=None):
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r = tc.outputs_per_step
    B, T, M = memory.shape
    steps = teacher.shape[0]
    if bf16_inputs is None:
        bf16_inputs = dp.l1_wp.dtype == torch.bfloat16
    cell = _cell(dp, keys, memory, mask, round_inputs=bf16_inputs, emt=emt,
                 prenet=prenet)
    state = init_decoder_state(cfg, B, T, M, memory.device)
    state = state._replace(pmax=state.pmax.long())
    teacher = teacher.float()
    keep = ("out", "align", "cum_pre", "q", "z1", "z2", "h0d", "hpre", "ctx",
            "h1", "c1", "h2", "c2")
    res = {k: [] for k in keep}
    align_emt = []
    for t, coin in enumerate(coins.tolist()):
        x = teacher[t] if coin else state.xprev
        cum_pre = state.cum
        proj, align, state, step_res = _step(
            cell, cfg, x, drop[:, t], state, False,
            None if zmask is None else zmask[:, t])
        res["out"].append(proj)
        res["align"].append(align)
        if emt is not None:
            align_emt.append(step_res.pop("align_emt"))
        if zmask is not None:
            step_res.update(cum_pre=cum_pre, ctx=state.ctx, h1=state.h1,
                            c1=state.c1, h2=state.h2, c2=state.c2)
            for k, v in step_res.items():
                res[k].append(v)
    res = {k: torch.stack(v, 1) for k, v in res.items() if v}
    if align_emt:
        res["align_emt"] = torch.stack(align_emt, 2)
    out = res["out"]
    frames = out[..., :r * mels].reshape(B, steps * r, mels)
    stops = out[..., r * mels:].reshape(B, steps * r)
    return frames, stops, res["align"].transpose(1, 2), res


def teacher_forced_replay(dp: DecoderParams, cfg: Config, keys, memory,
                          mask, teacher, coins, drop, zmask, res,
                          chunk: int = 64):
    """The plain train step replayed on a given trajectory, one step at a
    time: step t starts from `res`'s state after step t-1 (c1, h1, c2, h2,
    ctx, the cumulative alignments `cum_pre[t]`, and where coins[t] is 0
    the last frame of out[t-1]) with its own masks, so each step is held
    on its own and a difference cannot feed forward. `res` is the train
    forward's residual dict (e.g. the kernel's); returns the same keys
    recomputed, [B, steps, ·]. Steps go `chunk` at a time as one batch of
    chunk·B rows."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r = tc.outputs_per_step
    B, S = res["out"].shape[:2]
    names = ("out", "align", "cum_pre", "q", "z1", "z2", "h0d", "hpre",
             "ctx", "h1", "c1", "h2", "c2")
    got = {k: [] for k in names}
    bf16 = dp.l1_wp.dtype == torch.bfloat16
    coins = coins.to(memory.device).bool()
    teacher = teacher.float()
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        ts = torch.arange(t0, t0 + n, device=memory.device)
        rows = lambda x: x.transpose(0, 1).reshape(n * B, *x.shape[2:])
        rep = lambda x: x[None].expand(n, *x.shape).reshape(n * B,
                                                             *x.shape[1:])

        def prev(name):
            x = res[name][:, (ts - 1).clamp(min=0)]
            return rows(torch.where((ts > 0)[None, :, None], x,
                                    torch.zeros_like(x)))

        xprev = prev("out")[:, (r - 1) * mels:r * mels]
        x = torch.where(rows(coins[ts][None, :, None].expand(B, n, 1)),
                        rows(teacher[ts].transpose(0, 1)), xprev)
        state = DecoderKernelState(
            xprev, prev("c1"), prev("h1"), prev("c2"), prev("h2"),
            prev("ctx"), rows(res["cum_pre"][:, ts]),
            torch.zeros(n * B, dtype=torch.long, device=memory.device))
        cell = _cell(dp, rep(keys), rep(memory), rep(mask),
                     round_inputs=bf16)
        proj, align, st, sres = _step(cell, cfg, x, rows(drop[:, ts]), state,
                                      False, rows(zmask[:, ts]))
        sres.update(out=proj, align=align, cum_pre=state.cum, ctx=st.ctx,
                    h1=st.h1, c1=st.c1, h2=st.h2, c2=st.c2)
        for k in names:
            got[k].append(sres[k].reshape(n, B, -1).transpose(0, 1))
    return {k: torch.cat(v, 1) for k, v in got.items()}


def teacher_forced_bwd_plain(dp: DecoderParams, cfg: Config, res, keys,
                             memory, mask, coins, drop, zmask, dout,
                             dalign, round_gradients: bool | None = None,
                             replay: dict | None = None):
    """The plain version of the BPTT backward (CUDA `csrc/decoder_bwd.cu`;
    JAX `build_train_bwd`, tacotron_train_kernel.py:371-600): an explicit
    reverse-time chain through the projection, the location-sensitive
    attention (softmax, masked positions, the cumulative-alignment
    gradient carried across steps, the location conv's transpose), both
    zoneout LSTMs, the prenet with its dropout and the scheduled-sampling
    feedback: where coins[t] is 0, step t's input was step t-1's last
    frame, so its gradient adds into step t-1's projection gradient.

    res: `teacher_forced_train`'s residuals; dout [B, steps, r*mels + r]
    the gradient of the projection (frames | stop logits), dalign [B,
    steps, T] that of the alignments. With bf16 weights it rounds as
    `build_train_bwd` does (:445-569): activations enter each product as in
    the forward, and it reads the gates z1, z2 and cells c1, c2 rounded as
    `build_train_fwd` stores them; every gradient is rounded to bf16 where
    it enters a product (dproj, the summed dctx, the energies' gradient de
    in the taps' sum and the cumulative-alignment chain, dq, dz2, dz1, da1,
    da0), and the per-step outputs are those rounded values (f32 tensors).
    dkeys, the v_a sums, the LSTM cell chain and the carried dh and dcum
    sums stay f32 and unrounded. With f32 weights nothing is rounded.
    `round_gradients=False` keeps the bf16 route's gradients and the gates
    and cells it reads unrounded (a control for the rounding's size).
    `replay`, another backward's outputs (e.g. the kernel's), replays it
    one step at a time: each per-step gradient, and the cumulative
    alignments' gradient carried into the step, is computed, returned, and
    replaced by replay's before anything downstream takes it, so every
    step starts from that backward's own values and a rounding that
    another sum order moved cannot feed forward (the other carried f32
    sums follow from those gradients).
    Returns the per-step activation gradients dz1, dz2 [B, steps, 4U],
    da0, da1 [B, steps, P] (prenet pre-activations), dproj [B, steps,
    r*mels + r] (with the feedback), dctx [B, steps, M], dq [B, steps, A],
    dcum [B, steps, T] (the cumulative alignments' gradient carried into
    each step from the later ones), and summed over the steps: dkeys [B,
    T, A] (of the keys with the folded attention bias), dwp [K, A] (of the
    folded location taps), dva [A]."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    if tc.smoothing:
        raise ValueError("the BPTT backward takes softmax attention; under "
                         "tacotron.smoothing the decode trains by autograd "
                         "through its plain version")
    r = tc.outputs_per_step
    B, T, M = memory.shape
    S = dout.shape[1]
    bf16 = dp.l1_wp.dtype == torch.bfloat16
    cell = _cell(dp, keys, memory, mask, round_inputs=bf16)
    w, rnd, wp = cell.w, cell.rnd, cell.wp
    if round_gradients is None:
        round_gradients = bf16
    rg = round_bf16 if round_gradients else identity
    U, P = w["l2_wh"].shape[0], w["pre_b0"].shape[0]
    K, A = wp.shape
    pad = (K - 1) // 2
    z = lambda *s: memory.new_zeros(*s)
    dh1, dc1, dh2, dc2 = z(B, U), z(B, U), z(B, U), z(B, U)
    dctx_c, dcum, dxprev = z(B, M), z(B, T), z(B, mels)
    dkeys, dwp, dva = z(B, T, A), z(K, A), z(A)
    keys_out = ("dz1", "dz2", "da0", "da1", "dproj", "dctx", "dq", "dcum")
    outs = {k: [None] * S for k in keys_out}
    coins = coins.tolist()
    proj_wo_t, proj_wc_t = w["proj_wo"].t(), w["proj_wc"].t()
    for t in reversed(range(S)):
        def out(name, v):
            """v is step t's `name`; downstream takes replay's, if any"""
            outs[name][t] = v
            return v if replay is None else replay[name][:, t]
        dproj = dout[:, t].clone()
        dproj[:, (r - 1) * mels:r * mels] += dxprev
        dproj = out("dproj", rg(dproj))
        dh2_out = dproj @ proj_wo_t
        dctx = out("dctx", rg(dproj @ proj_wc_t + dctx_c))
        # attention: context, softmax, energies, location features
        align = res["align"][:, t]
        dcum = out("dcum", dcum)
        dal = (torch.bmm(dctx[:, None, :], cell.memory.transpose(1, 2))[:, 0]
               + dalign[:, t] + dcum)
        den = align * (dal - (dal * align).sum(-1, keepdim=True))
        rc = rnd(res["cum_pre"][:, t])
        e = torch.tanh(cell.keys_eff + res["q"][:, t][:, None, :]
                       + location_features(rc, wp))
        de = den[..., None] * w["v_a"] * (1.0 - e * e)         # [B, T, A]
        dkeys += de
        dva += (e * den[..., None]).sum((0, 1))
        rde = rg(de)
        taps = F.pad(rc, (pad, K - 1 - pad)).unfold(1, K, 1)   # [B, T, K]
        dwp += torch.einsum("btk,bta->ka", taps, rde)
        dcum = dcum + F.conv_transpose1d(
            rde.transpose(1, 2), wp.t()[:, None, :], padding=pad)[:, 0, :T]
        dq = out("dq", rg(de.sum(1)))
        # LSTM2, LSTM1 (dz @ W^T: the transposed products)
        c_prev = lambda n: rg(res[n][:, t - 1]) if t else z(B, U)
        dz2, dh2_z, dc2 = _lstm_bwd(rg(res["z2"][:, t]), c_prev("c2"),
                                    dh2_out + dq @ w["wq"].t() + dh2, dc2,
                                    zmask[:, t, 2:])
        dz2 = out("dz2", rg(dz2))
        dx2 = dz2 @ w["l2_wx"].t()
        dh2 = dh2_z + dz2 @ w["l2_wh"].t()
        dz1, dh1_z, dc1 = _lstm_bwd(rg(res["z1"][:, t]), c_prev("c1"),
                                    dx2 + dh1, dc1, zmask[:, t, :2])
        dz1 = out("dz1", rg(dz1))
        g1 = dz1 @ cell.l1_w.t()
        dhpre, dctx_c, dh1 = g1[:, :P], g1[:, P:P + M], dh1_z + g1[:, P + M:]
        # prenet: relu and dropout through the saved outputs' sign and the
        # multipliers
        da1 = out("da1", rg(dhpre * drop[:, t, 1] * (res["hpre"][:, t] > 0)))
        da0 = out("da0", rg((da1 @ w["pre_w1"].t()) * drop[:, t, 0]
                            * (res["h0d"][:, t] > 0)))
        dxprev = da0 @ w["pre_w0"].t() if coins[t] == 0 else z(B, mels)
    out = {k: torch.stack(v, 1) for k, v in outs.items()}
    out.update(dkeys=dkeys, dwp=dwp, dva=dva)
    return out


class _Leaf(nn.Module):
    """Parameters under their flax names."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.zeros(*shape)))


class Decoder(nn.Module):
    """The decoder's parameters in flax layout, named as JAX's
    `DecoderCell` (decoder/cell/...: prenet, lstm1, lstm2, attention with
    its memory_layer, frame_projection, stop_projection, and under
    emt_attn attention_emt and, for multihead, attn_emt_out); LSTM biases
    without the folded forget bias. LSTM1's kernel has the rows [prenet |
    context | context_emt (E) | ref_spk (`ref_width`) | hidden];
    `emt_value_width` is the emt memory's. `ops/tacotron_train_kernel.py:
    extract_params_traced` makes the matmul-ready `DecoderParams` of them,
    differentiably."""

    def __init__(self, cfg: Config, memory_width: int,
                 emt_value_width: int = 0, ref_width: int = 0):
        super().__init__()
        tc, gst, mels = cfg.tacotron, cfg.gst, cfg.audio.num_mels
        U, A, r = tc.decoder_lstm_units, tc.attention_dim, tc.outputs_per_step
        dims = [mels] + list(tc.prenet_layers)
        M = memory_width
        self.memory_width, self.ref_width = M, ref_width
        E = emt_context_width(cfg)
        self.prenet = nn.ModuleDict({
            f"Dense_{i}": Dense(dims[i], dims[i + 1])
            for i in range(len(tc.prenet_layers))})
        self.lstm1 = _Leaf(kernel=(dims[-1] + M + E + ref_width + U, 4 * U),
                           bias=(4 * U,))
        self.lstm2 = _Leaf(kernel=(2 * U, 4 * U), bias=(4 * U,))
        self.attention = _Leaf(attention_variable_projection=(A, 1),
                               attention_bias=(A,))
        att = self.attention
        att.query_layer = Dense(U, A, use_bias=False)
        att.memory_layer = Dense(M, A, use_bias=False)
        att.location_features_convolution = _Leaf(
            kernel=(tc.attention_kernel, 1, tc.attention_filters),
            bias=(tc.attention_filters,))
        att.location_features_layer = Dense(tc.attention_filters, A,
                                            use_bias=False)
        self.frame_projection = nn.ModuleDict(
            {"Dense_0": Dense(U + M, r * mels)})
        self.stop_projection = nn.ModuleDict({"Dense_0": Dense(U + M, r)})
        if gst.emt_attn:
            V = emt_value_width
            if gst.emt_attn_type == "simple":
                self.attention_emt = SimpleBahdanauAttention(
                    U, V, 2 * gst.reference_depth)
            else:
                q = U + (gst.n_emt if gst.emt_attn_type == "style_tokens"
                         else 0)
                self.attention_emt = MultiheadStyleAttention(
                    q, V, gst.num_heads, gst.style_att_dim,
                    gst.style_att_type)
                if gst.emt_attn_type == "multihead":
                    self.attn_emt_out = Dense(gst.num_heads * V, REF_EMB)
