"""A plain-PyTorch replay of the WaveNet stack kernels' data flow
(csrc/wavenet_train.cu, kernels 5a and 5b), on the CPU.

The kernels cannot run here, so this file replays what they move where:
128-row tiles walked by persistent CTAs (CTA b takes tiles b, b + grid,
...); TMA boxes, which read zeros for rows outside [0, N) (the causal pad
and the ragged tail: `window`); the forward's tap operand xd, prepared by
the previous layer's epilogue (layer 0's by a pre-pass) with the dropout
masks keyed by the source row; h and go written to a scratch and read back
as the tile's own window; the backward's per-CTA column sums (the bias
gradients) from the gate launch; the weight gradients over `wgrad_splits`
row splits, one 128 × 128 output tile a CTA, reduced in the reduce
launch's fixed order (group g sums splits g, g + 8, ..., then the groups
in order) and scattered by its tile map.

Held against `stack_fwd_plain` / `stack_bwd_plain`: the elementwise steps
(windows, masks, xd, layer 0's saved x) bit for bit; the rest, f32 with
f32 weights, within 1e-5 of each output's largest value, since the replay
sums per tile and per split where the plain version sums whole (the
readings were ≤ 9e-7: f32 sum order). And against the JAX
package's `fused_stack_apply(..., interpret=True)` through `FusedStack`,
the replay in place of the plain versions, at the JAX kernel tests'
widths with dropout off and an uneven set (R 24, G 48, S 16, cin 12,
where the JAX kernel runs; it raises at G != 2R) with every element kept,
at tests/test_torch_wavenet_stack_envelope.py's tolerances.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_wavenet_stack_envelope import (UNEVEN, compare,  # noqa: E402
                                               jcfg_of)

from tacotron2_tpu.ops.wavenet_train_kernel import (
    extract_stack_params as jax_extract, fused_stack_apply as jax_apply)
from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk

TILE = 128
GROUPS = 8          # the reduce launch's warps
SMS = 132           # an H100's SMs, which size the weight-gradient splits


def window(t, r0, rows=TILE):
    """A TMA box: rows r0 .. r0 + rows - 1 of t, zeros outside [0, N)."""
    out = t.new_zeros(rows, t.shape[1])
    lo, hi = max(r0, 0), min(r0 + rows, t.shape[0])
    if lo < hi:
        out[lo - r0:hi - r0] = t[lo:hi]
    return out


def walk(tiles, grid):
    """(CTA, tile) in the persistent kernels' order."""
    return [(b, t) for b in range(grid) for t in range(b, tiles, grid)]


def fixed_order_sum(parts):
    """The reduce launch: group g sums parts g, g + 8, ... in order, then
    the groups add in order."""
    groups = []
    for g in range(min(GROUPS, len(parts))):
        s = parts[g]
        for p in parts[g + GROUPS::GROUPS]:
            s = s + p
        groups.append(s)
    total = groups[0]
    for s in groups[1:]:
        total = total + s
    return total


def case(widths, B, T, weight_bf16=False, dtype=torch.float32, drop=0.05,
         layers=4, stacks=2, seed=0):
    R, G, S, Ci = widths
    cfg = Config()
    cfg = cfg.replace(wavenet=dataclasses.replace(
        cfg.wavenet, layers=layers, stacks=stacks, residual_channels=R,
        gate_channels=G, skip_out_channels=S, cin_channels=Ci, dropout=drop,
        compute_dtype="bfloat16" if weight_bf16 else "float32"))
    plan = wtk.make_plan(cfg, B, "float32")
    rng = np.random.default_rng(seed)
    L, Ch = plan.L, G // 2
    shapes = dict(conv_w=(L * 3 * R, G), conv_b=(L, G), cin_w=(L * Ci, G),
                  cin_b=(L, G), skip_w=(L * Ch, S), skip_b=(L, S),
                  out_w=(L * Ch, R), out_b=(L, R))
    t = lambda shape, s: torch.tensor(rng.normal(size=shape) * s,
                                      dtype=dtype)
    sp = wtk.StackParams(**{k: t(v, 0.3) for k, v in shapes.items()})
    N = B * T
    return plan, sp, t((N, R), 0.5), t((N, Ci), 0.5), t((N, S), 1.0)


def _layer_weights(pp, spp, l, rnd):
    C, G, S, Ci, Ch = pp.C, pp.G, pp.S, pp.Ci, pp.Ch
    conv = spp.conv_w[3 * l * C:3 * (l + 1) * C]
    return dict(
        w1=rnd(torch.cat([conv, spp.cin_w[l * Ci:(l + 1) * Ci]], 0)),
        w2=rnd(torch.cat([spp.skip_w[l * Ch:(l + 1) * Ch],
                          spp.out_w[l * Ch:(l + 1) * Ch]], 1)),
        wos=rnd(torch.cat([spp.out_w[l * Ch:(l + 1) * Ch],
                           spp.skip_w[l * Ch:(l + 1) * Ch]], 1)),
        wconv=rnd(conv.reshape(3, C, G)),
        wcin=rnd(spp.cin_w[l * Ci:(l + 1) * Ci]))


def _mult(pp, seed, l, N, like):
    if pp.drop <= 0:
        return None
    return wtk.dropout_multiplier(pp, seed, l, N, "cpu").to(like.dtype)


def replay_fwd(plan, sp, x0, c2, seed, grid=3):
    """Kernel 5a's data flow at the padded widths; returns what
    `stack_fwd_plain` does."""
    pp = wtk.pad_plan(plan)
    spp = wtk.pad_params(plan, pp, sp)
    rnd = wtk._rounder(plan)
    C, S, Ch, N, B = pp.C, pp.S, pp.Ch, x0.shape[0], plan.B
    tiles = -(-N // TILE)
    x = wtk.pad_cols(x0, C)
    cb = rnd(wtk.pad_cols(c2, pp.Ci))
    m0 = _mult(pp, seed, 0, N, x)
    xd = rnd(x * m0 if m0 is not None else x)       # the pre-pass
    acts = x.new_zeros(plan.L, 3, N, pp.AW)
    acts[0, 0, :, :C] = x
    skip = x.new_zeros(N, S)
    for l, d in enumerate(plan.dil):
        w = _layer_weights(pp, spp, l, rnd)
        b1 = spp.conv_b[l] + spp.cin_b[l]
        last = l == plan.L - 1
        m_next = None if last else _mult(pp, seed, l + 1, N, x)
        x_out, xd_next = x.new_zeros(N, C), x.new_zeros(N, C)
        h_scratch = x.new_zeros(N, Ch)
        for _, t in walk(tiles, grid):
            r0 = t * TILE
            rows = slice(r0, min(r0 + TILE, N))
            n = rows.stop - r0
            # product 1: the taps over row-shifted windows of xd, then cin
            a = torch.cat([window(xd, r0 - (2 - q) * d * B) for q in
                           range(3)] + [window(cb, r0)], 1)
            y = a @ w["w1"] + b1
            for c0 in range(0, Ch, 64):     # 64 gated channels a pass
                ch = slice(c0, c0 + 64)
                ta = torch.tanh(y[:n, ch])
                sb = torch.sigmoid(y[:n, Ch + c0:Ch + c0 + 64])
                acts[l, 1, rows, ch], acts[l, 2, rows, ch] = ta, sb
                h_scratch[rows, ch] = rnd(ta * sb)
            # product 2 on the tile's own h rows, read back by TMA
            o = window(h_scratch, r0) @ w["w2"]
            s = plan.scales[l] * (o[:n, :S] + spp.skip_b[l])
            skip[rows] = s if l == 0 else skip[rows] + s
            if last:
                continue
            xo = plan.c_res * (o[:n, S:] + spp.out_b[l] + x[rows])
            x_out[rows] = xo
            acts[l + 1, 0, rows, :C] = xo
            xd_next[rows] = rnd(xo * m_next[rows] if m_next is not None
                                else xo)
        x, xd = x_out, xd_next
    acts = acts.to(plan.acts_dtype)
    return skip[:, :plan.S], wtk.unpad_acts(plan, pp, acts)


def replay_bwd(plan, sp, acts, c2, dskip, seed, grid=3, sms=SMS):
    """Kernel 5b's data flow (gate, dx, wgrad, reduce a layer) at the
    padded widths; returns what `stack_bwd_plain` does."""
    pp = wtk.pad_plan(plan)
    spp = wtk.pad_params(plan, pp, sp)
    rnd = wtk._rounder(plan)
    C, G, S, Ci, Ch = pp.C, pp.G, pp.S, pp.Ci, pp.Ch
    N, B, L, dt = c2.shape[0], plan.B, plan.L, c2.dtype
    tiles = -(-N // TILE)
    acts = wtk.pad_acts(pp, acts).to(dt)
    dskip = wtk.pad_cols(dskip, S)
    cb = rnd(wtk.pad_cols(c2, Ci))
    rows_per, splits = wtk.wgrad_splits(pp, N, sms)
    assert rows_per % wtk.WGRAD_ROW_STEP == 0 and splits * rows_per >= N
    dres, dc = None, c2.new_zeros(N, Ci)
    g = {f: [None] * L for f in wtk.StackParams._fields}
    for l in reversed(range(L)):
        d = plan.dil[l]
        w = _layer_weights(pp, spp, l, rnd)
        x, ta, sb = acts[l, 0, :, :C], acts[l, 1, :, :Ch], acts[l, 2, :, :Ch]
        mult = _mult(pp, seed, l, N, c2)
        go, dy = c2.new_zeros(N, C + S), c2.new_zeros(N, G)
        xd, h = c2.new_zeros(N, C), c2.new_zeros(N, Ch)
        # gate: per-CTA column sums in tile order
        bpart = c2.new_zeros(grid, G + C + S)
        for b, t in walk(tiles, grid):
            r0 = t * TILE
            rows = slice(r0, min(r0 + TILE, N))
            n = rows.stop - r0
            res = plan.c_res * dres[rows] if dres is not None else \
                c2.new_zeros(n, C)
            v = torch.cat([res, plan.scales[l] * dskip[rows]], 1)
            go[rows] = rnd(v)
            bpart[b, G:] += v.sum(0)
            xd[rows] = rnd(x[rows] * mult[rows] if mult is not None
                           else x[rows])
            dh = window(go, r0) @ w["wos"].t()
            tv, sv = window(ta, r0), window(sb, r0)
            da = dh * sv * (1 - tv * tv)
            db = dh * tv * sv * (1 - sv)
            h[rows] = rnd(tv * sv)[:n]
            dy[rows] = rnd(torch.cat([da, db], 1))[:n]
            bpart[b, :G] += torch.cat([da, db], 1).sum(0)
        # dx: the taps over row-shifted windows of dy; dc on the unshifted
        dres_out = c2.new_zeros(N, C)
        for _, t in walk(tiles, grid):
            r0 = t * TILE
            rows = slice(r0, min(r0 + TILE, N))
            n = rows.stop - r0
            acc = sum(window(dy, r0 + (2 - k) * d * B) @ w["wconv"][k].t()
                      for k in range(3))[:n]
            if mult is not None:
                acc = acc * mult[rows]
            dres_out[rows] = (plan.c_res * dres[rows] if dres is not None
                              else 0) + acc
            dc[rows] = dc[rows] + (window(dy, r0) @ w["wcin"].t())[:n]
        # wgrad: per (output tile, split) partials, the fixed-order sum,
        # scattered by the reduce launch's tile map
        prods = [(xd, dy, (2 - k) * d * B) for k in range(3)] + \
            [(cb, dy, 0), (h, go, 0)]
        outs = []
        for P, Q, qoff in prods:
            K1, K2 = P.shape[1], Q.shape[1]
            out = c2.new_zeros(K1, K2)
            Pp = wtk.pad_cols(P, -(-K1 // TILE) * TILE)
            for i0 in range(0, K1, TILE):
                for j0 in range(0, K2, TILE):
                    parts = []
                    for s in range(splits):
                        rb = s * rows_per
                        nr = min(rows_per, N - rb)
                        parts.append(window(Pp, rb, nr)[:, i0:i0 + TILE].t()
                                     @ window(Q, rb + qoff, nr)[:,
                                                                j0:j0 + TILE])
                    tile = fixed_order_sum(parts)
                    ni = min(TILE, K1 - i0)
                    out[i0:i0 + ni, j0:j0 + TILE] = tile[:ni]
            outs.append(out)
        sums = fixed_order_sum(list(bpart))
        g["conv_w"][l] = torch.cat(outs[:3], 0)
        g["cin_w"][l], os_ = outs[3], outs[4]
        g["out_w"][l], g["skip_w"][l] = os_[:, :C], os_[:, C:]
        g["conv_b"][l] = g["cin_b"][l] = sums[:G]
        g["out_b"][l], g["skip_b"][l] = sums[G:G + C], sums[G + C:]
        dres = dres_out
    d_sp = wtk.StackParams(**{f: torch.cat(v, 0) if f.endswith("_w")
                              else torch.stack(v) for f, v in g.items()})
    d_sp = wtk.unpad_params(plan, pp, d_sp)
    return d_sp, dres[:, :plan.C].contiguous(), dc[:, :plan.Ci].contiguous()


def rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


# R, G, S, cin: the JAX kernel tests' widths and an uneven set (no width a
# multiple of a tile, G != 2R)
WIDTHS = {"jax-tests": (8, 16, 8, 10), "uneven": (24, 40, 16, 12)}


@pytest.mark.parametrize("B,T", [(1, 300), (3, 101)])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_replay_matches_plain(widths, B, T):
    """Forward and backward replays against the plain versions with f32
    weights, dropout 0.05: N = B·T rows not a multiple of
    the tile (3 and 3 tiles), 8 layers whose top dilation shifts the taps
    past N (every window outside [0, N) reads zeros), 3 persistent CTAs."""
    plan, sp, x0, c2, dskip = case(WIDTHS[widths], B, T, layers=8,
                                   stacks=1)
    ps, pa = wtk.stack_fwd_plain(plan, sp, x0, c2, 7)
    rs, ra = replay_fwd(plan, sp, x0, c2, 7)
    assert rel(rs, ps) <= 1e-5
    assert torch.equal(ra[0, 0], pa[0, 0])      # the pre-pass's saved x
    assert rel(ra, pa) <= 1e-5
    pb = wtk.stack_bwd_plain(plan, sp, pa, c2, dskip, 7)
    rb = replay_bwd(plan, sp, pa, c2, dskip, 7)
    for name, a, b in zip(list(wtk.StackParams._fields) + ["dx0", "dc"],
                          [*rb[0], rb[1], rb[2]], [*pb[0], pb[1], pb[2]]):
        assert a.shape == b.shape, name
        assert rel(a, b) <= 1e-5, name


@pytest.mark.parametrize("weight_bf16", [False, True])
def test_tap_operand_and_windows_bit_for_bit(weight_bf16):
    """The elementwise steps the kernels split across launches: xd
    prepared by the previous layer's epilogue (masks keyed by the source
    row, rounded to the weight type) is the plain version's dropped-out
    input bit for bit; the TMA windows of the persistent walk rebuild the
    causal shift with zeros before row 0 and past N; the walk covers each
    tile once; the weight-gradient splits cover [0, N) once."""
    plan, sp, x0, c2, _ = case(WIDTHS["uneven"], 3, 101, weight_bf16,
                               torch.float32)
    pp, rnd, N = wtk.pad_plan(plan), wtk._rounder(plan), x0.shape[0]
    x = wtk.pad_cols(x0, pp.C)
    for layer in range(3):
        kept = wtk.stack_keep(plan, 7, layer, N, "cpu")
        want = rnd(torch.where(kept, x0 * float(np.float32(1 / plan.keep)),
                               x0.new_zeros(())))
        got = rnd(x * wtk.dropout_multiplier(pp, 7, layer, N, "cpu"))
        assert torch.equal(got[:, :plan.C], want)
        assert not got[:, plan.C:].any()
    for shift in (0, 3, 2 * 64 * 3, N + 5):
        for grid in (1, 2, 3):
            rebuilt = x.new_zeros(N, pp.C)
            seen = []
            for _, t in walk(-(-N // TILE), grid):
                r0 = t * TILE
                n = min(TILE, N - r0)
                rebuilt[r0:r0 + n] = window(x, r0 - shift)[:n]
                seen.append(t)
            assert sorted(seen) == list(range(-(-N // TILE)))
            assert torch.equal(rebuilt, wtk._shift_down(x, shift))
    for n in (1, 63, 300, 128_000):
        rows, splits = wtk.wgrad_splits(pp, n, SMS)
        assert rows % wtk.WGRAD_ROW_STEP == 0
        assert (splits - 1) * rows < n <= splits * rows
        assert splits * wtk.wgrad_tiles(pp) <= max(SMS, wtk.wgrad_tiles(pp))


def test_tf32_planes():
    """The f32 kernels' weight planes: hi and lo are TF32 values (the low
    13 bits clear), hi is w rounded to nearest (ties away), and hi + lo
    keeps w to ~2^-22 of it."""
    w = torch.tensor(np.random.default_rng(3).normal(size=4096) * 3,
                     dtype=torch.float32)
    hi, lo = wtk.split_tf32(w)
    for p in (hi, lo):
        assert not (p.view(torch.int32) & 0x1FFF).any()
    assert float(((w - hi).abs() / w.abs()).max()) <= 2.0 ** -11
    assert float(((w - hi - lo).abs() / w.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("widths,drop", [("jax-tests", 0.0),
                                         ("uneven", 0.05)])
def test_replay_matches_jax_kernel(monkeypatch, widths, drop):
    """FusedStack with the replays in place of the plain versions against
    the JAX kernel in interpret mode, forward and gradients: dropout off,
    or (uneven widths) 0.05 with every element kept, which the
    interpret-mode kernel's zero PRNG bits equal."""
    kw = UNEVEN if widths == "uneven" else {}
    jcfg = jcfg_of(dropout=drop, **kw)
    if drop:
        monkeypatch.setattr(wtk, "keep_bits", lambda key, row0, rows, C,
                            keep, device="cpu": torch.ones(
                                rows, C, dtype=torch.bool))
    monkeypatch.setattr(wtk, "stack_fwd", replay_fwd)
    monkeypatch.setattr(wtk, "stack_bwd", replay_bwd)
    compare(jcfg, lambda p, x, c: jax_apply(jcfg, jax_extract(p, jcfg), x,
                                            c, 3, Tt=4, interpret=True),
            "bfloat16")
