"""The serve decode's cluster kernel (csrc/decoder_rows.cu) replayed on
the CPU, and the WaveNet sampler's route by width.

The decode kernel cannot run here, so a PyTorch replay of its data flow
stands in for it: rows padded to whole 8-row clusters; each CTA's
products taken from its slice of the packed weight stream
(`dk.rows_stream`), read back independently of the packing through the
mma fragment positions of the PTX ISA (tests/torch_port_helpers.py
`mma_a_positions`), in k-steps of 16 (bf16) or 8 (f32), each from zero
and added in step order; every CTA the whole prenet from the shared
chunks; the LSTMs by own gate columns and units; the query's and the
projection's partials added in rank order 0..CS-1; the energies by each
CTA's input positions; the context by its columns. At B 1, 3 and 9, CS 8
and 16, bf16 and f32 weights, at tests/torch_port_helpers.py's small
widths (dropout 0), it is held against the kernel's plain version
(`dk.decode_plain`, `dk.decode_block_plain`) and against the TPU kernels
`build_decoder_kernel` / `build_decoder_block_kernel(interpret=True)`:

- f32: the same function in another sum order: against the plain
  version frames, stop probabilities, alignments and every state field
  within F32_RTOL of their scale; against the TPU kernels
  tests/test_torch_decoder.py's tolerances (frames 2e-4, stops 2e-5,
  states 2e-4; alignments 8e-3, which the TPU kernels store in bf16);
- bf16: another sum order may move a bf16 rounding by one step, which the
  free run carries on, so each field is held as chip_smoke.py holds the
  kernel: its largest difference within CAP_STEPS bf16 steps of its scale
  and its mean difference at most MEAN_SHARE of that of the control (the
  plain version with the same weights in f32, nothing rounded), which
  lies ~5e-3 off on the frames, so a replay without the roundings fails
  it.

Also the repairs of the WaveNet stage: `WaveNetSynthesizer` on a device
it takes for a card (the device check monkeypatched) at R 120, which the
sampler kernel's tiles refuse, routes to the plain sampler and matches
the JAX synthesizer's scan; the former bare asserts raise ValueError,
under `python -O` too.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tacotron2_tpu.models.tacotron.decoder import Decoder
from tacotron2_tpu.models.wavenet.model import WaveNet as FlaxWaveNet
from tacotron2_tpu.ops.tacotron_decoder_kernel import (
    build_decoder_block_kernel, build_decoder_kernel, extract_decoder_params,
    init_decoder_state)
from tacotron2_tpu.synth.wavenet_synth import \
    WaveNetSynthesizer as JaxSynthesizer
from tacotron2_tpu_torch.config import Config as TorchConfig
from tacotron2_tpu_torch.models.tacotron import decoder as tdec
from tacotron2_tpu_torch.models.tacotron.attention import (
    NEG_INF, fold_location, identity, window_forbidden)
from tacotron2_tpu_torch.models.wavenet.model import WaveNet as TorchWaveNet
from tacotron2_tpu_torch.models.wavenet.sampler import extract_sampler_params
from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
from tacotron2_tpu_torch.ops import wavenet_kernel as wk
from tacotron2_tpu_torch.synth.wavenet_synth import WaveNetSynthesizer
from test_torch_wavenet import MELS as WN_MELS
from test_torch_wavenet import head_cfg
from torch_port_helpers import (mma_a_positions, small_cfg, to_numpy,
                                torch_cfg)

T_IN, M, STEPS, K_BLOCK = 20, 48, 6, 3
NW, KC = dk.STREAM_NW, dk.STREAM_KC
F32_RTOL = 1e-5
TPU_F32_ATOL = dict(frames=2e-4, stops=2e-5, state=2e-4, align=8e-3)
CAP_STEPS, MEAN_SHARE = 4, 0.1
BATCHES, CLUSTERS, WEIGHTS = [1, 3, 9], [8, 16], ["bfloat16", "float32"]


def _cfgs(wd):
    tc = dict(fused_decoder_dtype=wd)
    jcfg, tcfg = small_cfg(), torch_cfg()
    return (jcfg.replace(tacotron=dataclasses.replace(jcfg.tacotron, **tc)),
            tcfg.replace(tacotron=dataclasses.replace(tcfg.tacotron, **tc)))


_cache = {}


def _cached(key, make):
    """One value a key for the module (the TPU kernels' interpret-mode
    runs are the slow part; they do not depend on the cluster size)."""
    if key not in _cache:
        _cache[key] = make()
    return _cache[key]


def _params():
    """Flax decoder weights (they do not depend on the batch)."""
    def make():
        B = 2
        z = jnp.zeros((B, T_IN, M))
        return to_numpy(Decoder(config=small_cfg()).init(
            dict(params=jax.random.PRNGKey(0), dropout=jax.random.PRNGKey(1),
                 zoneout=jax.random.PRNGKey(2)),
            B, STEPS, z[..., :16], z, jnp.ones((B, T_IN), bool),
            method=Decoder.autoregressive)["params"])
    return _cached("params", make)


def _setup(B):
    """Flax decoder weights and inputs at batch B (seeded by B)."""
    rng = np.random.default_rng(B)
    memory = rng.normal(size=(B, T_IN, M)).astype(np.float32)
    lens = np.maximum(T_IN - 3 * np.arange(B), 4)
    mask = np.arange(T_IN)[None, :] < lens[:, None]
    keys = (rng.normal(size=(B, T_IN, 16)) * 0.3).astype(np.float32)
    return _params(), keys, memory, mask


# ------------------------------------------------------------ the stream


def _unpack(vals, rows, K, ks):
    """One product's values of the stream (1-D, weight dtype) -> its
    zero-padded matrix A [rows padded to 16·NW, K padded to ks·KC], each
    value placed by the mma fragment position of its lane and register
    (group, chunk, warp, k-tile, lane, register order)."""
    ng = -(-(-(-rows // 16)) // NW)
    kp = -(-K // (ks * KC)) * ks * KC
    nck = kp // (ks * KC)
    pos = np.asarray(mma_a_positions(ks))            # [32, regs, 2]
    g, c, w, kk, lane, e = np.ix_(range(ng), range(nck), range(NW),
                                  range(KC), range(32),
                                  range(pos.shape[1]))
    row = (g * NW + w) * 16 + pos[lane, e, 0]
    col = (c * KC + kk) * ks + pos[lane, e, 1]
    shape = np.broadcast(row, col).shape
    a = torch.zeros(ng * NW * 16, kp)
    n = int(np.prod(shape))
    a[torch.as_tensor(np.broadcast_to(row, shape).ravel()),
      torch.as_tensor(np.broadcast_to(col, shape).ravel())] = \
        vals[:n].float()
    return a, n


def _stream_mats(dp, cs):
    """Each CTA's product matrices read back from `dk.rows_stream`, checked
    against the weights they must hold: {name: [cs, rows_p, kp]}."""
    U, P = dp.l1_wh.shape[0], dp.pre_w0.shape[1]
    Mw, mels = dp.l1_wc.shape[0], dp.pre_w0.shape[0]
    Uc, Mc = U // cs, Mw // cs
    FO, A = dp.proj_b.shape[0], dp.wq.shape[1]
    bf16 = dp.l1_wp.dtype == torch.bfloat16
    ks, wdt = (16, torch.bfloat16) if bf16 else (8, torch.float32)
    flat = dk.rows_stream(dp, cs).view(wdt)
    l1 = torch.cat([dp.l1_wp, dp.l1_wc, dp.l1_wh], 0).float()
    l2 = torch.cat([dp.l2_wx, dp.l2_wh], 0).float()
    proj = torch.cat([dp.proj_wo, dp.proj_wc], 0).float()
    # a CTA's gate columns unit by unit, (i, j, f, o) of each
    cols = lambda c: torch.stack([torch.arange(g * U + c * Uc,
                                               g * U + (c + 1) * Uc)
                                  for g in range(4)], 1).reshape(-1)
    own = {"l1": lambda c: l1[:, cols(c)].t(),
           "l2": lambda c: l2[:, cols(c)].t(),
           "wq": lambda c: dp.wq.float()[c * Uc:(c + 1) * Uc].t(),
           "proj": lambda c: torch.cat([proj[c * Uc:(c + 1) * Uc],
                                        proj[U + c * Mc:U + (c + 1) * Mc]]
                                       ).t()}
    shapes = {"l1": (4 * Uc, P + Mw + U), "l2": (4 * Uc, 2 * U),
              "wq": (A, Uc), "proj": (FO, Uc + Mc)}
    mats, o = {k: [] for k in own}, 0
    for c in range(cs):
        for name, want in own.items():
            a, n = _unpack(flat[o:], *shapes[name], ks)
            o += n
            rows, K = shapes[name]
            assert torch.equal(a[:rows, :K], want(c)), (name, c)
            assert not a[rows:].any() and not a[:, K:].any(), (name, c)
            mats[name].append(a)
    for name, w in (("pre0", dp.pre_w0), ("pre1", dp.pre_w1)):
        a, n = _unpack(flat[o:], P, w.shape[0], ks)
        o += n
        assert torch.equal(a[:P, :w.shape[0]], w.float().t()), name
        assert not a[P:].any() and not a[:, w.shape[0]:].any(), name
        mats[name] = [a] * cs
    assert o == flat.numel()
    return {k: torch.stack(v) for k, v in mats.items()}, ks


def _kprod(a, g, ks):
    """g [n, K] against a [m, kp]: out [n, m], each k-step of ks products
    from zero, added in f32 in step order (the kernel's mma k-steps)."""
    n, K = g.shape
    mp, kp = a.shape
    g = F.pad(g, (0, kp - K)).reshape(n, kp // ks, ks)
    part = torch.einsum("ntk,mtk->tnm", g, a.reshape(mp, kp // ks, ks))
    out = torch.zeros(n, mp)
    for p in part:
        out += p
    return out


# ------------------------------------------------------------ the replay


def _replay(dp, cfg, keys, memory, mask, state, drop, cs, casts):
    """csrc/decoder_rows.cu's data flow in PyTorch for K = drop.shape[1]
    steps from `state`: `decode_block`'s contract."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r, zo = tc.outputs_per_step, float(tc.zoneout_rate)
    B, T, Mw = memory.shape
    U, P = dp.l1_wh.shape[0], dp.pre_w0.shape[1]
    Uc, Mc, Tc = U // cs, Mw // cs, -(-T // cs)
    FO, A = dp.proj_b.shape[0], dp.wq.shape[1]
    mats, ks = _stream_mats(dp, cs)
    bf16 = ks == 16
    rg = tdec.round_bf16 if bf16 else identity
    rc = lambda on, x: rg(x) if on else x
    wp, b_eff = fold_location(dp.loc_k, dp.loc_b, dp.wloc, dp.b_a)
    wp = rg(wp)
    KW = wp.shape[0]
    pad = (KW - 1) // 2
    v_a = rc(casts.v_a, dp.v_a.float())
    l1_b, l2_b = (dk.split_gates(b.float(), cs) for b in (dp.l1_b, dp.l2_b))
    n8 = -(-B // 8) * 8                       # whole 8-row clusters
    rp = lambda x: F.pad(x, [0, 0] * (x.dim() - 1) + [0, n8 - B])
    keys_eff = rp(rc(casts.keys, keys.float() + b_eff))
    mem, msk = rp(rg(memory.float())), rp(mask.float())
    drop = rp(drop.float())
    st = {k: rp(getattr(state, k).float()) for k in
          ("xprev", "ctx", "h1", "h2", "c1", "c2", "cum")}
    pmax = rp(state.pmax.long())
    units = lambda c: slice(c * Uc, (c + 1) * Uc)

    def lstm(w, bias, x, c_st, h_st):
        """each CTA's gate columns (unit by unit) and units; the new h of
        all units"""
        c_new, h_new = c_st.clone(), h_st.clone()
        for c in range(cs):
            z = _kprod(w[c], x, ks)[:, :4 * Uc]       # (unit, gate)
            z = z.reshape(-1, Uc, 4).transpose(1, 2).reshape(-1, 4 * Uc)
            z = z + bias[c]
            i, j, f, o = z.chunk(4, -1)
            nc = torch.sigmoid(f) * c_st[:, units(c)] + \
                torch.sigmoid(i) * torch.tanh(j)
            nh = torch.sigmoid(o) * torch.tanh(nc)
            c_new[:, units(c)] = (1 - zo) * nc + zo * c_st[:, units(c)]
            h_new[:, units(c)] = (1 - zo) * nh + zo * h_st[:, units(c)]
        return c_new, h_new

    frames, stops, aligns = [], [], []
    for t in range(drop.shape[1]):
        h0 = torch.relu(_kprod(mats["pre0"][0], rg(st["xprev"]), ks)[:, :P]
                        + dp.pre_b0.float()) * drop[:, t, 0]
        hpre = torch.relu(_kprod(mats["pre1"][0], rg(h0), ks)[:, :P]
                          + dp.pre_b1.float()) * drop[:, t, 1]
        st["c1"], st["h1"] = lstm(mats["l1"], l1_b, rg(torch.cat(
            [hpre, st["ctx"], st["h1"]], 1)), st["c1"], st["h1"])
        st["c2"], h2 = lstm(mats["l2"], l2_b, rg(torch.cat(
            [st["h1"], st["h2"]], 1)), st["c2"], st["h2"])
        st["h2"] = h2
        q = torch.zeros(n8, A)
        for c in range(cs):                   # partials in rank order
            q += _kprod(mats["wq"][c], rg(h2[:, units(c)]), ks)[:, :A]
        cumr = F.pad(rg(st["cum"]), (pad, KW - 1 - pad))
        energy = torch.zeros(n8, T)
        for c in range(cs):                   # each CTA's positions
            for tt in range(c * Tc, min((c + 1) * Tc, T)):
                loc = cumr[:, tt:tt + KW] @ wp
                e = rc(casts.tanh, torch.tanh(keys_eff[:, tt] + q + loc))
                energy[:, tt] = e @ v_a
        if tc.synthesis_constraint:
            energy = energy.masked_fill(window_forbidden(
                T, pmax, tc.attention_win_size,
                tc.synthesis_constraint_type), NEG_INF)
        energy = torch.where(msk > 0, energy,
                             torch.full_like(energy, NEG_INF))
        if tc.smoothing:
            ex = torch.sigmoid(energy) * msk
        else:
            ex = torch.exp(energy - energy.max(-1, keepdim=True).values) * msk
        al = ex / ex.sum(-1, keepdim=True)
        st["cum"] = st["cum"] + al
        if tc.synthesis_constraint:
            pmax = al.argmax(-1)
        ctx = torch.zeros(n8, Mw)
        for c in range(cs):                   # each CTA's columns
            cols = slice(c * Mc, (c + 1) * Mc)
            ctx[:, cols] = torch.einsum("nt,ntm->nm", rg(al), mem[:, :, cols])
        st["ctx"] = ctx
        proj = dp.proj_b.float().expand(n8, FO).clone()
        for c in range(cs):
            g = rg(torch.cat([h2[:, units(c)], ctx[:, c * Mc:(c + 1) * Mc]],
                             1))
            proj = proj + _kprod(mats["proj"][c], g, ks)[:, :FO]
        st["xprev"] = proj[:, (r - 1) * mels:r * mels]
        frames.append(proj[:B, :r * mels])
        stops.append(torch.sigmoid(proj[:B, r * mels:]))
        aligns.append(al[:B])
    K = drop.shape[1]
    out_state = tdec.DecoderKernelState(
        pmax=pmax[:B].to(torch.int32), **{k: v[:B] for k, v in st.items()})
    return (torch.stack(frames, 1).reshape(B, K * r, mels),
            torch.stack(stops, 1).reshape(B, K * r),
            torch.stack(aligns, 2), out_state)


# ------------------------------------------------------------ the gates


def _fields(out):
    f, s, a, st = out
    d = dict(frames=f, stops=s, align=a)
    d.update({k: getattr(st, k) for k in ("xprev", "ctx", "h1", "h2", "c1",
                                          "c2", "cum")})
    return {k: torch.as_tensor(np.array(v, np.float32)) for k, v in
            d.items()}


def _hold(got, want, wd, control=None, f32_atol=None):
    """Each field of `got` against `want` (see the module note)."""
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (name, g.shape, w.shape)
        d = (g - w).abs()
        scale = max(float(w.abs().max()), 1e-3)
        if wd == "float32":
            tol = F32_RTOL * scale if f32_atol is None else f32_atol[
                name if name in f32_atol else "state"]
            assert float(d.max()) <= tol, (name, float(d.max()), tol)
            continue
        cap = CAP_STEPS * 2.0 ** -8 * scale
        c = (control[name] - w).abs()
        assert float(d.max()) <= cap, (name, float(d.max()), cap)
        assert float(d.mean()) <= MEAN_SHARE * float(c.mean()) + 1e-9, (
            name, float(d.mean()), float(c.mean()))


def _hold_tpu(got, tpu, wd, control):
    """`_hold` against a TPU kernel's outputs: f32 at tests/
    test_torch_decoder.py's tolerances; bf16 by the gate, but the
    alignments, which the TPU kernels store in bf16, within its 8e-3."""
    if wd == "bfloat16":
        np.testing.assert_allclose(got["align"], tpu.pop("align"), rtol=0,
                                   atol=TPU_F32_ATOL["align"])
    _hold({k: got[k] for k in tpu}, tpu, wd,
          None if control is None else {k: control[k] for k in tpu},
          TPU_F32_ATOL)


def _control(dp, run):
    """The plain version with the same weights in f32, nothing rounded."""
    return _fields(run(tk.cast_params(dp, torch.float32)))


def _check_control(control, want):
    """The control lies off the rounded function (the roundings' size,
    ~5e-3 on the frames here), so the mean share has teeth: a replay that
    did not round as the TPU kernels do would fail it."""
    assert float((control["frames"] - want["frames"]).abs().max()) > 1e-3


# ------------------------------------------------------------ the tests


@pytest.mark.parametrize("cs", CLUSTERS)
@pytest.mark.parametrize("wd", WEIGHTS)
def test_rows_stream_holds_each_ctas_tiles(wd, cs):
    """`dk.rows_stream` read back through the mma fragment positions gives
    each CTA's gate columns of both LSTMs, its rows of the query weight and
    of the projection, and the prenet once, zero past the real rows and k;
    `pack_weights` packs it at the cluster size the widths take, for the
    autoregressive and the teacher-forced decode alike (the latter's
    weights in the train dtype)."""
    params = _setup(3)[0]
    _, cfg = _cfgs(wd)
    dp = dk.extract_decoder_params({"decoder": params}, cfg, device="cpu")
    _stream_mats(dp, cs)
    kw = dk.pack_weights(dp)
    assert kw.rows.cs == dk.rows_cluster_size(32, M) == 16
    assert torch.equal(kw.rows.stream, dk.rows_stream(dp, 16))
    other = torch.float32 if wd == "bfloat16" else torch.bfloat16
    dp_t = tk.cast_params(dp, other)
    assert torch.equal(dk.pack_weights(dp_t).rows.stream,
                       dk.rows_stream(dp_t, 16))
    assert dk.rows_cluster_size(32, 40) == 8


def _whole_runs(B, wd):
    """(kernel weights, config, inputs, the plain whole decode, the TPU
    kernel's) at batch B: STEPS steps, no early stop."""
    params, keys, memory, mask = _setup(B)
    jcfg, cfg = _cfgs(wd)
    dp = dk.extract_decoder_params({"decoder": params}, cfg, device="cpu")
    args = (torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask))
    drop = tdec.drop_masks(cfg, B, STEPS, device="cpu")
    plain = lambda d: dk.decode_block_plain(
        d, cfg, *args, dk.init_decoder_state(cfg, B, T_IN, M, "cpu"), drop,
        casts=tdec.WHOLE)
    def tpu():
        run = build_decoder_kernel(jcfg, B, T_IN, STEPS, M,
                                   weight_dtype=getattr(jnp, wd),
                                   interpret=True)
        return [np.array(x, np.float32) for x in run(
            extract_decoder_params({"decoder": params}, jcfg),
            jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask), 3)]
    return dp, cfg, args, drop, plain, _cached(("whole", B, wd), tpu)


@pytest.mark.parametrize("cs", CLUSTERS)
@pytest.mark.parametrize("wd", WEIGHTS)
@pytest.mark.parametrize("batch", BATCHES)
def test_cluster_data_flow_replays_the_whole_decode(batch, wd, cs):
    """The whole decode (kernel 1's function, `WHOLE` roundings) through
    the kernel's data flow against the plain decode and against
    `build_decoder_kernel(interpret=True)`, every step's frames, stop
    probabilities and alignments and the state after them."""
    dp, cfg, args, drop, plain, jax_out = _whole_runs(batch, wd)
    st0 = dk.init_decoder_state(cfg, batch, T_IN, M, "cpu")
    with torch.no_grad():
        got = _fields(_replay(dp, cfg, *args, st0, drop, cs, tdec.WHOLE))
        want = _fields(plain(dp))
        # the whole decode's own entry point is the same function
        f_d, s_d, a_d = dk.decode_plain(dp, cfg, *args, drop, steps=STEPS)
        assert torch.equal(f_d, want["frames"])
        control = _control(dp, plain) if wd == "bfloat16" else None
    if control is not None:
        _check_control(control, want)
    _hold(got, want, wd, control)
    tpu = {k: torch.as_tensor(np.array(v, np.float32)) for k, v in
           zip(("frames", "stops", "align"), jax_out)}
    _hold_tpu(got, tpu, wd, control)


@pytest.mark.parametrize("cs", CLUSTERS)
@pytest.mark.parametrize("wd", WEIGHTS)
@pytest.mark.parametrize("batch", BATCHES)
def test_cluster_data_flow_replays_the_block_decode(batch, wd, cs):
    """Kernel 3's route without emt_attn: two chained K_BLOCK-step blocks
    from carried state through the kernel's data flow (`BLOCK` roundings:
    keys, v_a and the tanh too) against the plain block decode and
    `build_decoder_block_kernel(interpret=True)`, with every state field
    after each block."""
    params, keys, memory, mask = _setup(batch)
    jcfg, cfg = _cfgs(wd)
    dp = dk.extract_decoder_params({"decoder": params}, cfg, device="cpu")
    args = (torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask))
    drop = tdec.drop_masks(cfg, batch, K_BLOCK, device="cpu")
    mels = cfg.audio.num_mels

    def tpu():
        """both blocks of the TPU block kernel: outputs and state fields"""
        run = build_decoder_block_kernel(jcfg, batch, T_IN, K_BLOCK, M,
                                         weight_dtype=getattr(jnp, wd),
                                         interpret=True)
        dp_j = extract_decoder_params({"decoder": params}, jcfg)
        st_j = init_decoder_state(jcfg, batch, T_IN, M)
        blocks = []
        for blk in range(2):
            f_j, s_j, a_j, st_j = run(dp_j, *(jnp.asarray(x) for x in (
                keys, memory, mask)), st_j, 3 + blk)
            blocks.append(dict(
                frames=f_j, stops=s_j, align=a_j,
                xprev=np.asarray(st_j.xprev)[:, :mels], ctx=st_j.ctx,
                h1=st_j.h1, h2=st_j.h2, c1=st_j.c1, c2=st_j.c2,
                cum=np.asarray(st_j.cum)[:, :T_IN],
                pmax=np.asarray(st_j.pmax)[:, 0]))
        return blocks
    tpu_blocks = _cached(("block", batch, wd), tpu)
    st_r = st_p = dk.init_decoder_state(cfg, batch, T_IN, M, "cpu")
    dp32 = tk.cast_params(dp, torch.float32)
    st_c = st_p
    for blk in range(2):
        with torch.no_grad():
            got = _replay(dp, cfg, *args, st_r, drop, cs, tdec.BLOCK)
            want = dk.decode_block_plain(dp, cfg, *args, st_p, drop,
                                         casts=tdec.BLOCK)
            ctl = dk.decode_block_plain(dp32, cfg, *args, st_c, drop,
                                        casts=tdec.BLOCK)
        g, w = _fields(got), _fields(want)
        control = _fields(ctl) if wd == "bfloat16" else None
        _hold(g, w, wd, control)
        tpu = {k: torch.as_tensor(np.array(v, np.float32)) for k, v in
               tpu_blocks[blk].items() if k != "pmax"}
        _hold_tpu(g, tpu, wd, control)
        assert torch.equal(got[3].pmax, want[3].pmax)
        np.testing.assert_array_equal(got[3].pmax, tpu_blocks[blk]["pmax"])
        # each side carries its own state into the next block, as a chain
        # of launches does
        st_r, st_p, st_c = got[3], want[3], ctl[3]


def test_rows_state_round_trip():
    """`pack_rows_state` lays a row out as [xprev | ctx | h1 | h2 | c1 |
    c2] and `unpack_rows_state` inverts it."""
    cfg = torch_cfg()
    B, mels, U = 3, cfg.audio.num_mels, cfg.tacotron.decoder_lstm_units
    g = torch.Generator().manual_seed(0)
    st = dk.init_decoder_state(cfg, B, T_IN, M, "cpu")
    st = st._replace(**{k: torch.randn(getattr(st, k).shape, generator=g)
                        for k in ("xprev", "c1", "h1", "c2", "h2", "ctx",
                                  "cum")},
                     pmax=torch.arange(B, dtype=torch.int32))
    vec, cum, pmax = dk.pack_rows_state(st)
    assert vec.shape == (B, mels + M + 4 * U)
    assert torch.equal(vec[:, mels:mels + M], st.ctx)
    assert torch.equal(vec[:, -U:], st.c2)
    back = dk.unpack_rows_state(vec, cum, pmax, mels, M)
    for k in st._fields[:-1]:
        assert torch.equal(getattr(back, k), getattr(st, k)), k
    assert back.ctx_emt is None


# ------------------------------------------------- the WaveNet stage


def _r120():
    """tests/test_torch_wavenet.py's Gaussian head with R 120, which the
    sampler kernel's 16-wide tiles refuse, its noise suppressed (every
    draw is the mean, so the JAX scan's noise does not matter)."""
    cfgs = [head_cfg("gaussian"), head_cfg("gaussian", TorchConfig)]
    cfgs = [c.replace(wavenet=dataclasses.replace(
        c.wavenet, residual_channels=120)) for c in cfgs]
    model = FlaxWaveNet(config=cfgs[0])
    c = np.random.default_rng(0).uniform(0, 1, (2, 6, WN_MELS)).astype(
        np.float32)
    params = to_numpy(model.init(
        dict(params=jax.random.PRNGKey(0), dropout=jax.random.PRNGKey(1)),
        jnp.zeros((2, 24, 1)), jnp.asarray(c), train=False)["params"])
    fc2 = params["final_convolution_2"]["Dense_0"]
    fc2["kernel"], fc2["bias"] = fc2["kernel"].copy(), fc2["bias"].copy()
    fc2["bias"][1], fc2["kernel"][:, 1] = -30.0, 0.0
    return cfgs, params


class _NoLibrary(Exception):
    pass


def test_synthesizer_routes_unsupported_widths_to_the_plain_sampler(
        monkeypatch):
    """On a card (the device check monkeypatched, so the test runs here)
    `sampler_supported` refuses R 120 before any library is loaded, so
    `WaveNetSynthesizer` packs no kernel weights and samples through the
    plain sampler, as the JAX synthesizer scans where its kernel is not
    eligible: its wavs match the JAX synthesizer's (tests/
    test_torch_wavenet_synth.py's 2e-4). A width the tiles take goes on to
    the kernel's own check (`taco_sampler_supported`)."""
    (jcfg, tcfg), params = _r120()

    def no_lib():
        raise _NoLibrary
    monkeypatch.setattr(wk, "_lib", no_lib)
    monkeypatch.setattr(wk, "_on_card", lambda device: True)
    assert not wk.sampler_supported(tcfg)
    assert not wk.sampler_supported(tcfg, torch.bfloat16)
    with pytest.raises(_NoLibrary):
        wk.sampler_supported(head_cfg("gaussian", TorchConfig))
    ts = WaveNetSynthesizer(tcfg, params, device="cpu")
    assert ts.sampler_kernel is None
    rng = np.random.default_rng(1)
    mels = [rng.uniform(-4, 4, (f, WN_MELS)).astype(np.float32)
            for f in (5, 7)]
    got = ts.synthesize(mels)
    want = JaxSynthesizer(jcfg, params, seed=0).synthesize(mels)
    assert [len(w) for w in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=2e-4)


def test_sample_without_kernel_weights_still_raises_on_cuda_tensors():
    """`wk.sample` launches the kernel or raises for CUDA tensors: the
    width-chosen route lives in the synthesizers, not in a fallback."""
    cfg = head_cfg("gaussian", TorchConfig)

    class _Cuda:                  # what `sample` reads of a CUDA tensor
        device = torch.device("cuda")
    with pytest.raises(ValueError, match="kernel_weights"):
        wk.sample(None, cfg, _Cuda(), None)


REFUSALS = {"upsample_type": dict(upsample_type="Bilinear"),
            "cin_channels": dict(cin_channels=0),
            "gin_channels": dict(gin_channels=4),
            "kernel_size": dict(kernel_size=2)}
# the options whose variants the JAX package fails on as well: an unknown
# upsample type (its UpsampleNetwork raises ValueError) and vocoding
# without local conditioning (no upsample network: an AttributeError)
RAISES = ("upsample_type", "cin_channels")


def _build_or_vocode(cfg):
    """Build the WaveNet and upsample one mel, as a synthesizer does."""
    model = TorchWaveNet(cfg)
    model.upsample(torch.zeros(1, 3, cfg.wavenet.cin_channels))
    return model


@pytest.mark.parametrize("option", list(REFUSALS))
def test_wavenet_refusals_raise_value_error(option):
    """The WaveNet options the JAX package fails on raise ValueError
    naming the option (not bare asserts): an unknown upsample type when
    the model is built, cin_channels <= 0 when a mel is vocoded. Global
    conditioning and kernel_size 2 are taken: the model builds, vocodes
    and gives the sampler its parameters."""
    cfg = head_cfg("gaussian", TorchConfig)
    cfg = cfg.replace(wavenet=dataclasses.replace(cfg.wavenet,
                                                  **REFUSALS[option]))
    if option in RAISES:
        with pytest.raises(ValueError, match=option):
            _build_or_vocode(cfg)
        return
    from tacotron2_tpu_torch.convert import wavenet_to_flax
    model = _build_or_vocode(cfg)
    sp = extract_sampler_params(wavenet_to_flax(model), cfg, "cpu")
    assert len(sp.layers) == cfg.wavenet.layers


def test_wavenet_refusals_hold_under_python_O():
    """`python -O` strips asserts; the refusals still raise."""
    code = ("import dataclasses\n"
            "import torch\n"
            "from tacotron2_tpu_torch.config import Config\n"
            "from tacotron2_tpu_torch.models.wavenet.model import WaveNet\n"
            "assert False, 'asserts run'\n")
    checks = ("cfg = Config()\n"
              "for kw in ({opts}):\n"
              "    c = cfg.replace(wavenet=dataclasses.replace(cfg.wavenet, "
              "**kw))\n"
              "    try:\n"
              "        WaveNet(c).upsample(torch.zeros(1, 3, 80))\n"
              "    except ValueError:\n"
              "        continue\n"
              "    raise SystemExit(f'no ValueError for {{kw}}')\n"
              "print('refused')\n").format(
        opts=", ".join(repr(REFUSALS[k]) for k in RAISES))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-O", "-c", code + checks],
                         capture_output=True, text=True, cwd=root,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"
