"""Kernel 4a, the teacher-forced mode of csrc/decoder_rows.cu, replayed on
the CPU.

The kernel cannot run here, so a PyTorch replay of its data flow stands in
for it, as tests/test_torch_decode_rows.py replays the autoregressive
mode: rows padded to whole 8-row clusters; each CTA's products taken from
its slice of the packed weight stream (`dk.rows_stream`), read back through
the mma fragment positions, in k-steps of 16 (bf16) or 8 (f32), each from
zero and added in step order; every CTA the whole prenet; the LSTMs by own
gate columns, laid out unit by unit, and own units; the query's and the
projection's partials added in rank order 0..CS-1; the energies by each
CTA's input positions; the context by its columns. On top of that the five
places where the teacher-forced mode differs: step t's frame is teacher[t]
where coins[t] is set; stop logits; no window constraint, softmax, keys
and v_a unrounded; the alignments; and in train mode zoneout by the masks
and the residuals each CTA writes (z1 and z2 from the (unit, gate) layout
into the natural (i, j, f, o) x U order).

At tests/torch_port_helpers.py's small widths (U 32, M 48, T_in 20, 6
steps), B 1, 9 and 16, CS 8 and 16, bf16 and f32 weights, coins all set
and mixed, eval (the EMA mix) and train mode (Bernoulli masks, dropout
0.5), it is held against the plain versions (`teacher_forced`,
`teacher_forced_train`) with the same multipliers and masks, and against
the TPU kernel `build_train_fwd(interpret=True)`, run as
tests/test_train_kernel.py runs it:

- f32: the same function in another sum order: frames, stop logits,
  alignments and every residual within F32_RTOL of their scale of the
  plain version's, and within tests/test_train_kernel.py's 3e-5
  (alignments and cumulative alignments 1e-5) of the TPU kernel's;
- bf16: another sum order may move a bf16 rounding by one step, which the
  recurrence carries on, so each field is held as tests/
  test_torch_decode_rows.py holds it: its largest difference within
  CAP_STEPS bf16 steps of its scale and its mean difference at most
  MEAN_SHARE of that of the control (the plain version with the same
  weights in f32, nothing rounded); against the TPU kernel, which stores
  its residuals in bf16, the residuals rounded alike.

The TPU kernel draws its dropout and zoneout from the TPU PRNG, whose bits
are zero in interpret mode: it keeps every prenet unit at 1/keep and takes
every new LSTM state, which the port's multipliers of 1/keep and all-set
masks reproduce.
"""

import dataclasses
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tacotron2_tpu.ops.tacotron_train_kernel import (
    build_train_fwd, extract_decoder_params_traced)
from tacotron2_tpu_torch.models.tacotron import decoder as tdec
from tacotron2_tpu_torch.models.tacotron.attention import (
    NEG_INF, fold_location, identity)
from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
from test_torch_decode_rows import (F32_RTOL, M, T_IN, _cached, _hold,
                                    _kprod, _setup, _stream_mats)
from torch_port_helpers import small_cfg, torch_cfg

STEPS = 6
TPU_ATOL, TPU_ATOL_ALIGN = 3e-5, 1e-5
BATCHES, CLUSTERS, WEIGHTS = [1, 9, 16], [8, 16], ["bfloat16", "float32"]
COINS = {"ones": [1] * STEPS, "mixed": [1, 0, 0, 1, 1, 0]}
MODES = ["eval", "train"]
# the TPU kernel's residuals (it writes no query), and those it stores in
# the weights' dtype
TPU_RES = ("cum_pre", "z1", "z2", "h0d", "hpre", "ctx", "h1", "c1", "h2",
           "c2")
TPU_F32_RES = ("out", "align", "cum_pre")


def _cfgs(wd):
    """(JAX, port) configs: dropout 0.5, zoneout 0.1, train weights wd."""
    tc = dict(fused_train_dtype=wd, fused_decoder_dtype=wd, dropout_rate=0.5,
              zoneout_rate=0.1)
    jcfg, tcfg = small_cfg(), torch_cfg()
    return (jcfg.replace(tacotron=dataclasses.replace(jcfg.tacotron, **tc)),
            tcfg.replace(tacotron=dataclasses.replace(tcfg.tacotron, **tc)))


def _case(B, wd, coins, mode, *, keep_all=False):
    """(dp, cfg, the call's operands) at batch B: the flax weights in the
    train dtype, the teacher frames and coins, prenet multipliers and
    zoneout masks drawn from a seed (with keep_all, what the interpret-mode
    TPU kernel draws: every unit kept at 1/keep, every new state taken)."""
    params, keys, memory, mask = _setup(B)
    _, cfg = _cfgs(wd)
    dp = tk.extract_params({"decoder": params}, cfg, device="cpu")
    mels, r = cfg.audio.num_mels, cfg.tacotron.outputs_per_step
    rng = np.random.default_rng(100 + B)
    targets = rng.uniform(-4, 4, (B, STEPS * r, mels)).astype(np.float32)
    teacher = tdec.teacher_inputs(torch.as_tensor(targets), r)
    P, U = dp.pre_w0.shape[1], dp.l1_wh.shape[0]
    if keep_all:
        drop = torch.full((B, STEPS, 2, P), 2.0)
        zmask = torch.ones(B, STEPS, 4, U, dtype=torch.bool)
    else:
        g = torch.Generator().manual_seed(B)
        drop = tdec.drop_masks(cfg, B, STEPS, g, device="cpu")
        zmask = tdec.zoneout_masks(cfg, B, STEPS, g, device="cpu")
        assert 0 < float((drop == 0).float().mean()) < 1
        assert not bool(zmask.all())
    args = (torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask), teacher,
            torch.as_tensor(COINS[coins], dtype=torch.int32), drop)
    return dp, cfg, args, (zmask if mode == "train" else None), targets


# ------------------------------------------------------------ the replay


def _replay(dp, cfg, keys, memory, mask, teacher, coins, drop, zmask, cs):
    """csrc/decoder_rows.cu's teacher-forced data flow: the contract of
    `teacher_forced_train` (zmask given: train mode; its `res` also holds
    out and align) or of `teacher_forced` (zmask None, res of out and
    align only)."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r, zo = tc.outputs_per_step, float(tc.zoneout_rate)
    B, T, Mw = memory.shape
    U, P = dp.l1_wh.shape[0], dp.pre_w0.shape[1]
    Uc, Mc, Tc = U // cs, Mw // cs, -(-T // cs)
    FO, A = dp.proj_b.shape[0], dp.wq.shape[1]
    S = teacher.shape[0]
    mats, ks = _stream_mats(dp, cs)
    rg = tdec.round_bf16 if ks == 16 else identity
    wp, b_eff = fold_location(dp.loc_k, dp.loc_b, dp.wloc, dp.b_a)
    wp = rg(wp)                       # the taps rounded; keys and v_a not
    KW = wp.shape[0]
    pad = (KW - 1) // 2
    v_a = dp.v_a.float()
    l1_b, l2_b = (dk.split_gates(b.float(), cs) for b in (dp.l1_b, dp.l2_b))
    n8 = -(-B // 8) * 8                       # whole 8-row clusters
    rp = lambda x: F.pad(x, [0, 0] * (x.dim() - 1) + [0, n8 - B])
    keys_eff = rp(keys.float() + b_eff)
    mem, msk = rp(rg(memory.float())), rp(mask.float())
    drop = rp(drop.float())
    teacher = F.pad(teacher.float(), (0, 0, 0, n8 - B))
    real = torch.arange(n8) < B               # a missing row: EMA, unread
    zm = None if zmask is None else rp(zmask.bool())
    st = {k: torch.zeros(n8, w) for k, w in (
        ("xprev", mels), ("ctx", Mw), ("h1", U), ("h2", U), ("c1", U),
        ("c2", U), ("cum", T))}
    units = lambda c: slice(c * Uc, (c + 1) * Uc)

    def lstm(w, bias, x, c_st, h_st, m):
        """each CTA's gate columns (unit by unit) and units; the new c and
        h of all units, and the gates in the natural (i, j, f, o) x U order,
        each written at gate·U + rank·Uc + unit as the kernel writes them"""
        c_new, h_new = c_st.clone(), h_st.clone()
        z_nat = torch.zeros(n8, 4 * U)
        for c in range(cs):
            z = _kprod(w[c], x, ks)[:, :4 * Uc].reshape(-1, Uc, 4)
            z = z + bias[c].reshape(4, Uc).t()       # (unit, gate)
            for g in range(4):
                z_nat[:, g * U + c * Uc:g * U + (c + 1) * Uc] = z[:, :, g]
            i, j, f, o = z.unbind(-1)
            nc = torch.sigmoid(f) * c_st[:, units(c)] + \
                torch.sigmoid(i) * torch.tanh(j)
            nh = torch.sigmoid(o) * torch.tanh(nc)
            cn = (1 - zo) * nc + zo * c_st[:, units(c)]
            hn = (1 - zo) * nh + zo * h_st[:, units(c)]
            if m is not None:
                sel = lambda k: real[:, None] & m[:, k, units(c)]
                cn = torch.where(real[:, None],
                                 torch.where(sel(0), nc, c_st[:, units(c)]),
                                 cn)
                hn = torch.where(real[:, None],
                                 torch.where(sel(1), nh, h_st[:, units(c)]),
                                 hn)
            c_new[:, units(c)], h_new[:, units(c)] = cn, hn
        return c_new, h_new, z_nat

    res = {k: [] for k in ("out", "align", *dk.RES_NAMES)}
    for t in range(S):
        x = teacher[t] if int(coins[t]) else st["xprev"]
        h0d = torch.relu(_kprod(mats["pre0"][0], rg(x), ks)[:, :P]
                         + dp.pre_b0.float()) * drop[:, t, 0]
        hpre = torch.relu(_kprod(mats["pre1"][0], rg(h0d), ks)[:, :P]
                          + dp.pre_b1.float()) * drop[:, t, 1]
        m_t = None if zm is None else zm[:, t]
        c1, h1, z1 = lstm(mats["l1"], l1_b, rg(torch.cat(
            [hpre, st["ctx"], st["h1"]], 1)), st["c1"], st["h1"],
            None if m_t is None else m_t[:, :2])
        c2, h2, z2 = lstm(mats["l2"], l2_b, rg(torch.cat([h1, st["h2"]], 1)),
                          st["c2"], st["h2"],
                          None if m_t is None else m_t[:, 2:])
        q = torch.zeros(n8, A)
        for c in range(cs):                   # partials in rank order
            q += _kprod(mats["wq"][c], rg(h2[:, units(c)]), ks)[:, :A]
        cumr = F.pad(rg(st["cum"]), (pad, KW - 1 - pad))
        energy = torch.zeros(n8, T)
        for c in range(cs):                   # each CTA's positions
            for tt in range(c * Tc, min((c + 1) * Tc, T)):
                loc = cumr[:, tt:tt + KW] @ wp
                energy[:, tt] = torch.tanh(keys_eff[:, tt] + q + loc) @ v_a
        energy = torch.where(msk > 0, energy,
                             torch.full_like(energy, NEG_INF))
        ex = torch.exp(energy - energy.max(-1, keepdim=True).values) * msk
        al = ex / ex.sum(-1, keepdim=True)
        cum_pre = st["cum"]
        ctx = torch.zeros(n8, Mw)
        for c in range(cs):                   # each CTA's columns
            cols = slice(c * Mc, (c + 1) * Mc)
            ctx[:, cols] = torch.einsum("nt,ntm->nm", rg(al), mem[:, :, cols])
        proj = dp.proj_b.float().expand(n8, FO).clone()
        for c in range(cs):
            g = rg(torch.cat([h2[:, units(c)], ctx[:, c * Mc:(c + 1) * Mc]],
                             1))
            proj = proj + _kprod(mats["proj"][c], g, ks)[:, :FO]
        st.update(xprev=proj[:, (r - 1) * mels:r * mels], ctx=ctx, h1=h1,
                  h2=h2, c1=c1, c2=c2, cum=cum_pre + al)
        step = dict(out=proj, align=al, cum_pre=cum_pre, q=q, z1=z1, z2=z2,
                    h0d=h0d, hpre=hpre, ctx=ctx, h1=h1, c1=c1, h2=h2, c2=c2)
        for k in (res if zmask is not None else ("out", "align")):
            res[k].append(step[k][:B])
    res = {k: torch.stack(v, 1) for k, v in res.items() if v}
    out = res["out"]
    return (out[..., :r * mels].reshape(B, S * r, mels),
            out[..., r * mels:].reshape(B, S * r),
            res["align"].transpose(1, 2), res)


def _plain(dp, cfg, args, zmask):
    """The kernel's plain version, in the replay's contract."""
    if zmask is not None:
        return tk.teacher_forced_train_fwd_plain(dp, cfg, *args, zmask)
    out = tdec._teacher_forced(dp, cfg, *args, None)
    return out[0], out[1], out[2], {k: out[3][k] for k in ("out", "align")}


def _fields(out):
    f, s, a, res = out
    d = dict(frames=f, stops=s, align=a)
    d.update({f"res.{k}": v for k, v in res.items()})
    return {k: v.detach().float() for k, v in d.items()}


# ------------------------------------------------------------ the tests


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("coins", list(COINS))
@pytest.mark.parametrize("cs", CLUSTERS)
@pytest.mark.parametrize("wd", WEIGHTS)
@pytest.mark.parametrize("batch", BATCHES)
def test_teacher_forced_data_flow_replays_the_plain_decode(batch, wd, cs,
                                                           coins, mode):
    """Kernel 4a's data flow (eval or train mode) against the plain
    teacher-forced decode on the same multipliers and masks: frames, stop
    logits, alignments and in train mode every residual."""
    dp, cfg, args, zmask, _ = _case(batch, wd, coins, mode)
    with torch.no_grad():
        got = _fields(_replay(dp, cfg, *args, zmask, cs))
        want = _fields(_plain(dp, cfg, args, zmask))
        control = (_fields(_plain(tk.cast_params(dp, torch.float32), cfg,
                                  args, zmask))
                   if wd == "bfloat16" else None)
    assert set(got) == set(want)
    if mode == "train":
        assert {f"res.{k}" for k in tk.RES_NAMES} <= set(got)
    if control is not None:
        # the roundings' size: a replay without them would fail the mean
        # share
        assert float((control["frames"] - want["frames"]).abs().max()) > 1e-3
    _hold(got, want, wd, control)


def _tpu(B, wd, coins, mode):
    """build_train_fwd(interpret=True) on `_case(keep_all=True)`'s inputs:
    {field: [B, steps, ·]} (the outputs and residuals it writes)."""
    jcfg, _ = _cfgs(wd)
    params, keys, memory, mask = _setup(B)
    *_, targets = _case(B, wd, coins, mode, keep_all=True)

    def run():
        fwd = build_train_fwd(jcfg, B, T_IN, STEPS, M,
                              weight_dtype=getattr(jnp, wd),
                              train_zoneout=mode == "train", interpret=True)
        r, mels = jcfg.tacotron.outputs_per_step, jcfg.audio.num_mels
        tf = jnp.asarray(targets)[:, r - 1::r]
        teacher = jnp.concatenate([jnp.zeros((B, 1, mels)), tf[:, :-1]],
                                  1).transpose(1, 0, 2)
        out = fwd(extract_decoder_params_traced({"decoder": params}, jcfg),
                  jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask),
                  teacher, jnp.asarray(COINS[coins], jnp.int32),
                  jnp.asarray(3, jnp.int32))
        return {k: np.asarray(v, np.float32).transpose(1, 0, 2)
                for k, v in out.items()}
    return _cached(("tf", B, wd, coins, mode), run)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("coins", list(COINS))
@pytest.mark.parametrize("wd", WEIGHTS)
def test_teacher_forced_data_flow_replays_the_tpu_kernel(wd, coins, mode):
    """Kernel 4a's data flow at B 9 (a full and a one-row cluster), CS 16
    and 8, against `build_train_fwd(interpret=True)` in its eval
    (train_zoneout=False) or train mode: the projection (frames | stop
    logits), the alignments and every residual the TPU kernel writes."""
    B = 9
    tpu = _tpu(B, wd, coins, mode)
    dp, cfg, args, zmask, _ = _case(B, wd, coins, mode, keep_all=True)
    if mode == "train":
        assert bool(zmask.all())
    with torch.no_grad():
        control = _plain(tk.cast_params(dp, torch.float32), cfg, args,
                         zmask)[3]
        for cs in CLUSTERS:
            res = _replay(dp, cfg, *args, zmask, cs)[3]
            want = {k: torch.as_tensor(np.array(v[..., :res[k].shape[-1]]))
                    for k, v in tpu.items() if k in res}
            assert set(want) == ({"out", "align", *TPU_RES}
                                 if mode == "train" else {"out", "align"})
            if wd == "float32":
                for k, w in want.items():
                    atol = TPU_ATOL_ALIGN if k in ("align", "cum_pre") \
                        else TPU_ATOL
                    np.testing.assert_allclose(res[k], w, rtol=0, atol=atol,
                                               err_msg=f"{k} cs {cs}")
                continue
            # bf16: the TPU kernel stores these residuals in bf16; both
            # sides and the control are read alike
            rd = lambda k, x: x if k in TPU_F32_RES else tdec.round_bf16(x)
            _hold({k: rd(k, res[k]) for k in want}, want, wd,
                  {k: rd(k, control[k]) for k in want})


def test_replay_holds_z_in_the_natural_gate_order():
    """The train residuals z1 and z2 come out of the (unit, gate) layout of
    each CTA's gate columns in the natural (i, j, f, o) x U order: the
    replay's gates at CS 8 and 16 are each CTA's stream columns, and the
    plain version's z1 equals [i | j | f | o] of the LSTM product."""
    dp, cfg, args, zmask, _ = _case(3, "float32", "mixed", "train")
    with torch.no_grad():
        res8 = _replay(dp, cfg, *args, zmask, 8)[3]
        res16 = _replay(dp, cfg, *args, zmask, 16)[3]
        plain = _plain(dp, cfg, args, zmask)[3]
    U = dp.l1_wh.shape[0]
    for name in ("z1", "z2"):
        for res in (res8, res16):
            d = (res[name] - plain[name]).abs().max()
            assert float(d) <= F32_RTOL * float(plain[name].abs().max())
        # a gate order slip (units of one gate swapped with another's)
        # would move these far past the tolerance
        sw = torch.cat([plain[name][..., U:2 * U], plain[name][..., :U],
                        plain[name][..., 2 * U:]], -1)
        assert float((res16[name] - sw).abs().max()) > 1e-2
    # the step's input gates: z1 [i | j | f | o] at step 0, from the LSTM
    # product the plain version's cell computes
    h0 = plain["hpre"][:, 0]
    x1 = torch.cat([h0, torch.zeros(3, M), torch.zeros(3, U)], 1)
    l1 = torch.cat([dp.l1_wp, dp.l1_wc, dp.l1_wh], 0).float()
    np.testing.assert_allclose(plain["z1"][:, 0], x1 @ l1 + dp.l1_b.float(),
                               rtol=0, atol=1e-5)


class _Cuda:
    """What the wrappers read of a CUDA tensor before they launch."""
    device = torch.device("cuda")


def test_cuda_tensors_without_kernel_weights_raise():
    """On a CUDA tensor the teacher-forced forwards launch the kernel or
    raise: without kernel_weights, a ValueError, never the plain
    version."""
    _, cfg = _cfgs("bfloat16")
    for fn, extra in ((tk.teacher_forced_fwd, ()),
                      (tk.teacher_forced_train_fwd, (None,))):
        with pytest.raises(ValueError, match="kernel_weights"):
            fn(None, cfg, None, _Cuda(), None, None, None, None, *extra)


class _RowsLibrary(Exception):
    pass


class _DecoderLibrary(Exception):
    pass


@pytest.mark.parametrize("mode", MODES)
def test_teacher_forced_route_reaches_only_the_rows_kernel(monkeypatch,
                                                           mode):
    """The teacher-forced launch loads csrc/decoder_rows.cu (its loader is
    reached: the operands passed every check before it) and never
    csrc/decoder.cu, which holds no teacher-forced mode any more."""
    def rows_lib():
        raise _RowsLibrary

    def decoder_lib():
        raise _DecoderLibrary
    monkeypatch.setattr(dk, "_rows_lib", rows_lib)
    monkeypatch.setattr(dk, "_lib", decoder_lib)
    dp, cfg, args, zmask, _ = _case(9, "bfloat16", "mixed", mode)
    kw = dk.pack_weights(dp)
    with pytest.raises(_RowsLibrary):
        tk._teacher_forced_cuda(kw, cfg, *args, zmask)
    src = inspect.getsource(tk)
    assert "prepare_launch" not in src and "dk.launch(" not in src
    csrc = os.path.join(os.path.dirname(dk.__file__), os.pardir, "csrc")
    decoder_cu = open(os.path.join(csrc, "decoder.cu")).read()
    rows_cu = open(os.path.join(csrc, "decoder_rows.cu")).read()
    for token in ("P_TEACHER", "P_ZMASK", "coins", "zmask", "LstmRes"):
        assert token not in decoder_cu, token
        assert token in rows_cu or token == "LstmRes", token
