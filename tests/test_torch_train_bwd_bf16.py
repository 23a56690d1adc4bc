"""The port's BPTT backward (kernel 4b) with bf16 weights against the JAX
package's, on the CPU: `build_train_bwd` rounds every gradient to bf16
where it enters a product and reads the forward's residuals in bf16, and
the port's plain version (and so the kernel it is held to) does the same.

At tests/test_torch_train_kernel.py's small configuration (B 3, T_in 12,
M 64, 5 steps, r 2, dropout and zoneout 0), the JAX kernels run in
interpret mode with weight_dtype=bfloat16:

- the plain backward on `build_train_fwd`'s own bf16 residuals (handed
  over as f32) against `build_train_bwd`'s outputs, each within BWD_BF16_RTOL
  of its largest magnitude; the plain version without the gradient
  rounding (`round_gradients=False`, the function before the repair) is
  the control, and it must miss that tolerance;
- `FusedTeacherForced` with `fused_train_dtype="bfloat16"` against
  `make_fused_teacher_forced(weight_dtype=bfloat16)`: every parameter, the
  keys and the memory within GRAD_RTOL;
- a PyTorch replay of csrc/decoder_bwd.cu's data flow (8-row clusters,
  the per-CTA gate columns, the partials summed in rank order, bf16
  k-steps of 16 against the packed weight stream) against the plain
  version, at B 3 and 9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.ops.tacotron_train_kernel import (
    _band_selector, build_train_bwd, build_train_fwd,
    extract_decoder_params_traced, make_fused_teacher_forced)
from tacotron2_tpu_torch.models.tacotron.decoder import (
    _lstm_bwd, drop_masks, teacher_forced_bwd_plain, zoneout_masks)
from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
from test_torch_train_kernel import (B, COINS, GRAD_RTOL, M, STEPS, T_IN,
                                     _cfgs, _jax_teacher, _port_decoder,
                                     _port_inputs, _rel, setup)

# the plain bf16 backward against build_train_bwd on the same residuals:
# the same roundings, f32 sums in another order, so a rounding may land
# on the other side of a bf16 step now and then (first reading: at most
# 4.3e-5 of a gradient's largest magnitude, dz2 with mixed coins; the
# unrounded control at least 8.8e-3 in its worst gradient)
BWD_BF16_RTOL = 1e-3
OUTS = ("dz1", "dz2", "da0", "da1", "dproj", "dctx", "dq")
BF16 = dict(fused_train_dtype="bfloat16")


def _jax_run(params, keys, memory, mask, targets, coins):
    """build_train_fwd and build_train_bwd in bf16 (interpret mode), as
    make_fused_teacher_forced runs them, with a fixed dout and dalign."""
    cfg, _ = _cfgs(**BF16)
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r, A = tc.outputs_per_step, tc.attention_dim
    FO = r * mels + r
    FOp, Tp = 128, 128
    dp = extract_decoder_params_traced({"decoder": params}, cfg)
    fwd = build_train_fwd(cfg, B, T_IN, STEPS, M, weight_dtype=jnp.bfloat16,
                          interpret=True)
    bwd = build_train_bwd(cfg, B, T_IN, STEPS, M, weight_dtype=jnp.bfloat16,
                          interpret=True)
    co = jnp.asarray(coins, jnp.int32)
    res = jax.jit(fwd)(dp, jnp.asarray(keys), jnp.asarray(memory),
                       jnp.asarray(mask), _jax_teacher(cfg, jnp.asarray(
                           targets)), co, jnp.asarray(3, jnp.int32))
    keys_p = jnp.pad(jnp.asarray(keys), ((0, 0), (0, Tp - T_IN), (0, 0)))
    mem_p = jnp.pad(jnp.asarray(memory), ((0, 0), (0, Tp - T_IN), (0, 0)))
    b_eff = dp.b_a + dp.loc_b @ dp.wloc
    res["keys2"] = (keys_p + b_eff).reshape(B, Tp * A)
    rng = np.random.default_rng(4)
    dout = rng.normal(size=(STEPS, B, FO)).astype(np.float32)
    dalign = (rng.normal(size=(STEPS, B, T_IN)) * 0.1).astype(np.float32)
    out = jax.jit(bwd)(dp, res, mem_p,
                       jnp.pad(dout, ((0, 0), (0, 0), (0, FOp - FO))),
                       jnp.pad(dalign, ((0, 0), (0, 0), (0, Tp - T_IN))),
                       co, jnp.asarray(3, jnp.int32))
    K = tc.attention_kernel
    t1 = np.asarray(out["t1"], np.float32).reshape(Tp, Tp, A)
    sel = np.asarray(_band_selector(K, Tp)).reshape(Tp, Tp, K)
    bm = lambda x, n: np.asarray(x, np.float32).transpose(1, 0, 2)[..., :n]
    want = {k: bm(out[k], n) for k, n in (
        ("dz1", None), ("dz2", None), ("da0", None), ("da1", None),
        ("dproj", FO), ("dctx", None), ("dq", None))}
    want.update(
        dkeys=np.asarray(out["dkeys2"]).reshape(B, Tp, A)[:, :T_IN],
        dwp=np.einsum("uta,utk->ka", t1, sel),
        dva=np.asarray(out["dv"]).sum(0))
    wq = np.asarray(dp.wq.astype(jnp.bfloat16), np.float32)
    h2 = bm(res["h2"], None)
    resn = {k: bm(res[k], T_IN if k in ("align", "cum_pre") else None)
            for k in ("align", "cum_pre", "z1", "z2", "c1", "c2", "h0d",
                      "hpre")}
    resn["q"] = (torch.from_numpy(h2) @ torch.from_numpy(wq)).numpy()
    return res, resn, dout.transpose(1, 0, 2), dalign.transpose(1, 0, 2), \
        want


@pytest.mark.parametrize("coins", ["ones", "mixed"])
def test_plain_bf16_bwd_matches_build_train_bwd(setup, coins):
    """The plain bf16 backward on build_train_fwd's residuals against
    build_train_bwd(bfloat16): every per-step output and the sums, within
    BWD_BF16_RTOL; the unrounded control misses it."""
    params, keys, memory, mask, targets = setup
    _, resn, dout, dalign, want = _jax_run(params, keys, memory, mask,
                                           targets, COINS[coins])
    _, cfg_t = _cfgs(**BF16)
    dec = _port_decoder(cfg_t, params)
    k, m, msk, _, co = _port_inputs(cfg_t, keys, memory, mask, targets,
                                    COINS[coins])
    with torch.no_grad():
        dp = tk.cast_params(tk.extract_params_traced(dec, cfg_t),
                            torch.bfloat16)
        res = {n: torch.from_numpy(np.ascontiguousarray(v))
               for n, v in resn.items()}
        args = (dp, cfg_t, res, k, m, msk, co,
                drop_masks(cfg_t, B, STEPS, device="cpu"),
                zoneout_masks(cfg_t, B, STEPS, device="cpu"),
                torch.from_numpy(dout), torch.from_numpy(dalign))
        got = teacher_forced_bwd_plain(*args)
        ctl = teacher_forced_bwd_plain(*args, round_gradients=False)
    errs = {n: _rel(got[n].numpy(), w) for n, w in want.items()}
    ctl_errs = {n: _rel(ctl[n].numpy(), w) for n, w in want.items()}
    print(coins, "plain", {n: f"{v:.2e}" for n, v in errs.items()})
    print(coins, "control", {n: f"{v:.2e}" for n, v in ctl_errs.items()})
    assert max(errs.values()) < BWD_BF16_RTOL, errs
    assert max(ctl_errs.values()) > BWD_BF16_RTOL, ctl_errs
    for n in OUTS:
        v = got[n]
        assert torch.equal(v, v.to(torch.bfloat16).float()), n


@pytest.mark.parametrize("coins", ["ones", "mixed"])
def test_fused_bf16_grads_match_jax(setup, coins):
    """`FusedTeacherForced` with bf16 train weights (the plain pieces, on
    the CPU) against `make_fused_teacher_forced(weight_dtype=bfloat16)`:
    every decoder parameter, the keys and the memory within GRAD_RTOL."""
    params, keys, memory, mask, targets = setup
    cfg, cfg_t = _cfgs(**BF16)
    r, mels = cfg.tacotron.outputs_per_step, cfg.audio.num_mels
    rng = np.random.default_rng(1)
    wf = rng.normal(size=(B, STEPS * r, mels)).astype(np.float32)
    ws = rng.normal(size=(B, STEPS * r)).astype(np.float32)
    wa = (rng.normal(size=(B, T_IN, STEPS)) * 0.1).astype(np.float32)
    fused = make_fused_teacher_forced(cfg, B, T_IN, STEPS, M,
                                      weight_dtype=jnp.bfloat16,
                                      interpret=True)

    def loss_jax(p, k, m):
        dp = extract_decoder_params_traced({"decoder": p}, cfg)
        f, s, a = fused(dp, k, m, jnp.asarray(mask),
                        _jax_teacher(cfg, jnp.asarray(targets)),
                        jnp.asarray(COINS[coins], jnp.int32),
                        jnp.asarray(3, jnp.int32))
        return jnp.sum(f * wf) + jnp.sum(s * ws) + jnp.sum(a * wa)

    l_jax = float(loss_jax(params, keys, memory))
    g_jax = jax.jit(jax.grad(loss_jax, argnums=(0, 1, 2)))(
        params, jnp.asarray(keys), jnp.asarray(memory))
    dec = _port_decoder(cfg_t, params)
    k, m, msk, teacher, co = _port_inputs(cfg_t, keys, memory, mask,
                                          targets, COINS[coins], grad=True)
    f, s, a = tk.FusedTeacherForced.apply(
        cfg_t, None, k, m, msk, teacher, co,
        drop_masks(cfg_t, B, STEPS, device="cpu"),
        zoneout_masks(cfg_t, B, STEPS, device="cpu"),
        *tk.extract_params_traced(dec, cfg_t))
    loss = ((f * torch.as_tensor(wf)).sum() + (s * torch.as_tensor(ws)).sum()
            + (a * torch.as_tensor(wa)).sum())
    assert abs(float(loss.detach()) - l_jax) < 1e-4 * max(abs(l_jax), 1.0)
    loss.backward()
    errs = {}
    for name, param in dec.named_parameters():
        if name == "attention.memory_layer.kernel":
            continue
        want = g_jax[0]["cell"]
        for key in name.split("."):
            want = want[key]
        errs[name] = _rel(param.grad.numpy(), np.asarray(want))
    errs["keys"] = _rel(k.grad.numpy(), np.asarray(g_jax[1]))
    errs["memory"] = _rel(m.grad.numpy(), np.asarray(g_jax[2]))
    print(coins, {n: f"{v:.2e}" for n, v in errs.items()})
    assert len(errs) == 20
    assert max(errs.values()) < GRAD_RTOL, errs


# --------------------------------------------------------------- the replay

NW, KC = tk.BWD_NW, tk.BWD_KC


def _unpack(flat, cs, ks, shapes):
    """Stream values [cs, ·] -> each product's zero-padded weight matrix
    [cs, rows padded to 16·NW, K padded to ks·KC], reading the fragment
    order back (group, chunk, warp, k-tile, lane, fragment)."""
    mats, o = [], 0
    for rows, K in shapes:
        ng = -(-(-(-rows // 16)) // NW)
        kp = -(-K // (ks * KC)) * ks * KC
        nck = kp // (ks * KC)
        n = ng * NW * 16 * kp
        t = flat[:, o:o + n]
        o += n
        if ks == 16:
            t = t.reshape(cs, ng, nck, NW, KC, 8, 4, 2, 2, 2)
            t = t.permute(0, 1, 3, 8, 5, 2, 4, 7, 6, 9)
        else:
            t = t.reshape(cs, ng, nck, NW, KC, 8, 4, 2, 2)
            t = t.permute(0, 1, 3, 8, 5, 2, 4, 7, 6)
        mats.append(t.reshape(cs, ng * NW * 16, kp).float())
    assert o == flat.shape[1]
    return mats


def _kprod(a, g, ks):
    """g [n, K] against a [m, kp]: out [n, m], each k-step of ks products
    from zero, added in f32 in step order (the kernel's mma k-steps)."""
    n, K = g.shape
    mp, kp = a.shape
    g = torch.nn.functional.pad(g, (0, kp - K)).reshape(n, kp // ks, ks)
    part = torch.einsum("ntk,mtk->tnm", g, a.reshape(mp, kp // ks, ks))
    out = torch.zeros(n, mp)
    for p in part:
        out += p
    return out


def _replay(dp, cfg, res, keys, memory, coins, drop, zmask, dout, dalign,
            cs):
    """csrc/decoder_bwd.cu's data flow in PyTorch: rows padded to whole
    8-row clusters, each CTA's products from its slice of the packed
    weight stream (k-steps of 16 in bf16, 8 in f32), the partials over the
    gate columns, the context columns and the input positions added in
    rank order, the prenet from every CTA's copy."""
    from tacotron2_tpu_torch.models.tacotron.attention import (
        fold_location, identity, location_features)
    from tacotron2_tpu_torch.models.tacotron.decoder import round_bf16
    import torch.nn.functional as F
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r = tc.outputs_per_step
    FO = r * mels + r
    B, T, M = memory.shape
    S = dout.shape[1]
    U, P = dp.l1_wh.shape[0], dp.pre_w1.shape[0]
    bf16 = dp.l1_wp.dtype == torch.bfloat16
    rg = round_bf16 if bf16 else identity
    ks, wdt = (16, torch.bfloat16) if bf16 else (8, torch.float32)
    wp, b_eff = fold_location(dp.loc_k, dp.loc_b, dp.wloc, dp.b_a)
    wp = rg(wp)
    KW, A = wp.shape
    pad = (KW - 1) // 2
    Uc, Mc, Tc = U // cs, M // cs, -(-T // cs)
    fop = -(-FO // 8) * 8
    flat = tk.bwd_stream(dk.pack_weights(dp), cs).view(wdt)
    shapes = [(Uc + Mc, fop), (Uc, A), (2 * U, 4 * Uc), (P + M + U, 4 * Uc)]
    own = sum(-(-(-(-r // 16)) // NW) * NW * 16 * -(-K // (ks * KC)) * ks
              * KC for r, K in shapes)
    mats = _unpack(flat[:cs * own].reshape(cs, own), cs, ks, shapes)
    mats += [m.expand(cs, *m.shape[1:]) for m in _unpack(
        flat[cs * own:][None], 1, ks, [(P, P), (mels, P)])]
    # the packing: each CTA's products, zero past the real rows and k
    proj = torch.cat([dp.proj_wo, dp.proj_wc], 0).float()
    l2 = torch.cat([dp.l2_wx, dp.l2_wh], 0).float()
    l1 = torch.cat([dp.l1_wp, dp.l1_wc, dp.l1_wh], 0).float()
    cols = lambda c: torch.cat([torch.arange(k * U + c * Uc,
                                             k * U + (c + 1) * Uc)
                                for k in range(4)])
    for c in range(cs):
        want = [torch.cat([proj[c * Uc:(c + 1) * Uc],
                           proj[U + c * Mc:U + (c + 1) * Mc]]),
                dp.wq.float()[c * Uc:(c + 1) * Uc], l2[:, cols(c)],
                l1[:, cols(c)], dp.pre_w1.float(), dp.pre_w0.float()]
        for mat, w in zip(mats, want):
            rows, K = w.shape
            assert torch.equal(mat[c, :rows, :K], w)
            assert not mat[c, rows:].any() and not mat[c, :, K:].any()
    n8 = -(-B // 8) * 8
    rp = lambda x: F.pad(x, [0, 0] * (x.dim() - 1) + [0, n8 - B])
    res = {k: rp(v.float()) for k, v in res.items()}
    keys_eff = rp(keys.float()) + b_eff
    mem = rg(rp(memory.float()))
    dout, dalign = rp(dout.float()), rp(dalign.float())
    drop, zmask = rp(drop.float()), rp(zmask.to(torch.uint8)).bool()
    z = lambda *s: torch.zeros(*s)
    dh1c, dc1c, dh2c, dc2c = z(n8, U), z(n8, U), z(n8, U), z(n8, U)
    dctx_c, dcum, dx = z(n8, M), z(n8, T), z(n8, mels)
    dkeys, dwp, dva = z(n8, T, A), z(KW, A), z(A)
    names = ("dz1", "dz2", "da0", "da1", "dproj", "dctx", "dq", "dcum")
    outs = {k: [None] * S for k in names}
    lo = lambda c: (min(c * Tc, T), min((c + 1) * Tc, T))
    for t in reversed(range(S)):
        dproj = dout[:, t].clone()
        dproj[:, (r - 1) * mels:r * mels] += dx
        dproj = rg(dproj)
        op = [_kprod(mats[0][c], dproj, ks) for c in range(cs)]
        dh2o = torch.cat([o[:, :Uc] for o in op], 1)
        dctx = rg(torch.cat([o[:, Uc:Uc + Mc] for o in op], 1) + dctx_c)
        dal = z(n8, T)
        for c in range(cs):
            sl = slice(c * Mc, (c + 1) * Mc)
            dal += torch.einsum("nm,ntm->nt", dctx[:, sl], mem[:, :, sl])
        outs["dcum"][t] = dcum[:B]
        dal = dal + dalign[:, t] + dcum
        align = res["align"][:, t]
        den = align * (dal - (dal * align).sum(-1, keepdim=True))
        rc = rg(res["cum_pre"][:, t])
        e = torch.tanh(keys_eff + res["q"][:, t][:, None, :]
                       + location_features(rc, wp))
        de = den[..., None] * dp.v_a.float() * (1.0 - e * e)
        dkeys += de
        rde = rg(de)
        dq, pc = z(n8, A), z(n8, T)
        taps = F.pad(rc, (pad, KW - 1 - pad)).unfold(1, KW, 1)
        for c in range(cs):
            a0, a1 = lo(c)
            dq += de[:, a0:a1].sum(1)
            dva += (e[:, a0:a1] * den[:, a0:a1, None]).sum((0, 1))
            dwp += torch.einsum("ntk,nta->ka", taps[:, a0:a1], rde[:, a0:a1])
            part = torch.zeros_like(rde)
            part[:, a0:a1] = rde[:, a0:a1]
            pc += F.conv_transpose1d(part.transpose(1, 2),
                                     wp.t()[:, None, :], padding=pad)[:, 0]
        dcum = dcum + pc
        dq = rg(dq)
        dh2a = torch.cat([_kprod(mats[1][c], dq, ks)[:, :Uc]
                          for c in range(cs)], 1)
        prev = lambda n: rg(res[n][:, t - 1]) if t else z(n8, U)
        dz2, dhz2, dc2c = _lstm_bwd(rg(res["z2"][:, t]), prev("c2"),
                                    dh2o + dh2a + dh2c, dc2c,
                                    zmask[:, t, 2:])
        dz2 = rg(dz2)
        s2 = z(n8, 2 * U)
        for c in range(cs):
            s2 += _kprod(mats[2][c], dz2[:, cols(c)], ks)[:, :2 * U]
        dh2c = dhz2 + s2[:, U:]
        dz1, dhz1, dc1c = _lstm_bwd(rg(res["z1"][:, t]), prev("c1"),
                                    s2[:, :U] + dh1c, dc1c, zmask[:, t, :2])
        dz1 = rg(dz1)
        s1 = z(n8, P + M + U)
        for c in range(cs):
            s1 += _kprod(mats[3][c], dz1[:, cols(c)], ks)[:, :P + M + U]
        dctx_c, dh1c = s1[:, P:P + M], dhz1 + s1[:, P + M:]
        da1 = rg(s1[:, :P] * drop[:, t, 1] * (res["hpre"][:, t] > 0))
        da0 = rg(_kprod(mats[4][0], da1, ks)[:, :P] * drop[:, t, 0]
                 * (res["h0d"][:, t] > 0))
        dx = (_kprod(mats[5][0], da0, ks)[:, :mels] if coins[t] == 0
              else z(n8, mels))
        for k, v in zip(names, (dz1, dz2, da0, da1, dproj[:, :FO], dctx,
                                dq)):
            outs[k][t] = v[:B]
    out = {k: torch.stack(v, 1) for k, v in outs.items()}
    out.update(dkeys=dkeys[:B], dwp=dwp, dva=dva)
    return out


# kernel against plain, bf16 (chip_smoke.py's gate for kernel 4b): each
# gradient's largest difference within 4 bf16 steps of its largest
# magnitude, its mean difference at most 0.1x that of the control
CAP_STEPS, MEAN_SHARE = 4, 0.1


@pytest.mark.parametrize("cs", [8, 16])
@pytest.mark.parametrize("wd", ["bfloat16", "float32"])
@pytest.mark.parametrize("batch", [3, 9])
def test_cluster_data_flow_replays_the_plain_bwd(setup, batch, wd, cs):
    """The packed weight stream through the kernel's data flow (rows
    padded to whole clusters, each CTA's gate and context columns and
    input positions, the partials added in rank order, mma k-steps) gives
    the plain backward's gradients: bf16 within the kernel's gate against
    the plain version (the unrounded control must miss it), f32 within
    1e-4 of each gradient's largest magnitude."""
    params, *_ = setup
    _, cfg_t = _cfgs(dropout_rate=0.5, zoneout_rate=0.1,
                     fused_train_dtype=wd)
    mels, r = cfg_t.audio.num_mels, cfg_t.tacotron.outputs_per_step
    rng = np.random.default_rng(batch)
    keys = rng.normal(size=(batch, T_IN, 16)).astype(np.float32) * 0.3
    memory = rng.normal(size=(batch, T_IN, M)).astype(np.float32)
    mask = np.arange(T_IN)[None] < np.maximum(
        T_IN - 2 * np.arange(batch), 3)[:, None]
    targets = rng.normal(size=(batch, STEPS * r, mels)).astype(np.float32)
    dec = _port_decoder(cfg_t, params)
    k, m, msk, teacher, co = _port_inputs(cfg_t, keys, memory, mask,
                                          targets, COINS["mixed"])
    g = torch.Generator().manual_seed(batch)
    drop = drop_masks(cfg_t, batch, STEPS, g, device="cpu")
    zmask = zoneout_masks(cfg_t, batch, STEPS, g, device="cpu")
    with torch.no_grad():
        dp = tk.cast_params(tk.extract_params_traced(dec, cfg_t),
                            tk.train_weight_dtype(cfg_t))
        *_, res = tk.teacher_forced_train_fwd(dp, cfg_t, k, m, msk, teacher,
                                              co, drop, zmask)
        dout = torch.as_tensor(rng.normal(size=(batch, STEPS, res[
            "out"].shape[-1])).astype(np.float32))
        dalign = torch.as_tensor(rng.normal(
            size=(batch, STEPS, T_IN)).astype(np.float32) * 0.1)
        args = (dp, cfg_t, res, k, m, msk, co, drop, zmask, dout, dalign)
        want = teacher_forced_bwd_plain(*args)
        ctl = teacher_forced_bwd_plain(*args, round_gradients=False)
        got = _replay(dp, cfg_t, res, k, m, co.tolist(), drop, zmask, dout,
                      dalign, cs)
    for n, w in want.items():
        assert got[n].shape == w.shape, n
        d = (got[n] - w).abs()
        scale = float(w.abs().max())
        assert scale > 0, n
        if wd == "float32":
            assert float(d.max()) <= 1e-4 * scale, (n, float(d.max()) / scale)
            continue
        c = float((ctl[n] - w).abs().mean())
        assert float(d.max()) <= CAP_STEPS * 2.0 ** -8 * scale, n
        assert float(d.mean()) <= MEAN_SHARE * c, (n, float(d.mean()) / c)
