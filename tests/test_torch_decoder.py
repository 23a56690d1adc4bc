"""The port's plain decode (the CUDA decode kernel's plain version)
against the JAX package's decoders, on the CPU.

Same inputs from numpy seeds into (a) the TPU decode kernels
`build_decoder_kernel` / `build_decoder_block_kernel(..., interpret=True)`
with f32 weights and (b) the flax scan `Decoder.autoregressive`, at
`tacotron.dropout_rate=0` as in tests/test_decoder_kernel.py. Tolerances
are the JAX package's own for the kernel-vs-scan comparison (frames atol
2e-4, stop probs 2e-5): both sides are f32 with a different summation
order over the 2-layer LSTM and the attention. The TPU kernels store their
alignments in bf16 (8 mantissa bits, weights up to 1), so alignments are
held to tests/test_decoder_kernel.py's atol 8e-3. The early-stop block
rule is checked as tests/test_decoder_kernel.py:160 checks it, and on
rows that fire in different blocks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.tacotron.decoder import Decoder
from tacotron2_tpu.ops.tacotron_decoder_kernel import (
    build_decoder_block_kernel, build_decoder_kernel, extract_decoder_params,
    init_decoder_state)
from tacotron2_tpu_torch.models.tacotron.attention import fold_location
from tacotron2_tpu_torch.models.tacotron.decoder import drop_masks
from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
from torch_port_helpers import small_cfg, to_numpy, torch_cfg

B, T_IN, M, STEPS = 4, 20, 48, 6


@pytest.fixture(scope="module")
def setup():
    cfg = small_cfg()
    rng = np.random.default_rng(0)
    memory = rng.normal(size=(B, T_IN, M)).astype(np.float32)
    lengths = np.asarray([T_IN, T_IN - 3, T_IN - 7, 5])
    mask = np.arange(T_IN)[None, :] < lengths[:, None]
    keys = (rng.normal(size=(B, T_IN, cfg.tacotron.attention_dim))
            * 0.3).astype(np.float32)
    dec = Decoder(config=cfg)
    variables = dec.init(
        dict(params=jax.random.PRNGKey(0), dropout=jax.random.PRNGKey(1),
             zoneout=jax.random.PRNGKey(2)),
        B, STEPS, jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask),
        method=Decoder.autoregressive)
    params = to_numpy(variables["params"])
    return cfg, params, keys, memory, mask


def _port(cfg_t, params, keys, memory, mask, steps, K=0, proj_b=None):
    dp = dk.extract_decoder_params({"decoder": params}, cfg_t, device="cpu")
    if proj_b is not None:
        dp = dp._replace(proj_b=torch.tensor(np.asarray(proj_b)))
    drop = drop_masks(cfg_t, B, steps, device="cpu")
    f, s, a = dk.decode(dp, cfg_t, torch.as_tensor(keys),
                        torch.as_tensor(memory), torch.as_tensor(mask), drop,
                        steps=steps, early_stop_block=K)
    return f.numpy(), s.numpy(), a.numpy()


@pytest.mark.parametrize("constraint", ["window", "monotonic"])
def test_plain_decode_matches_tpu_kernel(setup, constraint):
    cfg, params, keys, memory, mask = setup
    cfg = cfg.replace(tacotron=dataclasses.replace(
        cfg.tacotron, synthesis_constraint_type=constraint))
    cfg_t = torch_cfg()
    cfg_t = cfg_t.replace(tacotron=dataclasses.replace(
        cfg_t.tacotron, synthesis_constraint_type=constraint))
    dp = extract_decoder_params({"decoder": params}, cfg)
    run = build_decoder_kernel(cfg, B, T_IN, STEPS, M,
                               weight_dtype=jnp.float32, interpret=True)
    f_j, s_j, a_j = run(dp, jnp.asarray(keys), jnp.asarray(memory),
                        jnp.asarray(mask), 3)
    f_t, s_t, a_t = _port(cfg_t, params, keys, memory, mask, STEPS)
    assert f_t.shape == np.asarray(f_j).shape
    assert a_t.shape == np.asarray(a_j).shape == (B, T_IN, STEPS)
    np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=0, atol=2e-4)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=0, atol=8e-3)


def test_plain_decode_matches_flax_scan(setup):
    cfg, params, keys, memory, mask = setup
    f_j, s_j, a_j, _ = Decoder(config=cfg).apply(
        {"params": params}, B, STEPS, jnp.asarray(keys), jnp.asarray(memory),
        jnp.asarray(mask), method=Decoder.autoregressive,
        rngs=dict(dropout=jax.random.PRNGKey(7),
                  zoneout=jax.random.PRNGKey(8)))
    f_t, s_t, a_t = _port(torch_cfg(), params, keys, memory, mask, STEPS)
    np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=0, atol=2e-4)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=2e-5)
    # the scan keeps its alignments in f32
    np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=0, atol=2e-5)


@pytest.mark.parametrize("stop_bias", [10.0, -10.0])
def test_early_stop_block_matches_tpu_kernel(setup, stop_bias):
    """Bias +10: every row stops in the first block; later steps read
    frames 0 / stop 1.0 exactly as the TPU kernel writes them. Bias -10:
    no row stops and the block path equals the full decode."""
    cfg, params, keys, memory, mask = setup
    r = cfg.tacotron.outputs_per_step
    steps, K = 12, 4
    dp = extract_decoder_params({"decoder": params}, cfg)
    dp = dp._replace(proj_b=dp.proj_b.at[-r:].set(stop_bias))
    run = build_decoder_kernel(cfg, B, T_IN, steps, M,
                               weight_dtype=jnp.float32,
                               emit_alignments=False, early_stop_block=K,
                               interpret=True)
    f_j, s_j, _ = run(dp, jnp.asarray(keys), jnp.asarray(memory),
                      jnp.asarray(mask), 3)
    f_t, s_t, _ = _port(torch_cfg(), params, keys, memory, mask, steps, K=K,
                        proj_b=np.asarray(dp.proj_b))
    np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=0, atol=2e-4)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=2e-5)
    if stop_bias > 0:
        assert np.all(s_t[:, K * r:] == 1.0) and np.all(f_t[:, K * r:] == 0)


def test_early_stop_waits_for_every_row(setup):
    """Rows whose stops fire in different blocks: every row decodes on
    until the first block boundary at which all rows have fired, and the
    steps after it read frames 0, stop 1.0 and alignments 0 — frame for
    frame, stop for stop and alignment for alignment what the TPU kernel
    gives (tacotron_decoder_kernel.py:1053-1070)."""
    cfg, params, keys, memory, mask = setup
    cfg_t = torch_cfg()
    r = cfg.tacotron.outputs_per_step
    steps, K = 16, 4
    # The stop logits do not feed back, so a shift of the stop bias moves
    # them and nothing else: pick the shift that makes the row with the
    # lowest logits fire first in the second block, the others in the first.
    dp_t = dk.extract_decoder_params({"decoder": params}, cfg_t,
                                     device="cpu")
    drop = drop_masks(cfg_t, B, steps, device="cpu")
    args = (torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask), drop)
    _, s_full, _ = dk.decode(dp_t, cfg_t, *args, steps=steps)
    p = s_full.numpy().reshape(B, steps, r).min(-1)
    logit = np.log(p / (1 - p))
    late = int(np.argmin(logit[:, 0]))
    lo, hi = logit[late, :K].max(), logit[late, K:2 * K].max()
    assert hi - lo > 0.05, (lo, hi)
    shift = -0.5 * (lo + hi)
    first = [int(np.argmax(row + shift > 0)) if (row + shift > 0).any()
             else None for row in logit]
    blocks = [f // K for f in first]
    assert blocks[late] == 1 and sorted(blocks)[:-1] == [0] * (B - 1), first
    assert np.abs(logit + shift).min() > 1e-2      # no decision near 0.5

    dp_j = extract_decoder_params({"decoder": params}, cfg)
    dp_j = dp_j._replace(proj_b=dp_j.proj_b.at[-r:].add(shift))
    run = build_decoder_kernel(cfg, B, T_IN, steps, M,
                               weight_dtype=jnp.float32, early_stop_block=K,
                               interpret=True)
    f_j, s_j, a_j = (np.asarray(x) for x in run(
        dp_j, jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask), 3))
    f_t, s_t, a_t = _port(cfg_t, params, keys, memory, mask, steps, K=K,
                          proj_b=np.asarray(dp_j.proj_b))
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=2e-4)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=2e-5)
    np.testing.assert_allclose(a_t, a_j, rtol=0, atol=8e-3)
    # the batch stopped at step 2K: rows that fired in the first block
    # decoded through the second one, and nothing after it
    assert np.all(s_t[:, 2 * K * r:] == 1.0) and np.all(f_t[:, 2 * K * r:] == 0)
    assert np.all(a_t[:, :, 2 * K:] == 0)
    for b in range(B):
        assert np.abs(f_t[b, K * r:2 * K * r]).max() > 1e-3, b


@pytest.mark.parametrize("t_in", [T_IN, 300])
def test_plain_block_matches_tpu_block_kernel(t_in):
    """`decode_block_plain` chained over blocks from explicit state equals
    the TPU block kernel `build_decoder_block_kernel`, block by block:
    frames, stops, alignments and the carried state — also past the
    monolithic kernel's 256 padded characters (T_in 300 -> 384 padded,
    as tests/test_decoder_kernel.py:219)."""
    cfg, cfg_t = small_cfg(), torch_cfg()
    rng = np.random.default_rng(1)
    B2, M2, k = 2, 24, 3
    memory = (rng.normal(size=(B2, t_in, M2)) * 0.5).astype(np.float32)
    mask = np.arange(t_in)[None, :] < np.asarray([t_in, t_in - 9])[:, None]
    keys = (rng.normal(size=(B2, t_in, cfg.tacotron.attention_dim))
            * 0.3).astype(np.float32)
    dec = Decoder(config=cfg)
    params = to_numpy(dec.init(
        dict(params=jax.random.PRNGKey(3), dropout=jax.random.PRNGKey(1),
             zoneout=jax.random.PRNGKey(2)),
        B2, k, jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask),
        method=Decoder.autoregressive)["params"])
    run = build_decoder_block_kernel(cfg, B2, t_in, k, M2,
                                     weight_dtype=jnp.float32, interpret=True)
    dp_j = extract_decoder_params({"decoder": params}, cfg)
    st_j = init_decoder_state(cfg, B2, t_in, M2)
    dp_t = dk.extract_decoder_params({"decoder": params}, cfg_t,
                                     device="cpu")
    st_t = dk.init_decoder_state(cfg_t, B2, t_in, M2, device="cpu")
    drop = drop_masks(cfg_t, B2, k, device="cpu")
    mels = cfg.audio.num_mels
    for blk in range(2):
        f_j, s_j, a_j, st_j = run(dp_j, jnp.asarray(keys),
                                  jnp.asarray(memory), jnp.asarray(mask),
                                  st_j, 3 + blk)
        f_t, s_t, a_t, st_t = dk.decode_block_plain(
            dp_t, cfg_t, torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask), st_t, drop)
        np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=0, atol=2e-4)
        np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=2e-5)
        np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=0, atol=8e-3)
        want = dict(xprev=np.asarray(st_j.xprev)[:, :mels],
                    c1=st_j.c1, h1=st_j.h1, c2=st_j.c2, h2=st_j.h2,
                    ctx=st_j.ctx, cum=np.asarray(st_j.cum)[:, :t_in])
        for name, w in want.items():
            np.testing.assert_allclose(getattr(st_t, name), np.asarray(w),
                                       rtol=0, atol=2e-4, err_msg=name)
        np.testing.assert_array_equal(st_t.pmax,
                                      np.asarray(st_j.pmax)[:, 0])


def test_plain_blocks_match_monolithic_kernel(setup):
    """`decode_block_plain` chained over blocks reproduces the TPU
    monolithic kernel's whole decode (tests/test_decoder_kernel.py:191)."""
    cfg, params, keys, memory, mask = setup
    cfg_t = torch_cfg()
    steps, k = 12, 4
    run = build_decoder_kernel(cfg, B, T_IN, steps, M,
                               weight_dtype=jnp.float32, interpret=True)
    f_j, s_j, a_j = (np.asarray(x) for x in run(
        extract_decoder_params({"decoder": params}, cfg), jnp.asarray(keys),
        jnp.asarray(memory), jnp.asarray(mask), 3))
    dp = dk.extract_decoder_params({"decoder": params}, cfg_t, device="cpu")
    state = dk.init_decoder_state(cfg_t, B, T_IN, M, device="cpu")
    drop = drop_masks(cfg_t, B, k, device="cpu")
    fs, ss, als = [], [], []
    for _ in range(steps // k):
        f, s_, a_, state = dk.decode_block_plain(
            dp, cfg_t, torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask), state, drop)
        fs.append(f.numpy())
        ss.append(s_.numpy())
        als.append(a_.numpy())
    np.testing.assert_allclose(np.concatenate(fs, 1), f_j, rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.concatenate(ss, 1), s_j, rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.concatenate(als, 2), a_j, rtol=0,
                               atol=8e-3)


def test_bf16_weights_stay_close(setup):
    """bf16 decode weights (the kernel's storage type) drift from f32 by a
    bounded amount over the 6 steps: bf16 keeps 8 mantissa bits, so
    atol 5e-2 on frames of scale ~1."""
    _, params, keys, memory, mask = setup
    cfg_t = torch_cfg()
    cfg_b = cfg_t.replace(tacotron=dataclasses.replace(
        cfg_t.tacotron, fused_decoder_dtype="bfloat16"))
    dp = dk.extract_decoder_params({"decoder": params}, cfg_b, device="cpu")
    assert dp.l1_wp.dtype == torch.bfloat16 and dp.l1_b.dtype == torch.float32
    f32_f, _, _ = _port(cfg_t, params, keys, memory, mask, STEPS)
    drop = drop_masks(cfg_b, B, STEPS, device="cpu")
    f_b, _, _ = dk.decode(dp, cfg_b, torch.as_tensor(keys),
                       torch.as_tensor(memory), torch.as_tensor(mask), drop,
                       steps=STEPS)
    np.testing.assert_allclose(f_b.numpy(), f32_f, rtol=0, atol=5e-2)


def test_dropout_masks_are_seeded():
    cfg_t = torch_cfg()
    cfg_d = cfg_t.replace(tacotron=dataclasses.replace(
        cfg_t.tacotron, dropout_rate=0.5))
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = drop_masks(cfg_d, 2, 3, g1, "cpu")
    b = drop_masks(cfg_d, 2, 3, g2, "cpu")
    assert a.shape == (2, 3, 2, 16)
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) <= {0.0, 2.0}


@pytest.mark.parametrize("cs", [1, 8])
def test_split_gates_reassembles_lstm_products(cs):
    """The decode kernel's per-CTA gate columns (`split_gates`) compute the
    same i, j, f, o pre-activations as the full LSTM kernel."""
    g = torch.Generator().manual_seed(0)
    K, U = 24, 32
    w, b = torch.randn(K, 4 * U, generator=g), torch.randn(4 * U, generator=g)
    x = torch.randn(K, generator=g)
    ws, bs = dk.split_gates(w, cs), dk.split_gates(b, cs)
    assert ws.shape == (cs, K, 4 * U // cs) and bs.shape == (cs, 4 * U // cs)
    uc = U // cs
    parts = [x @ ws[c] + bs[c] for c in range(cs)]
    full = (x @ w + b).reshape(4, U)
    for gate in range(4):
        got = torch.cat([p[gate * uc:(gate + 1) * uc] for p in parts])
        torch.testing.assert_close(got, full[gate])


@pytest.mark.parametrize("cs", [1, 8])
def test_pack_weights_layout(setup, cs):
    """The decode kernel's operands, laid out once by `pack_weights`: the
    LSTM kernels stacked [prenet | context | h] and split per CTA, the
    frame+stop projection padded with zero columns to a multiple of 8, and
    the location conv folded into the attention (`fold_location`)."""
    cfg, params, _, _, _ = setup
    dp = dk.extract_decoder_params({"decoder": params}, torch_cfg(),
                                   device="cpu")
    kw = dk.pack_weights(dp, cs)
    U, P = cfg.tacotron.decoder_lstm_units, cfg.tacotron.prenet_layers[-1]
    fo = dp.proj_b.shape[0]
    assert kw.cs == cs and kw.fop % 8 == 0 and kw.fop - 8 < fo <= kw.fop
    assert kw.l1_w.shape == (cs, P + M + U, 4 * U // cs)
    assert kw.l2_w.shape == (cs, 2 * U, 4 * U // cs)
    torch.testing.assert_close(
        kw.l1_w, dk.split_gates(torch.cat([dp.l1_wp, dp.l1_wc, dp.l1_wh]),
                                cs))
    torch.testing.assert_close(kw.l2_b, dk.split_gates(dp.l2_b, cs))
    torch.testing.assert_close(
        kw.proj_w[:, :fo], torch.cat([dp.proj_wo, dp.proj_wc]))
    assert torch.all(kw.proj_w[:, fo:] == 0) and torch.all(kw.proj_b[fo:] == 0)
    wp, b_eff = fold_location(dp.loc_k, dp.loc_b, dp.wloc, dp.b_a)
    torch.testing.assert_close(kw.wp, wp)
    torch.testing.assert_close(kw.b_eff, b_eff)
    assert all(t.is_contiguous() for t in kw if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("cs", [1, 8])
def test_pack_state_round_trip(cs):
    """The decode kernel's per-row state vector (`pack_state`): the head of
    its shared memory [xprev | 0 | 0 | ctx | h1 | h2 | ctx] and then each
    CTA's c1, c2 units; `unpack_state` inverts it. Under emt_attn ctx_emt
    follows the first ctx; without it ctx_emt is None both ways."""
    g = torch.Generator().manual_seed(0)
    Bs, mels, P, Mw, U, T = 3, 20, 16, 48, 32, 7
    r = lambda *s: torch.randn(*s, generator=g)
    st = dk.DecoderKernelState(
        r(Bs, mels), r(Bs, U), r(Bs, U), r(Bs, U), r(Bs, U), r(Bs, Mw),
        r(Bs, T), torch.randint(0, T, (Bs,), generator=g, dtype=torch.int32))
    vec, cum, pmax = dk.pack_state(st, P, cs)
    assert vec.shape == (Bs, mels + 2 * P + 2 * Mw + 4 * U)
    o = mels + 2 * P
    torch.testing.assert_close(vec[:, :mels], st.xprev)
    assert torch.all(vec[:, mels:o] == 0)
    torch.testing.assert_close(vec[:, o:o + Mw], st.ctx)
    torch.testing.assert_close(vec[:, o + Mw + 2 * U:o + 2 * Mw + 2 * U],
                               st.ctx)
    uc = U // cs
    c0 = o + 2 * Mw + 2 * U
    torch.testing.assert_close(vec[:, c0 + 2 * uc:c0 + 3 * uc] if cs > 1
                               else vec[:, c0:c0 + U],
                               st.c1[:, uc:2 * uc] if cs > 1 else st.c1)
    back = dk.unpack_state(vec, cum, pmax, mels, P, Mw, cs)
    assert st.ctx_emt is None and back.ctx_emt is None
    for name in st._fields[:-1]:
        assert torch.equal(getattr(back, name), getattr(st, name)), name
    E = 16
    st = st._replace(ctx_emt=r(Bs, E))
    vec, cum, pmax = dk.pack_state(st, P, cs)
    assert vec.shape == (Bs, mels + 2 * P + 2 * Mw + E + 4 * U)
    torch.testing.assert_close(vec[:, o + Mw:o + Mw + E], st.ctx_emt)
    torch.testing.assert_close(vec[:, o + Mw + E:o + Mw + E + U], st.h1)
    back = dk.unpack_state(vec, cum, pmax, mels, P, Mw, cs, E)
    for name in st._fields:
        assert torch.equal(getattr(back, name), getattr(st, name)), name
