"""The port's plain decode (the CUDA decode kernel's plain version)
against the JAX package's decoders, on the CPU.

Same inputs from numpy seeds into (a) the TPU decode kernel
`build_decoder_kernel(..., interpret=True)` with f32 weights and (b) the
flax scan `Decoder.autoregressive`, at `tacotron.dropout_rate=0` as in
tests/test_decoder_kernel.py. Tolerances are the JAX package's own for the
kernel-vs-scan comparison (frames atol 2e-4, stop probs 2e-5): both sides
are f32 with a different summation order over the 2-layer LSTM and the
attention. The early-stop block rule is checked as tests/test_decoder_
kernel.py:160 checks it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.tacotron.decoder import Decoder
from tacotron2_tpu.ops.tacotron_decoder_kernel import (build_decoder_kernel,
                                                       extract_decoder_params)
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
    f, s = dk.decode(dp, cfg_t, torch.as_tensor(keys),
                     torch.as_tensor(memory), torch.as_tensor(mask), drop,
                     steps=steps, early_stop_block=K)
    return f.numpy(), s.numpy()


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
                               weight_dtype=jnp.float32,
                               emit_alignments=False, interpret=True)
    f_j, s_j, _ = run(dp, jnp.asarray(keys), jnp.asarray(memory),
                      jnp.asarray(mask), 3)
    f_t, s_t = _port(cfg_t, params, keys, memory, mask, STEPS)
    assert f_t.shape == np.asarray(f_j).shape
    np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=0, atol=2e-4)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=2e-5)


def test_plain_decode_matches_flax_scan(setup):
    cfg, params, keys, memory, mask = setup
    f_j, s_j, _, _ = Decoder(config=cfg).apply(
        {"params": params}, B, STEPS, jnp.asarray(keys), jnp.asarray(memory),
        jnp.asarray(mask), method=Decoder.autoregressive,
        rngs=dict(dropout=jax.random.PRNGKey(7),
                  zoneout=jax.random.PRNGKey(8)))
    f_t, s_t = _port(torch_cfg(), params, keys, memory, mask, STEPS)
    np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=0, atol=2e-4)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=2e-5)


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
    f_t, s_t = _port(torch_cfg(), params, keys, memory, mask, steps, K=K,
                     proj_b=np.asarray(dp.proj_b))
    np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=0, atol=2e-4)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=2e-5)
    if stop_bias > 0:
        assert np.all(s_t[:, K * r:] == 1.0) and np.all(f_t[:, K * r:] == 0)


def test_early_stop_is_per_row(setup):
    """A row whose stop fires leaves at its block boundary while the other
    rows decode on, unchanged from the full run."""
    cfg, params, keys, memory, mask = setup
    cfg_t = torch_cfg()
    r = cfg.tacotron.outputs_per_step
    steps, K = 12, 4
    dp = dk.extract_decoder_params({"decoder": params}, cfg_t, device="cpu")
    drop = drop_masks(cfg_t, B, steps, device="cpu")
    args = (torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask), drop)
    f_full, s_full = dk.decode(dp, cfg_t, *args, steps=steps)
    # the stop threshold between row 0's and the others' first stop logits
    p0 = s_full[:, 0].numpy()
    order = np.argsort(p0)
    cut = 0.5 * (p0[order[-1]] + p0[order[-2]])
    bias = dp.proj_b.clone()
    logit = np.log(cut / (1 - cut))
    bias[-r:] -= float(logit)
    dp2 = dp._replace(proj_b=bias)
    f_full2, s_full2 = dk.decode(dp2, cfg_t, *args, steps=steps)
    f_blk, s_blk = dk.decode(dp2, cfg_t, *args, steps=steps,
                             early_stop_block=K)
    fired_first = (s_full2[:, :r] > 0.5).all(-1).numpy()
    assert fired_first.sum() >= 1
    for b in range(B):
        if fired_first[b]:
            np.testing.assert_array_equal(f_blk[b, :K * r], f_full2[b, :K * r])
            assert torch.all(s_blk[b, K * r:] == 1.0)
            assert torch.all(f_blk[b, K * r:] == 0.0)
    never = ~(s_full2.reshape(B, steps, r) > 0.5).all(-1).any(-1).numpy()
    for b in np.nonzero(never)[0]:
        np.testing.assert_array_equal(f_blk[b], f_full2[b])


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
    f32_f, _ = _port(cfg_t, params, keys, memory, mask, STEPS)
    drop = drop_masks(cfg_b, B, STEPS, device="cpu")
    f_b, _ = dk.decode(dp, cfg_b, torch.as_tensor(keys),
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
