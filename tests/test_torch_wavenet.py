"""The port's WaveNet heads, plain samplers and teacher-forced forward
against the JAX package's, on the CPU.

Small configurations of the JAX package's own sampler tests
(tests/test_pallas_kernels.py:20-139: 4 layers, R 128, G 256, S 128, B 2,
12 frames, upsample (2, 2), 80 mels) with flax-initialised weights, the
same numpy inputs and the same random numbers on both sides where the
algorithm allows it:

- mixture of logistics: `_setup_mol`'s noise-suppressed head (component 0
  dominates, log-scales pinned to -30), so every draw equals mean_0 and
  the JAX scan's own PRNG does not matter: atol 2e-4, as
  tests/test_pallas_kernels.py:94 (f32 both sides, other sum order over 4
  layers and 48 fed-back samples);
- categorical: PRNG streams cannot match, so the teacher-forced oracle of
  tests/test_pallas_kernels.py:142: the JAX scan replays the port's own
  trajectory (`test_inputs`) and each port pick must equal the
  inverse-CDF pick from the JAX logits with the port's uniforms, exactly;
  the only exception allowed is a tie, u·total within 1e-5 relative of a
  cumulative-sum boundary (f32 sums in another order), and they are
  counted;
- bf16 cache and weights: the port's plain version against the
  interpret-mode TPU kernel with the same dtypes, atol 3e-4 and under half
  of that kernel's own bf16-vs-f32 drift (the products' inputs round to
  bf16 at the same places on both sides, so the versions differ only where
  another f32 sum order moves a rounding by one bf16 step; a rounding put
  elsewhere differs by the order of the whole drift); against the port's
  f32 within the JAX package's own drift bounds 0.05 (cache) and 0.1
  (cache and weights), tests/test_pallas_kernels.py:183,282;
- the teacher-forced forward against flax `apply(train=False)` for all
  three heads: y_hat atol 1e-4 (f32, other sum order over 4 layers); under
  a bf16 compute config, which the port's eval forward does not apply,
  2e-2 of the peak (flax's bf16 rounding moves its output ~1e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.config import Config
from tacotron2_tpu.data.wavenet_feeder import interp_to_unit as jax_interp
from tacotron2_tpu.models.wavenet import distributions as JD
from tacotron2_tpu.models.wavenet.model import WaveNet as FlaxWaveNet
from tacotron2_tpu.models.wavenet.sampler import incremental_sample
from tacotron2_tpu.ops import mulaw as jmulaw
from tacotron2_tpu.ops.wavenet_kernel import (_HeadPlan,
                                              fused_incremental_sample)
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.config import Config as TorchConfig
from tacotron2_tpu_torch.data.wavenet_feeder import interp_to_unit
from tacotron2_tpu_torch.models.wavenet import distributions as D
from tacotron2_tpu_torch.models.wavenet.sampler import (
    extract_sampler_params, incremental_sample as port_sample)
from tacotron2_tpu_torch.ops import mulaw
from tacotron2_tpu_torch.ops import wavenet_kernel as wk
from torch_port_helpers import gate_units, to_numpy, unpack_sampler_slices

B, FRAMES, MELS, Q = 2, 12, 80, 256
T = FRAMES * 4
HEADS = {"gaussian": dict(out_channels=2),
         "mol": dict(out_channels=30),
         "categorical": dict(out_channels=Q, input_type="mulaw-quantize",
                             quantize_channels=Q)}


def head_cfg(kind, cls=Config, **extra):
    """tests/test_pallas_kernels.py's sampler config with `kind`'s head,
    built from either package's Config class."""
    cfg = cls()
    return cfg.replace(
        wavenet=dataclasses.replace(
            cfg.wavenet, layers=4, stacks=2, residual_channels=128,
            gate_channels=256, skip_out_channels=128, upsample_scales=(2, 2),
            cin_channels=MELS, **HEADS[kind], **extra),
        audio=dataclasses.replace(cfg.audio, num_mels=MELS, hop_size=4))


_cache = {}


def head_setup(kind, noise="live", **extra):
    """(flax params as numpy, mels c [B, FRAMES, MELS], c_up) for `kind`,
    with the head as _setup / _setup_mol / _setup_categorical leave it:
    noise "suppressed" (Gaussian, MoL), "sharp" (categorical logits ×
    30000) or "live"."""
    key = (kind, noise, tuple(sorted(extra.items())))
    if key in _cache:
        return _cache[key]
    cfg = head_cfg(kind, **extra)
    model = FlaxWaveNet(config=cfg)
    c = np.random.default_rng(0).uniform(0, 1, (B, FRAMES, MELS)).astype(
        np.float32)
    x0 = jnp.zeros((B, T, Q if kind == "categorical" else 1))
    params = to_numpy(model.init(
        dict(params=jax.random.PRNGKey(0), dropout=jax.random.PRNGKey(1)),
        x0, jnp.asarray(c), train=False)["params"])
    fc2 = params["final_convolution_2"].get("Dense_0", {})
    if noise != "live":
        fc2["kernel"], fc2["bias"] = fc2["kernel"].copy(), fc2["bias"].copy()
    if noise == "suppressed" and kind == "gaussian":
        fc2["bias"][1], fc2["kernel"][:, 1] = -30.0, 0.0
    elif noise == "suppressed" and kind == "mol":
        fc2["bias"][0], fc2["bias"][1:10], fc2["bias"][20:30] = 100, -100, -30
        fc2["kernel"][:, 0:10] = fc2["kernel"][:, 20:30] = 0.0
    elif noise == "sharp":
        fc2["kernel"] *= 30000.0
        fc2["bias"] *= 30000.0
    c_up = np.array(model.apply({"params": params}, jnp.asarray(c),
                                method=FlaxWaveNet.upsample))
    _cache[key] = params, c, c_up
    return _cache[key]


def port(kind, params, **extra):
    cfg = head_cfg(kind, TorchConfig, **extra)
    return cfg, extract_sampler_params(params, cfg, device="cpu")


def uniforms(planes, seed=3):
    bits = torch.randint(0, 1 << 24, (planes, B, T),
                         generator=torch.Generator().manual_seed(seed))
    return D.uniform_from_bits(bits)


# ------------------------------------------------------------------ heads


@pytest.mark.parametrize("u", [0.0, 0.5, 1.0 - 2 ** -25, 1.0])
def test_inverse_cdf_onehot_matches_jax(u):
    """tests/test_pallas_kernels.py:295's extreme uniforms, and random
    logits of the categorical width, against `_HeadPlan._inverse_cdf_
    onehot`: the same one-hot, exactly one-hot."""
    rng = np.random.default_rng(4)
    for logits in (np.log([[0.2, 0.5, 0.3], [0.9, 0.05, 0.05]]),
                   rng.normal(0, 3, (8, Q))):
        logits = logits.astype(np.float32)
        uu = np.full(len(logits), u, np.float32)
        want = np.asarray(_HeadPlan._inverse_cdf_onehot(
            jnp.asarray(logits), jnp.asarray(uu)))
        got = D.inverse_cdf_onehot(torch.as_tensor(logits),
                                   torch.as_tensor(uu)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got.sum(-1) == 1).all() and ((got == 0) | (got == 1)).all()
    first = D.inverse_cdf_pick(torch.zeros(2, 3), torch.zeros(2))
    last = D.inverse_cdf_pick(torch.zeros(2, 3), torch.ones(2))
    assert first.tolist() == [0, 0] and last.tolist() == [2, 2]


def test_inverse_cdf_frequencies_follow_the_softmax():
    """tests/test_pallas_kernels.py:165: over 4000 of the port's 24-bit
    uniforms the picks' frequencies lie within 4/sqrt(n) of the softmax."""
    logits = torch.tensor([[1.0, 0.0, 2.0, -1.0, 0.5, 0.0, 0.0, 1.5]])
    n = 4000
    u = D.uniform_from_bits(torch.randint(
        0, 1 << 24, (n,), generator=torch.Generator().manual_seed(0)))
    picks = D.inverse_cdf_pick(logits.expand(n, -1), u)
    freq = torch.bincount(picks, minlength=8).double() / n
    probs = torch.softmax(logits[0].double(), 0)
    assert torch.all((freq - probs).abs() < 4.0 / np.sqrt(n)), (freq, probs)


def test_uniforms_are_never_0_or_1():
    u = D.uniform_from_bits(torch.tensor([0, (1 << 24) - 1]))
    assert u[0] == 2 ** -25 and u[1] == 1 - 2 ** -25
    cfg = head_cfg("mol", TorchConfig)
    noise = D.draw_noise(cfg, 3, 5, torch.Generator().manual_seed(0), "cpu")
    assert noise.shape == (2, 3, 5) and (noise > 0).all() and (noise < 1).all()
    z = D.draw_noise(head_cfg("gaussian", TorchConfig), 3, 5,
                     torch.Generator().manual_seed(0), "cpu")
    assert z.shape == (1, 3, 5)
    assert torch.equal(z[0], torch.randn(
        3, 5, generator=torch.Generator().manual_seed(0)))


def test_head_kind_follows_the_config():
    assert D.head_kind(head_cfg("gaussian", TorchConfig)) == ("gaussian", 1)
    assert D.head_kind(head_cfg("mol", TorchConfig)) == ("mol", 2)
    assert D.head_kind(head_cfg("categorical", TorchConfig)) == \
        ("categorical", 1)
    for bad in (dict(out_channels=4),
                dict(input_type="mulaw-quantize", quantize_channels=256,
                     out_channels=30)):
        cfg = TorchConfig()
        with pytest.raises(ValueError):
            D.head_kind(cfg.replace(wavenet=dataclasses.replace(
                cfg.wavenet, **bad)))


def test_mol_sample_formula():
    """The MoL draw against a numpy transcription of `_HeadPlan.emit`
    (:159-171) at the same uniforms."""
    rng = np.random.default_rng(2)
    y = rng.normal(0, 2, (64, 30)).astype(np.float32)
    y[:8, 20:] = -40.0                     # below the log-scale floor
    u0, u1 = (rng.uniform(0, 1, 64).astype(np.float32) for _ in range(2))
    u1[:2] = (0.0, 1.0)                    # clipped to [1e-5, 1-1e-5]
    lo = -7.0
    oh = np.asarray(_HeadPlan._inverse_cdf_onehot(jnp.asarray(y[:, :10]),
                                                  jnp.asarray(u0)))
    mean = (y[:, 10:20] * oh).sum(-1)
    log_s = np.maximum((y[:, 20:] * oh).sum(-1), lo)
    uc = np.clip(u1, 1e-5, 1 - 1e-5)
    want = np.clip(mean + np.exp(log_s) * (np.log(uc) - np.log(1 - uc)),
                   -1, 1)
    got = D.mol_sample(torch.as_tensor(y), torch.as_tensor(u0),
                       torch.as_tensor(u1), lo)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_discretized_mix_logistic_sample_matches_jax():
    """`sample_from_discretized_mix_logistic` with the uniforms the JAX
    function draws from its key, made the same way and handed over."""
    rng = np.random.default_rng(3)
    y = rng.normal(0, 1, (2, 16, 30)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = np.asarray(JD.sample_from_discretized_mix_logistic(
        key, jnp.asarray(y)))
    k1, k2 = jax.random.split(key)
    temp = jax.random.uniform(k1, (2, 16, 10), minval=1e-5,
                              maxval=1 - 1e-5)
    u = jax.random.uniform(k2, (2, 16), minval=1e-5, maxval=1 - 1e-5)
    got = D.sample_from_discretized_mix_logistic(
        torch.as_tensor(y), torch.as_tensor(np.array(temp)),
        torch.as_tensor(np.array(u)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_mulaw_and_interp_match_jax():
    x = np.linspace(-1, 1, 257).astype(np.float32)
    for mu in (255, 2 ** 16 - 1):
        for fn in ("mulaw", "inv_mulaw"):
            want = np.asarray(getattr(jmulaw, fn)(x, mu))
            np.testing.assert_allclose(getattr(mulaw, fn)(x, mu), want,
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(
                getattr(mulaw, fn)(torch.as_tensor(x), mu).numpy(), want,
                rtol=1e-6, atol=1e-7)
        q = mulaw.mulaw_quantize(x, mu)
        np.testing.assert_array_equal(q, jmulaw.mulaw_quantize(x, mu))
        np.testing.assert_array_equal(
            mulaw.mulaw_quantize(torch.as_tensor(x), mu).numpy(), q)
        np.testing.assert_allclose(
            mulaw.inv_mulaw_quantize(q, mu),
            jmulaw.inv_mulaw_quantize(q, mu), rtol=1e-6, atol=1e-7)
    assert mulaw.mulaw_quantize(np.zeros(1, np.float32))[0] == 127
    for t in ("raw", "mulaw", "mulaw-quantize"):
        for fn in ("is_raw", "is_mulaw", "is_mulaw_quantize",
                   "is_scalar_input"):
            assert getattr(mulaw, fn)(t) == getattr(jmulaw, fn)(t)
    m = np.random.default_rng(0).uniform(-4, 4, (5, 20)).astype(np.float32)
    for sym in (True, False):
        cfg, tcfg = Config(), TorchConfig()
        cfg = cfg.replace(audio=dataclasses.replace(cfg.audio,
                                                    symmetric_mels=sym))
        tcfg = tcfg.replace(audio=dataclasses.replace(tcfg.audio,
                                                      symmetric_mels=sym))
        np.testing.assert_allclose(interp_to_unit(m, tcfg),
                                   jax_interp(m, cfg), rtol=1e-6)


# --------------------------------------------------------------- samplers


def test_plain_mol_sampler_matches_jax():
    params, _, c_up = head_setup("mol", "suppressed")
    cfg, sp = port("mol", params)
    got = port_sample(sp, cfg, torch.as_tensor(c_up), uniforms(2)).numpy()
    want, _ = incremental_sample(params, head_cfg("mol"), jnp.asarray(c_up),
                                 jax.random.PRNGKey(9))
    want_k = fused_incremental_sample(params, head_cfg("mol"),
                                      jnp.asarray(c_up), seed=9, chunk=16,
                                      interpret=True)
    assert np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(want_k), rtol=0, atol=2e-4)


def _ties(logits, u, picks):
    """Per step: whether u·total lies within 1e-5 relative of a boundary of
    the f32 cumulative sum (then either neighbour is a fair pick)."""
    e = np.exp(logits - logits.max(-1, keepdims=True))
    cum = np.cumsum(e.astype(np.float32), -1, dtype=np.float32)
    target = u * cum[..., -1]
    return np.abs(cum - target[..., None]).min(-1) <= 1e-5 * cum[..., -1]


@pytest.mark.parametrize("noise", ["live", "sharp"])
def test_plain_categorical_sampler_matches_teacher_forced_oracle(noise):
    """Random-init logits (picks spread over many classes) and the
    sharpened ones of _setup_categorical (near-argmax trajectories)."""
    params, _, c_up = head_setup("categorical", noise)
    cfg, sp = port("categorical", params)
    u = uniforms(1)
    got, y_port = port_sample(sp, cfg, torch.as_tensor(c_up), u,
                              return_y_hat=True)
    got = got.numpy()
    assert got.shape == (B, T) and (got == np.round(got)).all()
    tf = jax.nn.one_hot(jnp.asarray(got, jnp.int32), Q)
    _, y_hat = incremental_sample(params, head_cfg("categorical"),
                                  jnp.asarray(c_up), jax.random.PRNGKey(0),
                                  test_inputs=tf)
    yh = np.asarray(y_hat, np.float32)
    uu = u[0].numpy()
    expected = np.asarray(_HeadPlan._inverse_cdf_onehot(
        jnp.asarray(yh.reshape(-1, Q)), jnp.asarray(uu.reshape(-1)))
    ).argmax(-1).reshape(B, T)
    ties = _ties(yh, uu, got)
    print(f"categorical picks: {int((got != expected).sum())} differ, "
          f"{int(ties.sum())} ties")
    assert ((got == expected) | ties).all()
    if noise == "live":
        assert len(np.unique(got)) > 8      # a spread, not one class
    # the port's teacher-forced y_hat is the JAX one (f32, sum order)
    _, y_tf = port_sample(sp, cfg, torch.as_tensor(c_up), u,
                          test_inputs=torch.as_tensor(np.array(tf)),
                          return_y_hat=True)
    np.testing.assert_allclose(y_tf.numpy(), yh, rtol=1e-4,
                               atol=1e-4 * (30000 if noise == "sharp" else 1))
    np.testing.assert_allclose(y_port.numpy(), y_tf.numpy(), rtol=0, atol=0)


def test_plain_bf16_sampler_matches_tpu_kernel():
    params, _, c_up = head_setup("gaussian", "suppressed")
    cfg, sp = port("gaussian", params)
    z = torch.zeros(1, B, T)
    jcfg = head_cfg("gaussian")
    run = lambda **kw: np.asarray(fused_incremental_sample(
        params, jcfg, jnp.asarray(c_up), seed=9, chunk=16, interpret=True,
        **kw))
    want = run(cache_dtype=jnp.bfloat16, weight_dtype=jnp.bfloat16)
    drift = np.abs(want - run()).max()
    got = port_sample(sp, cfg, torch.as_tensor(c_up), z,
                      cache_dtype=torch.bfloat16,
                      weight_dtype=torch.bfloat16).numpy()
    err = np.abs(got - want).max()
    print(f"bf16: port vs TPU kernel {err:.3e}; the kernel's drift from "
          f"f32 {drift:.3e}")
    assert err <= 3e-4 and err <= 0.5 * drift, (err, drift)
    want_c = run(cache_dtype=jnp.bfloat16)
    got_c = port_sample(sp, cfg, torch.as_tensor(c_up), z,
                        cache_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtypes,bound", [
    ((torch.bfloat16, torch.float32), 0.05),
    ((torch.bfloat16, torch.bfloat16), 0.1)], ids=["cache", "cache+weights"])
def test_plain_bf16_sampler_drift_within_jax_bounds(dtypes, bound):
    params, _, c_up = head_setup("gaussian", "suppressed")
    cfg, sp = port("gaussian", params)
    z = torch.zeros(1, B, T)
    f32 = port_sample(sp, cfg, torch.as_tensor(c_up), z)
    bf = port_sample(sp, cfg, torch.as_tensor(c_up), z,
                     cache_dtype=dtypes[0], weight_dtype=dtypes[1])
    err = float((bf - f32).abs().max())
    assert 0 < err < bound, err


def test_sample_wrapper_takes_every_head_on_the_cpu():
    """`ops/wavenet_kernel.sample` on CPU tensors is the plain version for
    each head and dtype, and launches nothing."""
    before = wk.launches
    for kind, planes in (("gaussian", 1), ("mol", 2), ("categorical", 1)):
        params, _, c_up = head_setup(kind)
        cfg, sp = port(kind, params)
        noise = uniforms(planes)
        for dt in (torch.float32, torch.bfloat16):
            got = wk.sample(sp, cfg, torch.as_tensor(c_up), noise,
                            cache_dtype=dt, weight_dtype=dt)
            want = port_sample(sp, cfg, torch.as_tensor(c_up), noise,
                               cache_dtype=dt, weight_dtype=dt)
            assert torch.equal(got, want)
        with pytest.raises(ValueError):           # planes of another head
            wk.sample(sp, cfg, torch.as_tensor(c_up), uniforms(3 - planes))
    with pytest.raises(ValueError):
        wk.sample(sp, cfg, torch.as_tensor(c_up), uniforms(1),
                  cache_dtype=torch.float16)
    assert wk.launches == before


@pytest.mark.parametrize("kind,dtype", [
    ("mol", torch.float32), ("categorical", torch.float32),
    ("gaussian", torch.bfloat16), ("mol", torch.bfloat16),
    ("categorical", torch.bfloat16)])
def test_pack_weights_layout_for_heads_and_dtypes(kind, dtype):
    """The operands the kernel takes for each head and dtype compute the
    plain layer's products from the dtype-rounded weights, the head keeps
    its columns (zero-padded to a multiple of 4), and the categorical
    first conv is the dtype-rounded [Q, R] table the kernel gathers."""
    params, _, _ = head_setup(kind)
    cfg, sp = port(kind, params)
    kw = wk.pack_weights(sp, cfg, 8, cache_dtype=dtype, weight_dtype=dtype)
    wn = cfg.wavenet
    R, G, S = wn.residual_channels, wn.gate_channels, wn.skip_out_channels
    assert kw.head == kind and kw.n_out == wn.out_channels
    assert kw.slices.dtype == torch.uint8
    assert kw.f2w.dtype == kw.first_w.dtype == torch.float32
    assert kw.f2w.shape == (S, -(-wn.out_channels // 4) * 4)
    assert torch.equal(kw.f2w[:, :wn.out_channels], sp.final2_w)
    assert torch.all(kw.f2w[:, wn.out_channels:] == 0)
    rd = lambda w: w.to(dtype).float()
    n_in = Q if kind == "categorical" else 1
    assert kw.first_w.shape == (n_in, R)
    assert torch.equal(kw.first_w, rd(sp.first_w) if kind == "categorical"
                       else sp.first_w)
    lay = wk.slice_layout(cfg, 8, dtype)
    wx, wo, ws, bg, bs = unpack_sampler_slices(kw.slices, lay, dtype)
    gc, sc = G // 16, S // 8
    g = torch.Generator().manual_seed(0)
    v = torch.randn(3 * R + MELS, generator=g)
    v_old = torch.nn.functional.pad(torch.cat([v[:2 * R], v[3 * R:]]),
                                    (0, lay.c16 - MELS))
    hv = torch.randn(G // 2, generator=g)
    for l, lp in enumerate(sp.layers):
        full = v @ rd(torch.cat([lp.conv_w, lp.cin_w], 0)) + lp.conv_b + \
            lp.cin_b
        parts = [gate_units(wx[c, l] @ v[2 * R:3 * R] + wo[c, l] @ v_old
                            + bg[c, l], gc) for c in range(8)]
        a = torch.cat([p[0] for p in parts])
        b = torch.cat([p[1] for p in parts])
        torch.testing.assert_close(torch.cat([a, b]), full)
        so = [ws[c, l] @ hv + bs[c, l] for c in range(8)]
        torch.testing.assert_close(torch.cat([p[:sc] for p in so]),
                                   hv @ rd(lp.skip_w) + lp.skip_b)
        torch.testing.assert_close(torch.cat([p[sc:sc + R // 8] for p in so]),
                                   hv @ rd(lp.out_w) + lp.out_b)
    other = "gaussian" if kind != "gaussian" else "mol"
    with pytest.raises(ValueError):               # weights of another head
        wk.pack_weights(sp, head_cfg(other, TorchConfig))


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("kind,extra", [
    ("gaussian", {}), ("mol", {}), ("categorical", {}),
    ("gaussian", dict(weight_normalization=True))],
    ids=["gaussian", "mol", "categorical", "gaussian-weight-norm"])
def test_teacher_forced_forward_matches_flax(kind, extra):
    """Weight norm's v / g trees are materialised by the bridge."""
    params, c, _ = head_setup(kind, **extra)
    rng = np.random.default_rng(6)
    if kind == "categorical":
        x = np.eye(Q, dtype=np.float32)[rng.integers(0, Q, (B, T))]
    else:
        x = rng.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32)
    if extra:
        assert "v" in params["residual_block_0"]["causal_conv"]
    out = FlaxWaveNet(config=head_cfg(kind, **extra)).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(c), train=False)
    m = convert.wavenet_from_flax(head_cfg(kind, TorchConfig, **extra),
                                  params, "cpu")
    y_hat, c_up = m(torch.as_tensor(x), torch.as_tensor(c))
    np.testing.assert_allclose(c_up.numpy(), np.asarray(
        out.upsampled_features), rtol=0, atol=1e-5)
    assert y_hat.dtype == torch.float32
    np.testing.assert_allclose(y_hat.numpy(), np.asarray(out.y_hat),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("legacy", [True, False])
def test_teacher_forced_forward_under_bf16_compute(legacy):
    """wavenet.compute_dtype=bfloat16 (the r5 config), with and without the
    legacy √0.5 scalings (the paper preset turns them off): the port's
    forward stays f32, equal to the f32 config's and within 2e-2 of the
    peak of flax's bf16 output (bf16 keeps 8 bits of each value of the
    4-layer stack)."""
    extra = dict(legacy=legacy, residual_legacy=legacy)
    params, c, _ = head_setup("gaussian")
    x = np.random.default_rng(6).uniform(-0.5, 0.5, (B, T, 1)).astype(
        np.float32)
    out = FlaxWaveNet(config=head_cfg(
        "gaussian", compute_dtype="bfloat16", **extra)).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(c), train=False)
    port = lambda **kw: convert.wavenet_from_flax(
        head_cfg("gaussian", TorchConfig, **extra, **kw), params, "cpu")(
        torch.as_tensor(x), torch.as_tensor(c))[0]
    y_hat = port(compute_dtype="bfloat16")
    assert y_hat.dtype == torch.float32 and torch.equal(y_hat, port())
    want = np.asarray(out.y_hat, np.float32)
    np.testing.assert_allclose(y_hat.numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
