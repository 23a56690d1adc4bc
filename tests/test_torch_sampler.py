"""The port's plain sampler (the CUDA sampler kernel's plain version)
against the JAX package's samplers, on the CPU.

Noise-free oracle as in tests/test_pipeline_program.py: the log-scale
channel of the Gaussian head is pinned to -30, so exp(max(-30, log_min))
= 1e-7 scales the noise and every sample equals the predicted mean up to
~1e-6. That makes the JAX scan `incremental_sample` (jax.random noise) and
the interpret-mode TPU kernel `fused_incremental_sample` (whose in-kernel
PRNG bits are zero on the CPU) comparable with the port fed z = 0. The
samples are fed back, so the comparison covers the whole loop. Tolerance
atol 2e-4 (as tests/test_pipeline_program.py's atol 2e-3 / rtol 1e-2 on
samples, tightened): f32 on both sides, different summation order through
4 layers and 64 autoregressive steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.wavenet.sampler import incremental_sample
from tacotron2_tpu.ops.wavenet_kernel import fused_incremental_sample
from tacotron2_tpu_torch.models.wavenet.sampler import (
    extract_sampler_params, gaussian_sample)
from tacotron2_tpu_torch.ops import wavenet_kernel as wk
from torch_port_helpers import (MELS, flax_weights, gate_units, small_cfg,
                                torch_cfg, unpack_sampler_slices)

B, T = 2, 64


@pytest.fixture(scope="module")
def setup():
    _, _, wparams = flax_weights()
    c_up = np.random.default_rng(5).uniform(0, 1, (B, T, MELS)).astype(
        np.float32)
    sp = extract_sampler_params(wparams, torch_cfg(), device="cpu")
    got = wk.sample(sp, torch_cfg(), torch.as_tensor(c_up),
                    torch.zeros(B, T)).numpy()
    return wparams, c_up, got


def test_plain_sampler_matches_scan(setup):
    wparams, c_up, got = setup
    want, _ = incremental_sample(wparams, small_cfg(), jnp.asarray(c_up),
                                 jax.random.PRNGKey(9))
    assert got.shape == (B, T)
    assert np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-4)


def test_plain_sampler_matches_tpu_kernel(setup):
    wparams, c_up, got = setup
    want = fused_incremental_sample(wparams, small_cfg(), jnp.asarray(c_up),
                                    3, chunk=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-4)


def test_gaussian_head_formula():
    rng = np.random.default_rng(1)
    y = rng.normal(0, 2, (64, 2)).astype(np.float32)
    y[:8, 1] = -40.0                    # below the log-scale floor
    z = rng.normal(size=64).astype(np.float32)
    lo = small_cfg().wavenet.log_scale_min_gauss
    want = np.clip(y[:, 0] + np.exp(np.maximum(y[:, 1], lo)) * z, -1, 1)
    got = gaussian_sample(torch.as_tensor(y), torch.as_tensor(z), lo)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_noise_enters_the_feedback_loop(setup):
    """With a live log-scale the injected z changes the samples, and the
    same z gives the same samples."""
    _, _, wparams = flax_weights(pin_noise=False)
    c_up = torch.as_tensor(setup[1])
    sp = extract_sampler_params(wparams, torch_cfg(), device="cpu")
    z = torch.randn(B, T, generator=torch.Generator().manual_seed(0))
    a = wk.sample(sp, torch_cfg(), c_up, z)
    b = wk.sample(sp, torch_cfg(), c_up, z)
    c = wk.sample(sp, torch_cfg(), c_up, torch.zeros(B, T))
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cs", [1, 8, 16])
def test_stack_weights_layout(cs, dtype):
    """The kernel's operands, split over a cluster of `cs` CTAs and read
    back as the warps' mma A fragments, compute the plain layer's products
    from the dtype-rounded weights: CTA c's gate (a | b) units, from the
    x_t rows plus the older taps' and c_t rows, and its skip and residual
    columns reassemble into the full ones; the padding is zero."""
    _, _, wparams = flax_weights()
    cfg = torch_cfg()
    sp = extract_sampler_params(wparams, cfg, device="cpu")
    slices, f2w, f2b = wk.stack_weights(sp, cfg, cs, dtype)
    lay = wk.slice_layout(cfg, cs, dtype)
    wn = cfg.wavenet
    R, G, S = wn.residual_channels, wn.gate_channels, wn.skip_out_channels
    gc, sc, rc = G // (2 * cs), S // cs, R // cs
    assert slices.dtype == torch.uint8
    assert slices.shape == (cs, wn.layers, lay.bytes)
    assert lay.c16 == 32 and lay.ks == (16 if dtype == torch.bfloat16
                                        else 8)
    assert lay.mtg == gc // 8 and lay.mts == (sc + rc) // 16
    assert f2w.shape == (S, 4) and torch.all(f2w[:, 2:] == 0)
    wx, wo, ws, bg, bs = unpack_sampler_slices(slices, lay, dtype)
    assert torch.all(wo[..., 2 * R + MELS:] == 0)
    assert torch.all(ws[:, :, sc + rc:] == 0) and torch.all(bs[..., sc + rc:] == 0)
    rd = lambda w: w.to(dtype).float()
    g = torch.Generator().manual_seed(0)
    v = torch.randn(3 * R + MELS, generator=g)
    v_old = torch.nn.functional.pad(torch.cat([v[:2 * R], v[3 * R:]]),
                                    (0, lay.c16 - MELS))
    hv = torch.randn(G // 2, generator=g)
    for l, lp in enumerate(sp.layers):
        full = v @ rd(torch.cat([lp.conv_w, lp.cin_w], 0)) + lp.conv_b + \
            lp.cin_b
        parts = [gate_units(wx[c, l] @ v[2 * R:3 * R] + wo[c, l] @ v_old
                            + bg[c, l], gc) for c in range(cs)]
        a = torch.cat([p[0] for p in parts])
        b = torch.cat([p[1] for p in parts])
        torch.testing.assert_close(torch.cat([a, b]), full)
        so = [ws[c, l] @ hv + bs[c, l] for c in range(cs)]
        torch.testing.assert_close(torch.cat([p[:sc] for p in so]),
                                   hv @ rd(lp.skip_w) + lp.skip_b)
        torch.testing.assert_close(torch.cat([p[sc:sc + rc] for p in so]),
                                   hv @ rd(lp.out_w) + lp.out_b)
    dil, offs, rows = wk.ring_layout(cfg)
    assert list(dil) == list(wn.dilations)
    assert rows == sum(2 * d + 1 for d in wn.dilations)
    assert offs[0] == 0 and offs[1] == 2 * dil[0] + 1


@pytest.mark.parametrize("B", [1, 3, 8, 9, 32])
def test_row_plan(B):
    """ceil(B/8) clusters of 8 rows; row b is row b % 8 of cluster b // 8;
    the last cluster's missing rows are padding."""
    plan = wk.row_plan(B)
    assert plan.clusters == -(-B // 8) == {1: 1, 3: 1, 8: 1, 9: 2, 32: 4}[B]
    assert plan.rows == 8 * plan.clusters and plan.padded == plan.rows - B
    assert plan.padded == {1: 7, 3: 5, 8: 0, 9: 7, 32: 0}[B]
    assert wk.ROWS_PER_CLUSTER == 8
    assert wk.cluster_size(torch.bfloat16) == 8
    assert wk.cluster_size(torch.float32) == 16


def _cluster_replay(kw, sp, cfg, c_up, noise):
    """csrc/sampler.cu's data flow in PyTorch, f32, Gaussian head: the
    batch padded to whole clusters (zero conditioning and noise), one delay
    ring per row; per layer the older-tap part of each CTA's gate product
    ([x_{t-2d} | x_{t-d} | c_t zero-padded] against its unpacked tiles,
    made before the layer's x_t exists) plus the x_t part, the gate of its
    units, h gathered from the CTAs, each CTA's skip and residual columns,
    the skip sums gathered for the head; the sample fed back into every
    row's first conv."""
    wn = cfg.wavenet
    R, G, S = wn.residual_channels, wn.gate_channels, wn.skip_out_channels
    cs = kw.cs
    lay = wk.slice_layout(cfg, cs, kw.weight_dtype)
    gc, sc, rc = lay.gc, lay.sc, lay.rc
    wx, wo, ws, bg, bs = unpack_sampler_slices(kw.slices, lay,
                                                kw.weight_dtype)
    B, T, C = c_up.shape
    plan = wk.row_plan(B)
    Rb = plan.rows
    c = torch.zeros(Rb, T, lay.c16)
    c[:B, :, :C] = c_up
    z = torch.zeros(Rb, T)
    z[:B] = noise[0]
    dil, offs, rows = wk.ring_layout(cfg)
    ring = torch.zeros(Rb, rows, R)
    scale = float(np.sqrt(np.float32(0.5)))
    prev = torch.zeros(Rb)
    out = torch.zeros(Rb, T)
    for t in range(T):
        x = prev[:, None] * kw.first_w[0] + kw.first_b
        skips = torch.zeros(Rb, S)
        for l in range(wn.layers):
            d = int(dil[l])
            w, o = 2 * d + 1, int(offs[l])
            ring[:, o + t % w] = x
            old = torch.cat([ring[:, o + (t - 2 * d) % w],
                             ring[:, o + (t - d) % w], c[:, t]], 1)
            h = torch.zeros(Rb, G // 2)
            for k in range(cs):
                za, zb = gate_units(old @ wo[k, l].T + bg[k, l]
                                    + x @ wx[k, l].T, gc)
                h[:, k * gc:(k + 1) * gc] = torch.tanh(za) * torch.sigmoid(zb)
            xn = x.clone()
            for k in range(cs):
                so = h @ ws[k, l].T + bs[k, l]
                cols = slice(k * sc, (k + 1) * sc)
                sk = so[:, :sc]
                skips[:, cols] = sk if l == 0 else (
                    (skips[:, cols] + sk) * scale if wn.legacy
                    else skips[:, cols] + sk)
                xv = x[:, k * rc:(k + 1) * rc] + so[:, sc:sc + rc]
                xn[:, k * rc:(k + 1) * rc] = xv * scale \
                    if wn.residual_legacy else xv
            x = xn
        y = torch.relu(torch.relu(skips) @ kw.final1_w + kw.final1_b)
        y_hat = y @ kw.f2w + kw.f2b
        prev = gaussian_sample(y_hat[:, :2], z[:, t], wn.log_scale_min_gauss)
        out[:, t] = prev
    return out[:B]


def _random_sampler_tree(cfg, seed=1):
    """Random WaveNet weights for `cfg`'s Gaussian head, its samples kept
    off the ±1 clip."""
    rng = np.random.default_rng(seed)
    wn = cfg.wavenet
    R, G, S = wn.residual_channels, wn.gate_channels, wn.skip_out_channels
    w = lambda *shape: (rng.normal(size=shape)
                        / np.sqrt(shape[0])).astype(np.float32)
    d = lambda i, o: {"Dense_0": {"kernel": w(i, o), "bias": w(o)}}
    tree = {f"residual_block_{i}": {
        "causal_conv": {"Conv_0": {"kernel": w(3, R, G) / 2, "bias": w(G)}},
        "cin_conv": d(MELS, G), "skip_conv": d(G // 2, S),
        "out_conv": d(G // 2, R)} for i in range(wn.layers)}
    tree.update(input_convolution=d(1, R), final_convolution_1=d(S, S),
                final_convolution_2=d(S, 2))
    head = tree["final_convolution_2"]["Dense_0"]
    head["kernel"] *= 0.1
    head["bias"][:] = (0.0, -3.0)
    return tree


# R, G, S besides the default widths: a CTA's h units and residual columns
# 16 bytes a row (f32, 16 CTAs) or 8; padded m-tiles of units and columns;
# two gate m-tiles a CTA and skip|out m-tiles shared by the chain's warps
WIDTHS = {"default": None, "R64-G128-S64": (64, 128, 64),
          "R32-G64-S32": (32, 64, 32), "R256-G512-S256": (256, 512, 256)}


@pytest.mark.parametrize("widths", list(WIDTHS))
@pytest.mark.parametrize("B", [3, 9])
def test_cluster_data_flow_replays_the_plain_sampler(B, widths):
    """The packed operands through the kernel's data flow (rows padded to
    whole clusters, columns split over the CTAs, h and x gathered by
    owner, m-tiles padded past a CTA's units and columns) give the plain
    sampler's samples, f32, to 1e-5."""
    cfg = torch_cfg()
    if WIDTHS[widths] is None:
        wparams = flax_weights(pin_noise=False)[2]
    else:
        R, G, S = WIDTHS[widths]
        cfg = cfg.replace(wavenet=dataclasses.replace(
            cfg.wavenet, residual_channels=R, gate_channels=G,
            skip_out_channels=S))
        wparams = _random_sampler_tree(cfg)
    sp = extract_sampler_params(wparams, cfg, device="cpu")
    g = torch.Generator().manual_seed(4)
    T_ = 24
    c_up = torch.rand(B, T_, MELS, generator=g)
    z = torch.randn(1, B, T_, generator=g)
    want = wk.sample_plain(sp, cfg, c_up, z)
    got = _cluster_replay(wk.pack_weights(sp, cfg), sp, cfg, c_up, z)
    assert float(want.abs().max()) > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_pack_weights_holds_the_stacked_operands():
    """`pack_weights` lays the sampler kernel's operands out once: the
    stacked per-CTA weights of `stack_weights`, the ring layout, and a
    refusal of weights that do not make the config's head (here MoL
    outputs under the Gaussian config) and of dtypes the kernel does not
    take."""
    _, _, wparams = flax_weights()
    cfg = torch_cfg()
    sp = extract_sampler_params(wparams, cfg, device="cpu")
    kw = wk.pack_weights(sp, cfg, 8)
    for got, want in zip(kw[:3], wk.stack_weights(sp, cfg, 8)):
        assert torch.equal(got, want)
    dil, offs, rows = wk.ring_layout(cfg)
    assert kw.dil.tolist() == list(dil) and kw.offs.tolist() == list(offs)
    assert kw.rows == rows and kw.cs == 8
    assert torch.equal(kw.final1_w, sp.final1_w)
    assert kw.head == "gaussian" and kw.n_out == 2
    assert kw.cache_dtype == kw.weight_dtype == torch.float32
    mol = sp._replace(final2_w=torch.zeros(sp.final2_w.shape[0], 30))
    with pytest.raises(ValueError):
        wk.pack_weights(mol, cfg)
    with pytest.raises(ValueError):
        wk.pack_weights(sp, cfg, weight_dtype=torch.float16)
