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
from torch_port_helpers import MELS, flax_weights, small_cfg, torch_cfg

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


@pytest.mark.parametrize("cs", [1, 8])
def test_stack_weights_layout(cs):
    """The kernel's operands, split over a cluster of `cs` CTAs, compute
    the plain layer's products: CTA c's slice of the gate, skip and
    residual columns reassembles into the full ones."""
    _, _, wparams = flax_weights()
    cfg = torch_cfg()
    sp = extract_sampler_params(wparams, cfg, device="cpu")
    czw, czb, sow, sob, f2w, f2b = wk.stack_weights(sp, cfg, cs)
    wn = cfg.wavenet
    R, G, S = wn.residual_channels, wn.gate_channels, wn.skip_out_channels
    assert czw.shape == (cs, wn.layers, 3 * R + MELS, G // cs)
    assert sow.shape == (cs, wn.layers, G // 2, (S + R) // cs)
    assert f2w.shape == (S, 4) and torch.all(f2w[:, 2:] == 0)
    g = torch.Generator().manual_seed(0)
    v = torch.randn(3 * R + MELS, generator=g)
    hv = torch.randn(G // 2, generator=g)
    for l, lp in enumerate(sp.layers):
        full = v @ torch.cat([lp.conv_w, lp.cin_w], 0) + lp.conv_b + lp.cin_b
        parts = [v @ czw[c, l] + czb[c, l] for c in range(cs)]
        a = torch.cat([p[:G // (2 * cs)] for p in parts])
        b = torch.cat([p[G // (2 * cs):] for p in parts])
        torch.testing.assert_close(torch.cat([a, b]), full)
        so = [hv @ sow[c, l] + sob[c, l] for c in range(cs)]
        torch.testing.assert_close(torch.cat([p[:S // cs] for p in so]),
                                   hv @ lp.skip_w + lp.skip_b)
        torch.testing.assert_close(torch.cat([p[S // cs:] for p in so]),
                                   hv @ lp.out_w + lp.out_b)
    dil, offs, rows = wk.ring_layout(cfg)
    assert list(dil) == list(wn.dilations)
    assert rows == sum(2 * d + 1 for d in wn.dilations)
    assert offs[0] == 0 and offs[1] == 2 * dil[0] + 1


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
    for got, want in zip(kw[:6], wk.stack_weights(sp, cfg, 8)):
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
