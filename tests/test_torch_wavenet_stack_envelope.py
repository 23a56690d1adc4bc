"""The WaveNet training stack's whole envelope on the CPU: the port's
plain stack (ops/wavenet_train_kernel.py, kernels 5a and 5b's plain
versions behind `FusedStack`) with f32 weights and bf16 or f32 saved
activations, at the widths `stack_supported` admits, against the JAX
package; and the CUDA wrappers' padding plan.

The JAX side runs `fused_stack_apply(..., interpret=True)` as
tests/test_wavenet_train_kernel.py does, forward and custom-VJP
gradients, on the same numpy-seeded inputs and flax block weights, dropout
off. Widths: the JAX kernel tests' (R 8, G 16, S 8, cin 10, 4 layers in 2
stacks), an uneven set in 3 layers of 1 stack (R 24, G 48, S 16, cin 12:
no width a multiple of a tile, and JAX's halves split 1 + 2), and the
paper preset's scaling (legacy=False, residual_legacy=False) with weight
norm. Where G != 2R (R 24, G 40) the JAX kernel raises (its
saved-activation slots are R wide), so the port is held to the flax
stack there, the JAX kernel's own oracle. Tolerances, those of
tests/test_torch_wavenet_train_kernel.py: the forward 2e-5 absolute;
gradients with bf16 saved activations rtol 2e-2 / atol 5e-5, with f32
ones rtol 1e-4 / atol 1e-5.

Padding plan: the CUDA wrappers zero-pad R, Ch and S to multiples of 128
and cin to 16. The plain stack on padded operands draws the same dropout
masks bit for bit (the hash counts channels by the true R; by the padded
one every mask would move), leaves every padded column exactly zero, and
agrees with the unpadded stack to 1e-5 of each output's largest value:
not bit for bit, because the CPU's matrix products pick other sum orders
for other shapes (the kernels add the padded zeros after the real terms,
so there the padded and unpadded orders are one).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_wavenet_train_kernel import port_blocks, torch_cfg  # noqa: E402
from test_wavenet_train_kernel import (init_layer_params, ref_stack,  # noqa: E402
                                       tiny_cfg)

from tacotron2_tpu.ops.wavenet_train_kernel import (
    extract_stack_params as jax_extract, fused_stack_apply as jax_apply)
from tacotron2_tpu_torch.config import Config as TorchConfig
from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk

UNEVEN = dict(layers=3, stacks=1, residual_channels=24, gate_channels=48,
              skip_out_channels=16, cin_channels=12)
WIDTHS = {
    "jax-tests": {},
    "uneven-3-layers": UNEVEN,
    "paper-scaling-weight-norm": dict(weight_normalization=True,
                                      legacy=False, residual_legacy=False),
}
TOL = {"bfloat16": dict(rtol=2e-2, atol=5e-5),
       "float32": dict(rtol=1e-4, atol=1e-5)}


def jcfg_of(**kw):
    legacy = {k: kw.pop(k) for k in ("legacy", "residual_legacy")
              if k in kw}
    cfg = tiny_cfg(**kw)
    return cfg.replace(wavenet=dataclasses.replace(cfg.wavenet, **legacy))


def projection(out, proj):
    """A fixed random projection of the skip sum (numpy or torch)."""
    return (out * (torch.as_tensor(proj) if isinstance(out, torch.Tensor)
                   else proj)).sum()


def mse_to(out, tgt):
    """tests/test_wavenet_train_kernel.py's loss against its flax oracle."""
    tgt = torch.as_tensor(tgt) if isinstance(out, torch.Tensor) else tgt
    return ((out - tgt) ** 2).mean()


def compare(jcfg, jax_fn, acts, B=2, T=12, loss=projection):
    """The port's FusedStack (f32 weights, `acts` saved activations)
    against `jax_fn(params, x0, c)`: forward, and gradients of
    `loss(skip sum, a numpy-seeded [B, T, S] array)` wrt every flax leaf,
    x0 and c."""
    assert jcfg.wavenet.compute_dtype == "float32"
    params, x0, c = init_layer_params(jcfg, B=B, T=T)
    proj = np.random.default_rng(5).normal(
        size=(B, T, jcfg.wavenet.skip_out_channels)).astype(np.float32)
    want = jax_fn(params, x0, c)
    gj = jax.grad(lambda p, x, c_: loss(jax_fn(p, x, c_), proj),
                  argnums=(0, 1, 2))(params, x0, c)
    cfg = torch_cfg(jcfg)
    blocks = port_blocks(cfg, params)
    xt = torch.as_tensor(np.array(x0)).requires_grad_(True)
    ct = torch.as_tensor(np.array(c)).requires_grad_(True)
    got = wtk.fused_stack_apply(cfg, wtk.extract_stack_params(blocks, cfg),
                                xt, ct, 3, acts_dtype_name=acts)
    loss(got, proj).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    flat, _ = jax.tree_util.tree_flatten_with_path(gj[0])
    assert len(flat) > 10
    for path, g in flat:
        keys = [k.key for k in path[1:]]
        mod = getattr(blocks[int(path[0].idx)], keys[0])
        np.testing.assert_allclose(getattr(mod, keys[-1]).grad.numpy(),
                                   np.asarray(g), err_msg=str(path),
                                   **TOL[acts])
    for name, a, b in (("x0", xt, gj[1]), ("c", ct, gj[2])):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=name, **TOL[acts])


@pytest.mark.parametrize("acts", ["bfloat16", "float32"])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_f32_stack_matches_jax_kernel(widths, acts):
    jcfg = jcfg_of(**WIDTHS[widths])
    compare(jcfg, lambda p, x, c: jax_apply(
        jcfg, jax_extract(p, jcfg), x, c, 3, Tt=4, acts_dtype_name=acts,
        interpret=True), acts)


@pytest.mark.parametrize("acts", ["bfloat16", "float32"])
def test_gate_width_apart_from_residual_matches_flax(acts):
    """R 24, G 40 (Ch 20 != R), S 16, cin 12, 3 layers in 1 stack: the
    port's stack against the flax stack (the XLA path), forward and
    gradients of the JAX kernel test's loss against that oracle (whose
    tolerances are set for it: bf16 saved activations move each gradient
    by their quantization, relative to the gradient's largest terms); T 10
    is no multiple of any tile."""
    jcfg = jcfg_of(**dict(UNEVEN, gate_channels=40))
    assert jcfg.wavenet.gate_channels // 2 != jcfg.wavenet.residual_channels
    compare(jcfg, lambda p, x, c: ref_stack(jcfg, p, x, c), acts, T=10,
            loss=mse_to)


# ------------------------------------------------------------ padding plan

PAD = {"jax-tests": (8, 16, 8, 10, 4, 2), "uneven": (24, 40, 16, 12, 3, 1),
       "r5": (128, 256, 128, 80, 2, 1)}


def pad_case(name, acts, B=3, T=37, drop=0.1):
    R, G, S, Ci, L, stacks = PAD[name]
    cfg = TorchConfig()
    cfg = cfg.replace(wavenet=dataclasses.replace(
        cfg.wavenet, layers=L, stacks=stacks, residual_channels=R,
        gate_channels=G, skip_out_channels=S, cin_channels=Ci, dropout=drop))
    plan = wtk.make_plan(cfg, B, acts)
    rng = np.random.default_rng(0)
    Ch, N = G // 2, B * T
    shapes = dict(conv_w=(L * 3 * R, G), conv_b=(L, G), cin_w=(L * Ci, G),
                  cin_b=(L, G), skip_w=(L * Ch, S), skip_b=(L, S),
                  out_w=(L * Ch, R), out_b=(L, R))
    t = lambda *s: torch.tensor(rng.normal(size=s) * 0.3, dtype=torch.float32)
    sp = wtk.StackParams(**{k: t(*v) for k, v in shapes.items()})
    return plan, wtk.pad_plan(plan), sp, t(N, R), t(N, Ci), t(N, S)


def close(got, want, rtol, name):
    err = float((got - want).abs().max())
    assert err <= rtol * max(1.0, float(want.abs().max())), (name, err)


@pytest.mark.parametrize("name", ["jax-tests", "uneven"])
def test_padding_keeps_the_dropout_masks(name):
    """The padded plan's masks are the plan's bit for bit on the real
    channels and keep no padded channel; hashing by the padded R instead
    would move them."""
    plan, pp, *_ = pad_case(name, "bfloat16")
    assert (pp.C, pp.Ch, pp.S) == (128, 128, 128) and pp.Ci == 16
    assert pp.hash_C == plan.C
    N = 111
    for layer in range(plan.L):
        real = wtk.stack_keep(plan, 9, layer, N, "cpu")
        padded = wtk.stack_keep(pp, 9, layer, N, "cpu")
        assert padded.shape == (N, pp.C)
        assert torch.equal(padded[:, :plan.C], real)
        assert not padded[:, plan.C:].any()
        wrong = wtk.stack_keep(dataclasses.replace(pp, hash_width=0), 9,
                               layer, N, "cpu")
        assert not torch.equal(wrong[:, :plan.C], real)


@pytest.mark.parametrize("acts", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["jax-tests", "uneven"])
def test_plain_stack_on_padded_operands(name, acts):
    """Kernels 5a and 5b's plain versions on the wrappers' padded operands
    against the unpadded stack, dropout 0.1: every padded output column
    and gradient exactly zero, the rest within 1e-5 of its scale (the
    saved bf16 activations within one bf16 step)."""
    plan, pp, sp, x0, c2, dskip = pad_case(name, acts)
    spp = wtk.pad_params(plan, pp, sp)
    assert torch.equal(wtk.unpad_params(plan, pp, spp)[0], sp[0])
    s, a = wtk.stack_fwd_plain(plan, sp, x0, c2, 5)
    s_p, a_p = wtk.stack_fwd_plain(pp, spp, wtk.pad_cols(x0, pp.C),
                                   wtk.pad_cols(c2, pp.Ci), 5)
    assert not s_p[:, plan.S:].any()
    close(s_p[:, :plan.S], s, 1e-5, "skip")
    a_u = wtk.unpad_acts(plan, pp, a_p)
    assert a_u.shape == a.shape == (plan.L, 3, x0.shape[0], plan.AW)
    assert torch.equal(wtk.pad_acts(pp, a_u)[:, 0], a_p[:, 0])
    close(a_u.float(), a.float(),
          2 ** -7 if acts == "bfloat16" else 1e-5, "acts")
    d, dx, dc = wtk.stack_bwd_plain(plan, sp, a, c2, dskip, 5)
    d_p, dx_p, dc_p = wtk.stack_bwd_plain(
        pp, spp, wtk.pad_acts(pp, a), wtk.pad_cols(c2, pp.Ci),
        wtk.pad_cols(dskip, pp.S), 5)
    d_u = wtk.unpad_params(plan, pp, d_p)
    for f, x, y, full in zip(wtk.StackParams._fields, d_u, d,
                             wtk.pad_params(plan, pp, d_u)):
        assert torch.equal(full, d_p._asdict()[f]), f  # padded part is 0
        close(x, y, 1e-5, f)
    assert not dx_p[:, plan.C:].any() and not dc_p[:, plan.Ci:].any()
    close(dx_p[:, :plan.C], dx, 1e-5, "dx0")
    close(dc_p[:, :plan.Ci], dc, 1e-5, "dc")


def test_default_widths_take_no_padding():
    """At the default (r5) widths the padded plan is the plan's widths and
    the wrappers pass the operands as they are."""
    plan, pp, sp, x0, c2, _ = pad_case("r5", "bfloat16")
    assert (pp.C, pp.G, pp.S, pp.Ci) == (plan.C, plan.G, plan.S, plan.Ci)
    assert wtk.pad_params(plan, pp, sp) is sp
    assert wtk.pad_cols(x0, pp.C) is x0 and wtk.pad_cols(c2, pp.Ci) is c2
    acts = torch.zeros(plan.L, 3, 4, plan.AW)
    assert wtk.unpad_acts(plan, pp, acts) is acts
