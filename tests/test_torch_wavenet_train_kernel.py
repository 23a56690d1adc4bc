"""The port's WaveNet training stack (ops/wavenet_train_kernel.py: the
plain versions of kernels 5a and 5b, `FusedStack`, the dropout hash)
against the JAX package's fused stack, on the CPU.

The JAX side runs `fused_stack_apply(..., interpret=True)`, as
tests/test_wavenet_train_kernel.py does, at its tiny configuration (4
layers, R 8, G 16, S 8, cin 10) with the same flax block weights. The
interpret-mode PRNG draws all-zero bits, so with dropout on every element
of the JAX kernel is kept and scaled by 1/keep (`_uniform_from_bits`: u =
max(1.0 - 1.0, 1e-20) < keep); the all-keep case here gives the port the
same mask. Tolerances: the forward 2e-5 absolute (the JAX test's); the
gradients with bf16 saved activations rtol 2e-2 / atol 5e-5 and with f32
ones rtol 1e-4 / atol 1e-5 (the JAX test's against its flax oracle; here
both sides round the same activations); the plain backward against
autograd of the plain forward with f32 weights and activations and the
same dropout masks, 1e-5 of each gradient's largest value (another sum
order).
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
from test_wavenet_train_kernel import init_layer_params, tiny_cfg  # noqa: E402

from tacotron2_tpu.ops.wavenet_train_kernel import (
    extract_stack_params as jax_extract, fused_stack_apply as jax_apply)
from tacotron2_tpu_torch.config import Config as TorchConfig
from tacotron2_tpu_torch.models.wavenet.modules import ResidualConv1DGLU
from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk

CONVS = ("causal_conv", "cin_conv", "skip_conv", "out_conv")


def torch_cfg(jcfg):
    base = TorchConfig()
    return base.replace(wavenet=dataclasses.replace(
        base.wavenet, **{k: getattr(jcfg.wavenet, k) for k in (
            "layers", "stacks", "residual_channels", "gate_channels",
            "skip_out_channels", "kernel_size", "cin_channels", "dropout",
            "weight_normalization", "legacy", "residual_legacy",
            "compute_dtype")}))


def port_blocks(cfg, layer_params):
    """The port's blocks holding the flax blocks' weights."""
    wn = cfg.wavenet
    blocks = []
    for d, p in zip(wn.dilations, layer_params):
        blk = ResidualConv1DGLU(wn.residual_channels, wn.gate_channels,
                                wn.kernel_size, wn.skip_out_channels, d,
                                wn.cin_channels, wn.use_bias,
                                wn.residual_legacy, wn.weight_normalization)
        for name in CONVS:
            mod, sub = getattr(blk, name), p[name]
            sub = sub.get("Conv_0", sub.get("Dense_0", sub))
            for leaf, value in sub.items():
                with torch.no_grad():
                    getattr(mod, leaf).copy_(torch.as_tensor(np.array(value)))
        blocks.append(blk)
    return blocks


def port_apply(cfg, blocks, x0, c, seed=3, acts="bfloat16"):
    sp = wtk.extract_stack_params(blocks, cfg)
    return wtk.fused_stack_apply(cfg, sp, torch.as_tensor(np.array(x0)),
                                 torch.as_tensor(np.array(c)), seed,
                                 acts_dtype_name=acts)


@pytest.mark.parametrize("T,Tt,weight_norm", [(12, 4, False), (10, 4, False),
                                              (8, 4, True)],
                         ids=["T12-Tt4", "ragged-T10", "weight-norm"])
def test_plain_forward_matches_jax_kernel(T, Tt, weight_norm):
    jcfg = tiny_cfg(weight_normalization=weight_norm)
    params, x0, c = init_layer_params(jcfg, B=2, T=T)
    want = jax_apply(jcfg, jax_extract(params, jcfg), x0, c, 3, Tt=Tt,
                     interpret=True)
    cfg = torch_cfg(jcfg)
    got = port_apply(cfg, port_blocks(cfg, params), x0, c)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)


def _grads_both(jcfg, B, T, loss, acts="bfloat16"):
    """d loss / d (flax block params, x0, c) of the JAX custom VJP and of
    the port's FusedStack, each as a flat list in the flax tree's order."""
    params, x0, c = init_layer_params(jcfg, B=B, T=T)

    def jax_loss(params, x0, c):
        out = jax_apply(jcfg, jax_extract(params, jcfg), x0, c, 3, Tt=4,
                        acts_dtype_name=acts, interpret=True)
        return loss(out)

    gj = jax.grad(jax_loss, argnums=(0, 1, 2))(params, x0, c)
    flat_j, _ = jax.tree_util.tree_flatten_with_path(gj[0])
    cfg = torch_cfg(jcfg)
    blocks = port_blocks(cfg, params)
    xt = torch.as_tensor(np.array(x0)).requires_grad_(True)
    ct = torch.as_tensor(np.array(c)).requires_grad_(True)
    out = wtk.fused_stack_apply(cfg, wtk.extract_stack_params(blocks, cfg),
                                xt, ct, 3, acts_dtype_name=acts)
    loss(out).backward()
    got, want = [], []
    for path, g in flat_j:
        i = int(path[0].idx)
        keys = [k.key for k in path[1:]]
        mod = getattr(blocks[i], keys[0])
        got.append(getattr(mod, keys[-1]).grad.numpy())
        want.append(np.asarray(g))
    return got + [xt.grad.numpy(), ct.grad.numpy()], \
        want + [np.asarray(gj[1]), np.asarray(gj[2])]


@pytest.mark.parametrize("case", ["bf16-acts", "f32-acts-weight-norm"])
def test_gradients_match_jax_custom_vjp(case):
    if case == "bf16-acts":
        jcfg = tiny_cfg()
        tgt = np.random.default_rng(7).normal(
            size=(2, 12, jcfg.wavenet.skip_out_channels)).astype(np.float32)
        loss = lambda out: ((out - (torch.as_tensor(tgt) if isinstance(
            out, torch.Tensor) else jnp.asarray(tgt))) ** 2).mean()
        got, want = _grads_both(jcfg, 2, 12, loss)
        tol = dict(rtol=2e-2, atol=5e-5)
    else:
        jcfg = tiny_cfg(weight_normalization=True)
        jcfg = jcfg.replace(wavenet=dataclasses.replace(
            jcfg.wavenet, legacy=False, residual_legacy=False))
        got, want = _grads_both(jcfg, 1, 8, lambda out: (out ** 2).sum(),
                                acts="float32")
        tol = dict(rtol=1e-4, atol=1e-5)
    assert len(got) == len(want) > 10
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, err_msg=str(i), **tol)


def test_all_keep_dropout_matches_jax_kernel(monkeypatch):
    """Dropout 0.05 with every element kept: the JAX kernel in interpret
    mode (zero PRNG bits) and the port with an all-keep mask agree in the
    forward and the gradients, and both differ from dropout 0 (the
    1/keep scaling is applied)."""
    jcfg = tiny_cfg(dropout=0.05)
    params, x0, c = init_layer_params(jcfg, B=2, T=12)
    monkeypatch.setattr(wtk, "keep_bits", lambda key, row0, rows, C, keep,
                        device="cpu": torch.ones(rows, C, dtype=torch.bool))
    want = jax_apply(jcfg, jax_extract(params, jcfg), x0, c, 3, Tt=4,
                     interpret=True)
    cfg = torch_cfg(jcfg)
    got = port_apply(cfg, port_blocks(cfg, params), x0, c)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    no_drop = jax_apply(tiny_cfg(), jax_extract(params, jcfg), x0, c, 3,
                        Tt=4, interpret=True)
    assert np.abs(np.asarray(no_drop) - np.asarray(want)).max() > 1e-3
    got_g, want_g = _grads_both(jcfg, 2, 12, lambda out: (out ** 2).sum())
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=5e-5, err_msg=str(i))


@pytest.mark.parametrize("weight_bf16", [False, True],
                         ids=["f32-weights", "bf16-weights"])
def test_plain_backward_matches_autograd(weight_bf16):
    """stack_bwd_plain against autograd of stack_fwd_plain, dropout 0.1
    with the same masks (one seed). With bf16 weights autograd also rounds
    the weight gradients (the cast's backward, 2^-9 of each value) and dh,
    which the kernel keeps f32, and a rounded dh moves every gradient
    below it by as much again: there the tolerance is 2^-7 of each
    gradient's largest value."""
    cfg = TorchConfig()
    cfg = cfg.replace(wavenet=dataclasses.replace(
        cfg.wavenet, layers=4, stacks=2, residual_channels=8,
        gate_channels=16, skip_out_channels=8, cin_channels=10, dropout=0.1,
        compute_dtype="bfloat16" if weight_bf16 else "float32"))
    rng = np.random.default_rng(1)
    B, T = 3, 11
    plan = wtk.make_plan(cfg, B, "float32")
    L, C, G, S, Ci, Ch = 4, 8, 16, 8, 10, 8
    shapes = dict(conv_w=(L * 3 * C, G), conv_b=(L, G), cin_w=(L * Ci, G),
                  cin_b=(L, G), skip_w=(L * Ch, S), skip_b=(L, S),
                  out_w=(L * Ch, C), out_b=(L, C))
    sp = wtk.StackParams(**{k: torch.tensor(rng.normal(size=v) * 0.3,
                                            dtype=torch.float32)
                            for k, v in shapes.items()})
    x0 = torch.tensor(rng.normal(size=(T * B, C)) * 0.5, dtype=torch.float32)
    c2 = torch.tensor(rng.normal(size=(T * B, Ci)) * 0.5, dtype=torch.float32)
    dskip = torch.tensor(rng.normal(size=(T * B, S)), dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (*sp, x0, c2)]
    skip, acts = wtk.stack_fwd_plain(plan, wtk.StackParams(*leaves[:8]),
                                     leaves[8], leaves[9], seed=11)
    want = torch.autograd.grad((skip * dskip).sum(), leaves)
    d_sp, dx0, dc2 = wtk.stack_bwd_plain(plan, sp, acts.detach(), c2, dskip,
                                         seed=11)
    rtol = 2 ** -7 if weight_bf16 else 1e-5
    for name, a, b in zip(list(wtk.StackParams._fields) + ["x0", "c2"],
                          [*d_sp, dx0, dc2], want):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= rtol, (name, err)


def test_mask_keep_share():
    """10^6 draws at keep 0.95: the kept share within 0.002."""
    kept = wtk.keep_bits(wtk.layer_key(1234, 7), 0, 1_000_000 // 125, 125,
                         0.95)
    assert kept.numel() == 1_000_000
    assert abs(float(kept.float().mean()) - 0.95) < 0.002


def test_mask_differs_across_layers_and_seeds():
    masks = {(s, l): wtk.keep_bits(wtk.layer_key(s, l), 0, 64, 128, 0.95)
             for s in (0, 1, 2 ** 31 - 2) for l in range(3)}
    keys = list(masks)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            assert not torch.equal(masks[a], masks[b]), (a, b)
    assert len({wtk.layer_key(s, l) for s, l in keys}) == len(keys)


@pytest.mark.parametrize("tile", [1, 7, 128])
def test_mask_bits_do_not_depend_on_the_tile(tile):
    """The rows of a mask drawn in tiles of any size are the rows of the
    mask drawn at once; the uint32 hash in int64 tensor ops equals the
    same hash on python ints."""
    key, N, C = wtk.layer_key(99, 5), 300, 128
    whole = wtk.keep_bits(key, 0, N, C, 0.95)
    tiles = torch.cat([wtk.keep_bits(key, r, min(tile, N - r), C, 0.95)
                       for r in range(0, N, tile)])
    assert torch.equal(whole, tiles)
    for row, ch in ((0, 0), (17, 101), (299, 127)):
        v = wtk._fmix32(((row * C + ch) & wtk.M32) ^ key)
        v = wtk._fmix32((v + key) & wtk.M32)
        assert bool(whole[row, ch]) == ((v >> 8) < wtk.keep_threshold(0.95))


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernels take bf16 or f32 weights and saved activations at every
    width `stack_supported` admits, and [N, width] operands of one N =
    T·B; a config `stack_supported` refuses, weights of more than one
    type and malformed operands raise before a launch."""
    cfg = TorchConfig()
    x = torch.zeros(4, 128)
    sp = lambda dt: wtk.StackParams(*(torch.zeros(2, 2, dtype=dt)
                                      for _ in wtk.StackParams._fields))
    wn = lambda c, **kw: c.replace(wavenet=dataclasses.replace(c.wavenet,
                                                               **kw))
    # f32 weights (the default) with bf16 or f32 activations, bf16 weights
    for c, acts in ((cfg, "bfloat16"), (cfg, "float32"),
                    (wn(cfg, compute_dtype="bfloat16"), "bfloat16"),
                    (wn(cfg, compute_dtype="bfloat16"), "float32")):
        plan = wtk.make_plan(c, 2, acts)
        wtk._check_cuda(plan, x, torch.zeros(4, 80), widths=(128, 80),
                        weights=sp(torch.float32))
    # other widths: narrow, uneven (Ch != R), wide
    for R, G, S, Ci in ((64, 128, 64, 80), (24, 40, 16, 12),
                        (256, 512, 256, 80)):
        plan = wtk.make_plan(wn(cfg, residual_channels=R, gate_channels=G,
                                skip_out_channels=S, cin_channels=Ci), 2)
        wtk._check_cuda(plan, torch.zeros(4, R), torch.zeros(4, Ci),
                        widths=(R, Ci), weights=sp(torch.bfloat16))
    plan = wtk.make_plan(cfg, 2)
    mixed = sp(torch.float32)._replace(skip_w=torch.zeros(2, 2,
                                                          dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="one floating type"):
        wtk._check_cuda(plan, x, weights=mixed)
    for bad in (dict(kernel_size=2), dict(gin_channels=16),
                dict(gate_channels=255), dict(layers=1, stacks=1),
                dict(cin_channels=0)):
        assert not wtk.stack_supported(wn(cfg, **bad)), bad
        with pytest.raises(ValueError, match="stack_supported"):
            wtk._check_cuda(wtk.make_plan(wn(cfg, **bad), 2), x)
    wtk._check_cuda(plan, x, torch.zeros(4, 80), widths=(128, 80))
    with pytest.raises(ValueError, match=r"\[N, 80\]"):
        wtk._check_cuda(plan, x, torch.zeros(4, 10), widths=(128, 80))
    with pytest.raises(ValueError, match="contiguous f32"):
        wtk._check_cuda(plan, x.to(torch.bfloat16), widths=(128,))
    with pytest.raises(ValueError, match="T·B"):
        wtk._check_cuda(wtk.make_plan(cfg, 3), x, widths=(128,))
