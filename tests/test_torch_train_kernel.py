"""The port's teacher-forced train decode — the plain train forward
(kernel 4a's train mode), the plain BPTT backward (kernel 4b) and the
autograd glue `FusedTeacherForced` — against the JAX package's, on the CPU.

Same inputs from numpy seeds, at tests/test_train_kernel.py's small
configuration (B 3, T_in 12, M 64, 5 steps, r 2), the weights handed over
as numpy arrays into the port's `Decoder` module. The JAX side runs
`build_train_fwd` / `make_fused_teacher_forced` in interpret mode, as
tests/test_train_kernel.py runs them, at its tolerances: outputs and
residuals atol 3e-5 (alignments 1e-5), gradients 1e-3 of each tensor's
largest magnitude. Both run f32 weights, dropout and zoneout 0: the TPU
kernels draw their masks from the TPU PRNG, which the port does not
reproduce (it takes the masks from the caller).

The masks themselves are held by the port's backward against autograd
through its own plain forward: dropout 0.5 and zoneout 0.1 from injected
masks, mixed coins, f32 weights, relative 1e-4 (the same function, f32
sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.config import get_config
from tacotron2_tpu.models.tacotron.decoder import Decoder as JaxDecoder
from tacotron2_tpu.ops.tacotron_train_kernel import (
    build_train_fwd, extract_decoder_params_traced, make_fused_teacher_forced)
from tacotron2_tpu_torch.config import get_config as torch_get_config
from tacotron2_tpu_torch.models.tacotron.decoder import (
    Decoder, drop_masks, teacher_forced_replay, teacher_inputs,
    zoneout_masks)
from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
from torch_port_helpers import to_numpy

B, T_IN, M, STEPS = 3, 12, 64, 5
TC = dict(dropout_rate=0.0, zoneout_rate=0.0, decoder_lstm_units=32,
          attention_dim=16, attention_filters=8, attention_kernel=7,
          prenet_layers=(16, 16), outputs_per_step=2,
          fused_train_dtype="float32")
COINS = {"ones": [1] * STEPS, "zeros": [0] * STEPS, "mixed": [1, 0, 1, 1, 0]}
# the gradient tolerance of tests/test_train_kernel.py:test_grad_parity,
# and that of the port's backward against autograd of its own forward
GRAD_RTOL = 1e-3
BWD_RTOL = 1e-4


def _cfgs(**tc):
    over = dict(TC, **tc)
    return [cfg.replace(tacotron=dataclasses.replace(cfg.tacotron, **over),
                        audio=dataclasses.replace(cfg.audio, num_mels=10))
            for cfg in (get_config("default"), torch_get_config("default"))]


@pytest.fixture(scope="module")
def setup():
    cfg, _ = _cfgs()
    rng = np.random.default_rng(0)
    memory = rng.normal(size=(B, T_IN, M)).astype(np.float32)
    mask = np.arange(T_IN)[None, :] < np.asarray([T_IN, 9, 5])[:, None]
    keys = (rng.normal(size=(B, T_IN, cfg.tacotron.attention_dim))
            * 0.3).astype(np.float32)
    r, mels = cfg.tacotron.outputs_per_step, cfg.audio.num_mels
    targets = rng.normal(size=(B, STEPS * r, mels)).astype(np.float32)
    variables = JaxDecoder(config=cfg).init(
        dict(params=jax.random.PRNGKey(0), dropout=jax.random.PRNGKey(1),
             zoneout=jax.random.PRNGKey(2),
             teacher_forcing=jax.random.PRNGKey(3)),
        jnp.asarray(targets), jnp.asarray(keys), jnp.asarray(memory),
        jnp.asarray(mask), 1.0, train=True,
        method=JaxDecoder.teacher_forced)
    return to_numpy(variables["params"]), keys, memory, mask, targets


def _jax_teacher(cfg, targets):
    r, mels = cfg.tacotron.outputs_per_step, cfg.audio.num_mels
    tf = targets[:, r - 1::r]
    return jnp.concatenate([jnp.zeros((B, 1, mels)), tf[:, :-1]],
                           1).transpose(1, 0, 2)


def _port_decoder(cfg_t, params):
    """The port's decoder module with the flax weights (its parameter
    names mirror the flax subtree: "lstm1.kernel" is cell/lstm1/kernel);
    the memory layer (keys are inputs here) stays zero."""
    dec = Decoder(cfg_t, M)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            if name != "attention.memory_layer.kernel":
                leaf = params["cell"]
                for key in name.split("."):
                    leaf = leaf[key]
                p.copy_(torch.from_numpy(np.array(leaf)))
    return dec


def _port_inputs(cfg_t, keys, memory, mask, targets, coins, *, grad=False):
    r = cfg_t.tacotron.outputs_per_step
    t = lambda x: torch.tensor(x, requires_grad=grad)
    return (t(keys), t(memory), torch.as_tensor(mask),
            teacher_inputs(torch.as_tensor(targets), r),
            torch.as_tensor(coins, dtype=torch.int32))


@pytest.mark.parametrize("coins", list(COINS), ids=list(COINS))
def test_train_fwd_matches_tpu_kernel(setup, coins):
    """The plain train forward's outputs and residuals against
    `build_train_fwd(train_zoneout=True)`'s, dropout and zoneout 0."""
    params, keys, memory, mask, targets = setup
    cfg, cfg_t = _cfgs()
    fwd = build_train_fwd(cfg, B, T_IN, STEPS, M, weight_dtype=jnp.float32,
                          interpret=True)
    want = jax.jit(fwd)(
        extract_decoder_params_traced({"decoder": params}, cfg),
        jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask),
        _jax_teacher(cfg, jnp.asarray(targets)),
        jnp.asarray(COINS[coins], jnp.int32), jnp.asarray(3, jnp.int32))
    dec = _port_decoder(cfg_t, params)
    k, m, msk, teacher, co = _port_inputs(cfg_t, keys, memory, mask,
                                          targets, COINS[coins])
    with torch.no_grad():
        dp = tk.cast_params(tk.extract_params_traced(dec, cfg_t),
                            torch.float32)
        *_, res = tk.teacher_forced_train_fwd(
            dp, cfg_t, k, m, msk, teacher, co,
            drop_masks(cfg_t, B, STEPS, device="cpu"),
            zoneout_masks(cfg_t, B, STEPS, device="cpu"))
    assert set(res) == {"out", "align", *tk.RES_NAMES}
    for name in ("out", "align", "cum_pre", "z1", "z2", "h0d", "hpre",
                 "ctx", "h1", "c1", "h2", "c2"):
        got = res[name].numpy()
        w = np.asarray(want[name], np.float32).transpose(1, 0, 2)
        w = w[:, :, :got.shape[-1]]
        atol = 1e-5 if name in ("align", "cum_pre") else 3e-5
        np.testing.assert_allclose(got, w, rtol=0, atol=atol, err_msg=name)
    h2 = np.asarray(want["h2"]).transpose(1, 0, 2)
    np.testing.assert_allclose(
        res["q"].numpy(), h2 @ params["cell"]["attention"]["query_layer"][
            "kernel"], rtol=0, atol=3e-5)


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


@pytest.mark.parametrize("tfr", [1, 0])
def test_fused_grads_match_jax(setup, tfr):
    """`FusedTeacherForced` (the plain pieces, on the CPU) against the
    gradients of `make_fused_teacher_forced`: every decoder parameter by
    its flax name, the keys and the memory."""
    params, keys, memory, mask, targets = setup
    cfg, cfg_t = _cfgs()
    r, mels = cfg.tacotron.outputs_per_step, cfg.audio.num_mels
    rng = np.random.default_rng(1)
    wf = rng.normal(size=(B, STEPS * r, mels)).astype(np.float32)
    ws = rng.normal(size=(B, STEPS * r)).astype(np.float32)
    wa = (rng.normal(size=(B, T_IN, STEPS)) * 0.1).astype(np.float32)
    coins = [tfr] * STEPS
    fused = make_fused_teacher_forced(cfg, B, T_IN, STEPS, M,
                                      weight_dtype=jnp.float32,
                                      interpret=True)

    def loss_jax(p, k, m):
        dp = extract_decoder_params_traced({"decoder": p}, cfg)
        f, s, a = fused(dp, k, m, jnp.asarray(mask),
                        _jax_teacher(cfg, jnp.asarray(targets)),
                        jnp.asarray(coins, jnp.int32),
                        jnp.asarray(3, jnp.int32))
        return jnp.sum(f * wf) + jnp.sum(s * ws) + jnp.sum(a * wa)

    l_jax = float(loss_jax(params, keys, memory))
    g_jax = jax.jit(jax.grad(loss_jax, argnums=(0, 1, 2)))(
        params, jnp.asarray(keys), jnp.asarray(memory))

    dec = _port_decoder(cfg_t, params)
    k, m, msk, teacher, co = _port_inputs(cfg_t, keys, memory, mask,
                                          targets, coins, grad=True)
    dp = tk.extract_params_traced(dec, cfg_t)
    f, s, a = tk.FusedTeacherForced.apply(
        cfg_t, None, k, m, msk, teacher, co,
        drop_masks(cfg_t, B, STEPS, device="cpu"),
        zoneout_masks(cfg_t, B, STEPS, device="cpu"), *dp)
    loss = ((f * torch.as_tensor(wf)).sum() + (s * torch.as_tensor(ws)).sum()
            + (a * torch.as_tensor(wa)).sum())
    assert abs(float(loss.detach()) - l_jax) < 1e-4 * max(abs(l_jax), 1.0)
    loss.backward()
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(g_jax[0]["cell"])[0]}
    n = 0
    for name, param in dec.named_parameters():
        if name == "attention.memory_layer.kernel":
            assert param.grad is None
            continue
        want = flat["".join(f"['{x}']" for x in name.split("."))]
        assert _rel(param.grad.numpy(), want) < GRAD_RTOL, name
        n += 1
    assert n == len(flat) == 18
    assert _rel(k.grad.numpy(), np.asarray(g_jax[1])) < GRAD_RTOL
    assert _rel(m.grad.numpy(), np.asarray(g_jax[2])) < GRAD_RTOL


@pytest.mark.parametrize("coins", ["mixed", "zeros"])
def test_bwd_plain_matches_autograd(setup, coins):
    """`teacher_forced_bwd_plain` + `weight_grads` against autograd through
    the plain train forward, with dropout 0.5 and zoneout 0.1 on injected
    masks: every DecoderParams field, the keys and the memory."""
    params, keys, memory, mask, targets = setup
    _, cfg_t = _cfgs(dropout_rate=0.5, zoneout_rate=0.1)
    g = torch.Generator().manual_seed(5)
    drop = drop_masks(cfg_t, B, STEPS, g, device="cpu")
    zmask = zoneout_masks(cfg_t, B, STEPS, g, device="cpu")
    assert 0 < float(zmask.float().mean()) < 1 and (drop == 0).any()
    dec = _port_decoder(cfg_t, params)
    k, m, msk, teacher, co = _port_inputs(cfg_t, keys, memory, mask,
                                          targets, COINS[coins], grad=True)
    dp = tk.cast_params(tk.extract_params_traced(dec, cfg_t), torch.float32)
    dp = type(dp)(*[x.requires_grad_() for x in dp])
    f, s, a, res = tk.teacher_forced_train_fwd(dp, cfg_t, k, m, msk,
                                               teacher, co, drop, zmask)
    rng = np.random.default_rng(2)
    wf, ws, wa = (torch.as_tensor(rng.normal(size=x.shape).astype(
        np.float32)) for x in (f, s, a))
    loss = (f * wf).sum() + (s * ws).sum() + (a * wa).sum()
    auto = torch.autograd.grad(loss, [*dp, k, m])
    with torch.no_grad():
        res = {n: v.detach() for n, v in res.items()}
        dout = torch.cat([wf.reshape(B, STEPS, -1),
                          ws.reshape(B, STEPS, -1)], -1)
        bwd = tk.teacher_forced_bwd(dp, cfg_t, res, k, m, msk, co, drop,
                                    zmask, dout, wa.transpose(1, 2))
        grads, dkeys, dmem = tk.weight_grads(cfg_t, dp, res, bwd, teacher,
                                             co)
    for name, got, want in zip((*dp._fields, "keys", "memory"),
                               (*grads, dkeys, dmem), auto):
        assert got.shape == want.shape, name
        assert _rel(got.numpy(), want.numpy()) < BWD_RTOL, name


def test_replay_reproduces_the_plain_trajectory(setup):
    """`teacher_forced_replay` of the plain train forward's own residuals
    (mixed coins, dropout and zoneout masks, bf16 weights: every rounding
    the same) gives them back: each step recomputed from the previous
    step's saved state."""
    params, keys, memory, mask, targets = setup
    _, cfg_t = _cfgs(dropout_rate=0.5, zoneout_rate=0.1,
                     fused_train_dtype="bfloat16")
    g = torch.Generator().manual_seed(3)
    drop = drop_masks(cfg_t, B, STEPS, g, device="cpu")
    zmask = zoneout_masks(cfg_t, B, STEPS, g, device="cpu")
    dec = _port_decoder(cfg_t, params)
    k, m, msk, teacher, co = _port_inputs(cfg_t, keys, memory, mask,
                                          targets, COINS["mixed"])
    with torch.no_grad():
        dp = tk.cast_params(tk.extract_params_traced(dec, cfg_t),
                            torch.bfloat16)
        *_, res = tk.teacher_forced_train_fwd(dp, cfg_t, k, m, msk, teacher,
                                              co, drop, zmask)
        rep = teacher_forced_replay(dp, cfg_t, k, m, msk, teacher, co, drop,
                                    zmask, res, chunk=2)
    assert set(rep) == set(res)
    for name, v in res.items():
        np.testing.assert_allclose(rep[name].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
