"""The port's plain teacher-forced decode (the CUDA teacher-forced kernel's
plain version) against the JAX package's, on the CPU.

Same inputs from numpy seeds, at tests/test_train_kernel.py's small
configuration (B 3, T_in 12, M 64, 5 steps, r 2, zoneout 0.1), into (a)
the TPU kernel `build_train_fwd(train_zoneout=False, interpret=True)` and
(b) the flax scan `Decoder.teacher_forced(train=False)`, both as
tests/test_train_kernel.py runs them. Tolerances are that test's own
(:95-99, :165): frames and stop logits atol 3e-5, alignments 1e-5 — f32 on
both sides, another sum order.

bf16 weights: like the TPU kernel, the port then rounds every activation
to bf16 where it enters a product (the memory and the location taps too)
and sums in f32. It is held within BF16_ATOL of the bf16 TPU kernel, and
closer to it than that kernel is to its own f32 version on the same
inputs (the rule the sampler's bf16 variant is held to).

Prenet dropout: in interpret mode the TPU PRNG's bits are all zero, so the
TPU kernel keeps every unit and scales it by 1/keep; the port fed
multipliers of 1/keep gives the same numbers (checked at dropout 0.5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.config import get_config
from tacotron2_tpu.models.tacotron.decoder import Decoder
from tacotron2_tpu.ops.tacotron_train_kernel import (
    build_train_fwd, extract_decoder_params_traced)
from tacotron2_tpu_torch.config import get_config as torch_get_config
from tacotron2_tpu_torch.models.tacotron.decoder import (drop_masks,
                                                         teacher_inputs)
from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
from torch_port_helpers import to_numpy

B, T_IN, M, STEPS = 3, 12, 64, 5
TC = dict(dropout_rate=0.0, zoneout_rate=0.1, decoder_lstm_units=32,
          attention_dim=16, attention_filters=8, attention_kernel=7,
          prenet_layers=(16, 16), outputs_per_step=2,
          fused_train_dtype="float32")
# the port's bf16 version vs the bf16 TPU kernel: measured 8.9e-08 on
# frames and stop logits (3.0e-08 on alignments), where that kernel lies
# 3.6e-03 from its f32 self. Another sum order may move one bf16 rounding
# of an activation by a step (~0.4%), which the bound leaves room for.
BF16_ATOL = 1e-4
COINS = {"ones": [1] * STEPS, "zeros": [0] * STEPS,
         "mixed": [1, 0, 1, 1, 0]}


def _cfgs(**tc):
    over = dict(TC, **tc)
    out = []
    for cfg in (get_config("default"), torch_get_config("default")):
        out.append(cfg.replace(
            tacotron=dataclasses.replace(cfg.tacotron, **over),
            audio=dataclasses.replace(cfg.audio, num_mels=10)))
    return out


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
    dec = Decoder(config=cfg)
    variables = dec.init(
        dict(params=jax.random.PRNGKey(0), dropout=jax.random.PRNGKey(1),
             zoneout=jax.random.PRNGKey(2),
             teacher_forcing=jax.random.PRNGKey(3)),
        jnp.asarray(targets), jnp.asarray(keys), jnp.asarray(memory),
        jnp.asarray(mask), 1.0, train=True, method=Decoder.teacher_forced)
    params = to_numpy(variables["params"])
    return params, keys, memory, mask, targets


def _jax_teacher(cfg, targets):
    r, mels = cfg.tacotron.outputs_per_step, cfg.audio.num_mels
    tf = targets[:, r - 1::r]
    return jnp.concatenate([jnp.zeros((B, 1, mels)), tf[:, :-1]],
                           1).transpose(1, 0, 2)


def _tpu_kernel(cfg, params, keys, memory, mask, targets, coins, wd):
    fwd = build_train_fwd(cfg, B, T_IN, STEPS, M, weight_dtype=wd,
                          train_zoneout=False, interpret=True)
    res = jax.jit(fwd)(
        extract_decoder_params_traced({"decoder": params}, cfg),
        jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask),
        _jax_teacher(cfg, jnp.asarray(targets)),
        jnp.asarray(coins, jnp.int32), jnp.asarray(3, jnp.int32))
    r, mels = cfg.tacotron.outputs_per_step, cfg.audio.num_mels
    out = np.asarray(res["out"])
    frames = out[:, :, :r * mels].transpose(1, 0, 2).reshape(B, -1, mels)
    stops = out[:, :, r * mels:r * mels + r].transpose(1, 0, 2).reshape(B, -1)
    aligns = np.asarray(res["align"])[:, :, :T_IN].transpose(1, 2, 0)
    return frames, stops, aligns


def _port(cfg_t, params, keys, memory, mask, targets, coins, *,
          weight_dtype=torch.float32, drop=None):
    dp = dk.extract_decoder_params({"decoder": params}, cfg_t, device="cpu",
                                   weight_dtype=weight_dtype)
    r = cfg_t.tacotron.outputs_per_step
    if drop is None:
        drop = drop_masks(cfg_t, B, STEPS, device="cpu")
    f, s, a = tk.teacher_forced_fwd(
        dp, cfg_t, torch.as_tensor(keys), torch.as_tensor(memory),
        torch.as_tensor(mask), teacher_inputs(torch.as_tensor(targets), r),
        torch.as_tensor(coins, dtype=torch.int32), drop)
    return f.numpy(), s.numpy(), a.numpy()


def _close(got, want, atol_fs=3e-5, atol_a=1e-5):
    for g, w, atol in zip(got, want, (atol_fs, atol_fs, atol_a)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def test_teacher_inputs_match_jax(setup):
    *_, targets = setup
    cfg, _ = _cfgs()
    got = teacher_inputs(torch.as_tensor(targets), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jax_teacher(cfg, targets)))
    assert got.shape == (STEPS, B, 10) and not got[0].any()


@pytest.mark.parametrize("coins", list(COINS), ids=list(COINS))
def test_plain_matches_tpu_kernel(setup, coins):
    cfg, cfg_t = _cfgs()
    want = _tpu_kernel(cfg, *setup, COINS[coins], jnp.float32)
    got = _port(cfg_t, *setup, COINS[coins])
    _close(got, want)
    # the coins matter: the first step after a 0 coin took the model's own
    # frame, not the teacher's
    if coins != "ones":
        other = _port(cfg_t, *setup, COINS["ones"])
        assert np.abs(other[0] - got[0]).max() > 1e-2


@pytest.mark.parametrize("tfr", [1.0, 0.0])
def test_plain_matches_flax_scan(setup, tfr):
    """Decoder.teacher_forced(train=False): ratio 1 draws every coin 1 and
    ratio 0 every coin 0."""
    params, keys, memory, mask, targets = setup
    cfg, cfg_t = _cfgs()
    f, s, a, _ = Decoder(config=cfg).apply(
        {"params": params}, jnp.asarray(targets), jnp.asarray(keys),
        jnp.asarray(memory), jnp.asarray(mask), tfr, train=False,
        method=Decoder.teacher_forced,
        rngs=dict(dropout=jax.random.PRNGKey(7),
                  zoneout=jax.random.PRNGKey(8),
                  teacher_forcing=jax.random.PRNGKey(9)))
    got = _port(cfg_t, *setup, [int(tfr)] * STEPS)
    _close(got, tuple(np.asarray(x) for x in (f, s, a)))


def test_bf16_weights_within_the_tpu_kernels_own_drift(setup):
    cfg, cfg_t = _cfgs(fused_train_dtype="bfloat16")
    coins = COINS["mixed"]
    want = _tpu_kernel(cfg, *setup, coins, jnp.bfloat16)
    f32 = _tpu_kernel(cfg, *setup, coins, jnp.float32)
    got = _port(cfg_t, *setup, coins,
                weight_dtype=tk.train_weight_dtype(cfg_t))
    err = max(np.abs(g - w).max() for g, w in zip(got[:2], want[:2]))
    drift = max(np.abs(g - w).max() for g, w in zip(f32[:2], want[:2]))
    assert err <= BF16_ATOL, (err, drift)
    assert err < drift, (err, drift)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=BF16_ATOL)


def test_dropout_multipliers_match_interpret_mode(setup):
    """dropout_rate 0.5: the interpret-mode TPU kernel keeps every prenet
    unit and scales it by 1/keep = 2 (its PRNG bits are zero); the port
    given multipliers of 2 gives the same outputs, which differ from the
    outputs without dropout."""
    cfg, cfg_t = _cfgs(dropout_rate=0.5)
    coins = COINS["mixed"]
    want = _tpu_kernel(cfg, *setup, coins, jnp.float32)
    drop = torch.full((B, STEPS, 2, 16), 2.0)
    got = _port(cfg_t, *setup, coins, drop=drop)
    _close(got, want)
    no_drop = _port(_cfgs()[1], *setup, coins)
    assert np.abs(no_drop[0] - got[0]).max() > 1e-2


def test_refuses_what_it_does_not_take(setup):
    params, keys, memory, mask, targets = setup
    _, cfg_t = _cfgs()
    dp = dk.extract_decoder_params({"decoder": params}, cfg_t, device="cpu",
                                   weight_dtype=torch.float32)
    args = (torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask),
            teacher_inputs(torch.as_tensor(targets), 2),
            torch.ones(STEPS, dtype=torch.int32),
            drop_masks(cfg_t, B, STEPS, device="cpu"))
    bad = [cfg_t.replace(gst=dataclasses.replace(cfg_t.gst, emt_attn=True)),
           cfg_t.replace(tacotron=dataclasses.replace(cfg_t.tacotron,
                                                      smoothing=True)),
           cfg_t.replace(tacotron=dataclasses.replace(
               cfg_t.tacotron, prenet_layers=(32, 16)))]
    for cfg_b in bad:
        for fn in (tk.teacher_forced_fwd, tk.teacher_forced_fwd_plain):
            with pytest.raises(ValueError):
                fn(dp, cfg_b, *args)
        with pytest.raises(ValueError):
            tk.extract_params({"decoder": params}, cfg_b, device="cpu")
    # the wrapper on CPU tensors is the plain version
    f1, s1, a1 = tk.teacher_forced_fwd(dp, cfg_t, *args)
    f2, s2, a2 = tk.teacher_forced_fwd_plain(dp, cfg_t, *args)
    assert torch.equal(f1, f2) and torch.equal(s1, s2) and torch.equal(a1, a2)
    assert tk.train_weight_dtype(cfg_t) == torch.float32
    assert tk.extract_params({"decoder": params}, cfg_t,
                             device="cpu").l1_wp.dtype == torch.float32
