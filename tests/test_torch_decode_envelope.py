"""The whole envelope of the port's Tacotron decode kernels against the JAX
package's, on the CPU: bf16 decode weights rounded where the TPU kernels
round them, smoothing attention, f32 decode and train weights, and the
refusals that remain.

Same inputs from numpy seeds and the same flax weights into both packages
(tests/torch_port_helpers.py's small widths, dropout 0); the JAX side runs
its Pallas kernels in interpret mode, its flax scan, its synthesizer and
its trainer as its own tests run them, the port its kernels' plain
versions. Tolerances:

- bf16 against the TPU kernels at `weight_dtype=bfloat16`: both round the
  same values to bf16 at the same points and sum in f32 in another order,
  so frames, stop probabilities and every carried state field agree to
  BF16_ATOL = 1e-6 (read: 2.4e-7 on frames, 3.0e-8 on stops through the
  whole decode; <= 2.4e-7 on every field block by block; the unrounded
  decode lay 4.9e-3 / 9.1e-4 away). The TPU kernels store alignments in
  bf16: those are held to tests/test_torch_decoder.py's 8e-3.
- f32 (smoothing, f32 weights) against the TPU kernels and the flax scan:
  tests/test_torch_decoder.py's frames 2e-4, stops 2e-5, states 2e-4,
  alignments 1e-4 against the scan (f32 there); the teacher-forced decode
  tests/test_torch_teacher_forced.py's 3e-5 (alignments 1e-5); synthesis
  tests/test_torch_synth.py's mels atol 2e-4 / rtol 1e-3, stops 2e-5,
  alignments 1e-4; GTA tests/test_torch_gta.py's stop logits 2e-4; train
  steps tests/test_torch_train_step.py's loss terms 1e-5 relative (1e-6
  absolute) and grad_norm 1e-4 relative. Parameters after the steps:
  STEP_PARAM_ATOL = 3e-5, 3% of one Adam step's move (learning rate 1e-3).
  tests/test_torch_train_step.py's default run reads 9.0e-6 against its
  1e-5: the largest differences sit in elements whose gradient is near
  Adam's eps (the reference encoders' conv biases feed BatchNorm, which
  cancels them), where an f32 sum order moves the update by a share of a
  step. Read here: 1.9e-5 after the f32 fused step (one of 3,072 encoder
  conv weights), 1.1e-5 after the smoothing steps (a reference-encoder conv
  bias); every other tensor within 7e-6.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.tacotron.decoder import Decoder
from tacotron2_tpu.ops.tacotron_decoder_kernel import (
    build_decoder_block_kernel, build_decoder_kernel, extract_decoder_params,
    init_decoder_state)
from tacotron2_tpu.synth import tacotron_synth as jts
from tacotron2_tpu.synth.pipeline import TextToWavProgram as JaxProgram
from tacotron2_tpu_torch.models.tacotron import decoder as tdec
from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
from tacotron2_tpu_torch.synth import tacotron_synth as tts
from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
from torch_port_helpers import (STEPS, T_IN, T_REF, flax_weights, inputs,
                                small_cfg, to_numpy, torch_cfg)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_synth import _cfg as synth_cfg  # noqa: E402
from test_torch_train_step import TERMS  # noqa: E402
from test_torch_train_step import _close as close_rel  # noqa: E402
from test_torch_train_step import (_to_np, batch4, cfgs,  # noqa: E402
                                   port_model)

BF16_ATOL = 1e-6
STEP_PARAM_ATOL = 3e-5
B, T1, M, STEPS1 = 4, 20, 48, 6


def _tc(cfg, **tc):
    return cfg.replace(tacotron=dataclasses.replace(cfg.tacotron, **tc))


def _both(**tc):
    """(JAX config, port config) at the small widths with `tc` applied
    (the JAX kernels take their weight dtype as an argument)."""
    return _tc(small_cfg(), **tc), _tc(torch_cfg(), **tc)


def _flax_decoder(seed, Bn, steps, keys, memory, mask, cfg=None):
    dec = Decoder(config=cfg or small_cfg())
    return to_numpy(dec.init(
        dict(params=jax.random.PRNGKey(seed), dropout=jax.random.PRNGKey(1),
             zoneout=jax.random.PRNGKey(2)),
        Bn, steps, jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask),
        method=Decoder.autoregressive)["params"])


@pytest.fixture(scope="module")
def whole():
    """tests/test_torch_decoder.py's whole-decode set-up."""
    rng = np.random.default_rng(0)
    memory = rng.normal(size=(B, T1, M)).astype(np.float32)
    mask = np.arange(T1)[None, :] < np.asarray([T1, T1 - 3, T1 - 7,
                                                5])[:, None]
    keys = (rng.normal(size=(B, T1, 16)) * 0.3).astype(np.float32)
    return _flax_decoder(0, B, STEPS1, keys, memory, mask), keys, memory, mask


def _block_setup(t_in):
    """tests/test_torch_decoder.py's block set-up: B 2, M 24, 3 steps."""
    rng = np.random.default_rng(1)
    memory = (rng.normal(size=(2, t_in, 24)) * 0.5).astype(np.float32)
    mask = np.arange(t_in)[None, :] < np.asarray([t_in, t_in - 9])[:, None]
    keys = (rng.normal(size=(2, t_in, 16)) * 0.3).astype(np.float32)
    return _flax_decoder(3, 2, 3, keys, memory, mask), keys, memory, mask


def _whole_vs_kernel(params, keys, memory, mask, cfg, cfg_t, wd, steps=STEPS1):
    run = build_decoder_kernel(cfg, B, T1, steps, M, weight_dtype=wd,
                               interpret=True)
    want = run(extract_decoder_params({"decoder": params}, cfg),
               jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask), 3)
    dp = dk.extract_decoder_params({"decoder": params}, cfg_t, device="cpu")
    got = dk.decode(dp, cfg_t, torch.as_tensor(keys), torch.as_tensor(memory),
                    torch.as_tensor(mask),
                    tdec.drop_masks(cfg_t, B, steps, device="cpu"),
                    steps=steps)
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


# the plain block decode's casts at each energy_mode of the TPU block kernel
# without emt_attn (None: its default, "vmat")
MODE_CASTS = {None: tdec.BLOCK, "vpu": tdec.Casts(True, True, False)}


def _blocks_vs_kernel(t_in, cfg, cfg_t, wd, energy_mode=None, atol=BF16_ATOL,
                      atol_s=BF16_ATOL):
    """Two chained 3-step blocks of the plain block decode against the TPU
    block kernel: outputs and every carried state field."""
    params, keys, memory, mask = _block_setup(t_in)
    run = build_decoder_block_kernel(cfg, 2, t_in, 3, 24, weight_dtype=wd,
                                     energy_mode=energy_mode, interpret=True)
    dp_j = extract_decoder_params({"decoder": params}, cfg)
    st_j = init_decoder_state(cfg, 2, t_in, 24)
    dp_t = dk.extract_decoder_params({"decoder": params}, cfg_t,
                                     device="cpu")
    st_t = dk.init_decoder_state(cfg_t, 2, t_in, 24, device="cpu")
    drop = tdec.drop_masks(cfg_t, 2, 3, device="cpu")
    mels = cfg.audio.num_mels
    for blk in range(2):
        f_j, s_j, a_j, st_j = run(dp_j, jnp.asarray(keys),
                                  jnp.asarray(memory), jnp.asarray(mask),
                                  st_j, 3 + blk)
        f_t, s_t, a_t, st_t = dk.decode_block_plain(
            dp_t, cfg_t, torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask), st_t, drop,
            casts=MODE_CASTS[energy_mode])
        np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=0, atol=atol)
        np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=atol_s)
        np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=0, atol=8e-3)
        want = dict(xprev=np.asarray(st_j.xprev)[:, :mels], c1=st_j.c1,
                    h1=st_j.h1, c2=st_j.c2, h2=st_j.h2, ctx=st_j.ctx,
                    cum=np.asarray(st_j.cum)[:, :t_in])
        for name, w in want.items():
            np.testing.assert_allclose(getattr(st_t, name), np.asarray(w),
                                       rtol=0, atol=atol, err_msg=name)
        np.testing.assert_array_equal(st_t.pmax, np.asarray(st_j.pmax)[:, 0])
    return st_t


# ------------------------------------------------------ the rounding repair


@pytest.mark.parametrize("constraint", ["window", "monotonic"])
def test_bf16_decode_matches_tpu_kernel(whole, constraint):
    """The plain whole decode with bf16 weights against
    `build_decoder_kernel(weight_dtype=bfloat16)`: every product input, the
    memory, the location taps and the keys rounded, v_a and the tanh f32."""
    cfg, cfg_t = _both(synthesis_constraint_type=constraint,
                       fused_decoder_dtype="bfloat16")
    (f, s, a), (f_j, s_j, a_j) = _whole_vs_kernel(*whole, cfg, cfg_t,
                                                  jnp.bfloat16)
    np.testing.assert_allclose(f, f_j, rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(s, s_j, rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(a, a_j, rtol=0, atol=8e-3)
    # the repair's size: without the roundings the decode lies far off
    _, cfg32 = _both(synthesis_constraint_type=constraint)
    dp = dk.extract_decoder_params({"decoder": whole[0]}, cfg_t, device="cpu")
    params, keys, memory, mask = whole
    f_u, _, _ = dk.decode(dp._replace(**{
        k: v.float() for k, v in dp._asdict().items()}), cfg32,
        torch.as_tensor(keys), torch.as_tensor(memory), torch.as_tensor(mask),
        tdec.drop_masks(cfg_t, B, STEPS1, device="cpu"), steps=STEPS1)
    assert np.abs(f_u.numpy() - f_j).max() > 1e-3


@pytest.mark.parametrize("energy_mode", [None, "vpu"], ids=["vmat", "vpu"])
@pytest.mark.parametrize("t_in", [T1, 300])
def test_bf16_blocks_match_tpu_block_kernel(t_in, energy_mode):
    """The plain block decode with bf16 weights against
    `build_decoder_block_kernel(weight_dtype=bfloat16)` at its default
    energy_mode ("vmat": v_a and the tanh rounded too) and at "vpu" (v_a
    rounded), block by block with every state field, also past the
    monolithic kernel's 256 padded characters."""
    cfg, cfg_t = _both(fused_decoder_dtype="bfloat16")
    _blocks_vs_kernel(t_in, cfg, cfg_t, jnp.bfloat16, energy_mode)


def _emt_case(kind):
    """tests/test_torch_emt_attn.py's decode set-up for `kind` (simple at
    reference_depth 128 with ref_spk, multihead at 8 with ref_spk)."""
    depth = 128 if kind == "simple" else 8
    gst = dict(emt_attn=True, emt_attn_type=kind, reference_depth=depth)
    cfg = small_cfg()
    cfg = cfg.replace(gst=dataclasses.replace(cfg.gst, **gst))
    cfg_t = _tc(torch_cfg(), fused_decoder_dtype="bfloat16")
    cfg_t = cfg_t.replace(gst=dataclasses.replace(cfg_t.gst, **gst))
    rng = np.random.default_rng(5)
    f = lambda *s, sc=0.4: (rng.normal(size=s) * sc).astype(np.float32)
    memory, keys = f(2, 20, 32), f(2, 20, 16, sc=0.3)
    mask = np.arange(20)[None, :] < np.asarray([20, 15])[:, None]
    emt_memory, ref_spk = f(2, 3, 2 * depth), f(2, 128)
    params = to_numpy(Decoder(config=cfg).init(
        dict(params=jax.random.PRNGKey(3), dropout=jax.random.PRNGKey(1),
             zoneout=jax.random.PRNGKey(2)),
        2, 6, jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask),
        emt_memory=jnp.asarray(emt_memory), ref_spk=jnp.asarray(ref_spk),
        method=Decoder.autoregressive)["params"])
    return cfg, cfg_t, params, keys, memory, mask, emt_memory, ref_spk


@pytest.mark.parametrize("kind", ["simple", "multihead"])
def test_bf16_emt_blocks_match_tpu_block_kernel(kind):
    """Under emt_attn the block kernel's emt scorers in bf16 ("vpu"): the
    emt query's input, keys, memory, alignment and multihead's joined
    contexts rounded too, every state field (context_emt too)."""
    (cfg, cfg_t, params, keys, memory, mask, emt_memory,
     ref_spk) = _emt_case(kind)
    run = build_decoder_block_kernel(cfg, 2, 20, 3, 32,
                                     weight_dtype=jnp.bfloat16, emt_T=3,
                                     interpret=True)
    dp_j = extract_decoder_params({"decoder": params}, cfg)
    st_j = init_decoder_state(cfg, 2, 20, 32)
    tree = {"decoder": params}
    dp = dk.extract_decoder_params(tree, cfg_t, device="cpu")
    ep = dk.extract_emt_params(tree, cfg_t, device="cpu")
    # multihead's ref_spk addend reads LSTM1's emt rows in f32, as the TPU
    # kernel does; the step loop's copy is bf16
    assert dp.l1_wp.dtype == torch.bfloat16 and ep.l1_we.dtype == torch.float32
    emt = tdec.emt_operands(ep, cfg_t, torch.as_tensor(emt_memory),
                            torch.as_tensor(ref_spk))
    assert emt.l1_we.dtype == emt.wq.dtype == torch.bfloat16
    st_t = dk.init_decoder_state(cfg_t, 2, 20, 32, device="cpu")
    drop = tdec.drop_masks(cfg_t, 2, 3, device="cpu")
    for blk in range(2):
        f_j, s_j, a_j, st_j = run(
            dp_j, jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask),
            st_j, 3 + blk, jnp.asarray(emt_memory), jnp.asarray(ref_spk))
        f_t, s_t, a_t, st_t = dk.decode_block_plain(
            dp, cfg_t, torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask), st_t, drop, emt)
        np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=0,
                                   atol=BF16_ATOL)
        np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0,
                                   atol=BF16_ATOL)
        np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=0, atol=8e-3)
        for key in ("c1", "h1", "c2", "h2", "ctx", "ctx_emt"):
            np.testing.assert_allclose(getattr(st_t, key),
                                       np.asarray(getattr(st_j, key)),
                                       rtol=0, atol=BF16_ATOL, err_msg=key)
    assert float(st_t.ctx_emt.abs().max()) > 1e-2


def test_casts_per_route(whole):
    """What each route rounds with bf16 weights, as its TPU kernel does;
    blocks with the whole decode's casts chain into the whole decode."""
    assert tdec.WHOLE == tdec.Casts(keys=True, v_a=False, tanh=False)
    assert tdec.TEACHER_FORCED == tdec.Casts(False, False, False)
    assert tdec.BLOCK == tdec.Casts(True, True, True)
    assert tdec.BLOCK_EMT == tdec.Casts(True, True, False)
    params, keys, memory, mask = whole
    _, cfg_t = _both(fused_decoder_dtype="bfloat16")
    dp = dk.extract_decoder_params({"decoder": params}, cfg_t, device="cpu")
    args = (torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask))
    drop = tdec.drop_masks(cfg_t, B, 4, device="cpu")
    f, _, _ = dk.decode(dp, cfg_t, *args, drop, steps=4)
    st = dk.init_decoder_state(cfg_t, B, T1, M, device="cpu")
    frames = []
    for t in range(4):
        f_t, _, _, st = dk.decode_block(dp, cfg_t, *args, st,
                                        drop[:, t:t + 1], casts=tdec.WHOLE)
        frames.append(f_t)
    assert torch.equal(torch.cat(frames, 1), f)
    f_b, _, _, _ = dk.decode_block(dp, cfg_t, *args, dk.init_decoder_state(
        cfg_t, B, T1, M, device="cpu"), drop)
    assert not torch.equal(f_b, f)          # the block route rounds more


# ---------------------------------------------------------------- smoothing


@pytest.mark.parametrize("wd", ["float32", "bfloat16"])
def test_smoothing_decode_matches_tpu_kernel(whole, wd):
    """`build_decoder_kernel` with smoothing (the sigmoids normalised over
    the masked, windowed positions, :1012-1014): f32 weights at the f32
    tolerances, bf16 ones at BF16_ATOL."""
    cfg, cfg_t = _both(smoothing=True, fused_decoder_dtype=wd)
    (f, s, a), (f_j, s_j, a_j) = _whole_vs_kernel(
        *whole, cfg, cfg_t, jnp.float32 if wd == "float32" else jnp.bfloat16)
    atol_f, atol_s = (2e-4, 2e-5) if wd == "float32" else (BF16_ATOL,) * 2
    np.testing.assert_allclose(f, f_j, rtol=0, atol=atol_f)
    np.testing.assert_allclose(s, s_j, rtol=0, atol=atol_s)
    np.testing.assert_allclose(a, a_j, rtol=0, atol=8e-3)
    # smoothing is not the softmax: the alignments differ
    params, keys, memory, mask = whole
    _, cfg_soft = _both(fused_decoder_dtype=wd)
    dp = dk.extract_decoder_params({"decoder": params}, cfg_soft,
                                   device="cpu")
    _, _, a_soft = dk.decode(dp, cfg_soft, torch.as_tensor(keys),
                             torch.as_tensor(memory), torch.as_tensor(mask),
                             tdec.drop_masks(cfg_t, B, 2, device="cpu"),
                             steps=2)
    assert np.abs(a[..., :2] - a_soft.numpy()).max() > 1e-2


@pytest.mark.parametrize("t_in", [T1, 300])
def test_smoothing_blocks_match_tpu_block_kernel(t_in):
    cfg, cfg_t = _both(smoothing=True)
    _blocks_vs_kernel(t_in, cfg, cfg_t, jnp.float32, atol=2e-4, atol_s=2e-5)


def test_smoothing_decode_matches_flax_scan(whole):
    params, keys, memory, mask = whole
    cfg, cfg_t = _both(smoothing=True)
    f_j, s_j, a_j, _ = Decoder(config=cfg).apply(
        {"params": params}, B, STEPS1, jnp.asarray(keys),
        jnp.asarray(memory), jnp.asarray(mask), method=Decoder.autoregressive,
        rngs=dict(dropout=jax.random.PRNGKey(7),
                  zoneout=jax.random.PRNGKey(8)))
    dp = dk.extract_decoder_params({"decoder": params}, cfg_t, device="cpu")
    f, s, a = dk.decode(dp, cfg_t, torch.as_tensor(keys),
                        torch.as_tensor(memory), torch.as_tensor(mask),
                        tdec.drop_masks(cfg_t, B, STEPS1, device="cpu"),
                        steps=STEPS1)
    np.testing.assert_allclose(f, np.asarray(f_j), rtol=0, atol=2e-4)
    np.testing.assert_allclose(s, np.asarray(s_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(a, np.asarray(a_j), rtol=0, atol=1e-4)


@pytest.mark.parametrize("tfr", [1.0, 0.0])
def test_smoothing_teacher_forced_matches_flax_scan(whole, tfr):
    """The plain teacher-forced decode under smoothing (the route JAX scans)
    against flax `Decoder.teacher_forced(train=False)`."""
    params, keys, memory, mask = whole
    cfg, cfg_t = _both(smoothing=True)
    r, mels = cfg.tacotron.outputs_per_step, cfg.audio.num_mels
    targets = np.random.default_rng(2).normal(
        size=(B, STEPS1 * r, mels)).astype(np.float32)
    f_j, s_j, a_j, _ = Decoder(config=cfg).apply(
        {"params": params}, jnp.asarray(targets), jnp.asarray(keys),
        jnp.asarray(memory), jnp.asarray(mask), tfr, train=False,
        method=Decoder.teacher_forced,
        rngs=dict(dropout=jax.random.PRNGKey(7),
                  zoneout=jax.random.PRNGKey(8),
                  teacher_forcing=jax.random.PRNGKey(9)))
    dp = dk.extract_decoder_params({"decoder": params}, cfg_t, device="cpu")
    assert tdec.teacher_forced_route(cfg_t) == "plain"
    f, s, a = tdec.teacher_forced(
        dp, cfg_t, torch.as_tensor(keys), torch.as_tensor(memory),
        torch.as_tensor(mask), tdec.teacher_inputs(torch.as_tensor(targets),
                                                   r),
        torch.full((STEPS1,), int(tfr), dtype=torch.int32),
        tdec.drop_masks(cfg_t, B, STEPS1, device="cpu"))
    np.testing.assert_allclose(f, np.asarray(f_j), rtol=0, atol=3e-5)
    np.testing.assert_allclose(s, np.asarray(s_j), rtol=0, atol=3e-5)
    np.testing.assert_allclose(a, np.asarray(a_j), rtol=0, atol=1e-5)


def _synths(pin_stop=-30.0, **tc):
    """The JAX and the port's synthesizers (tests/test_torch_synth.py's
    config with `tc`); the stop bias pinned off, or at 0 for GTA, whose
    lengths are the targets'."""
    tparams, stats, _ = flax_weights(pin_stop)
    cfg_j, cfg_t = (_tc(synth_cfg(c), **tc) for c in (small_cfg, torch_cfg))
    return (jts.TacotronSynthesizer(cfg_j, tparams, stats),
            tts.TacotronSynthesizer(cfg_t, tparams, stats, device="cpu",
                                    keep_intermediates=True))


TEXTS = ["hello there.", "a b c d e.", "ok."]
LONG = ["the quick brown fox jumps over the lazy dog, " * 7]


def _synth_close(got, want):
    assert got["lengths"] == want["lengths"]
    s_t, s_j = got["stop_tokens"], np.asarray(want["stop_tokens"])
    np.testing.assert_allclose(s_t[:, :s_j.shape[1]], s_j, rtol=0, atol=2e-5)
    for a, b in zip(got["mels"], want["mels"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-4)
    for a, b in zip(got["alignments"], want["alignments"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("texts,route", [(TEXTS, "fused"), (LONG, "block")],
                         ids=["short", "long"])
def test_smoothing_synthesize_matches_jax(texts, route):
    """`synthesize` under smoothing, both decode routes, against the JAX
    synthesizer (its CPU route: the scan)."""
    js, ts = _synths(smoothing=True)
    refs = [inputs()[2][i % B] for i in range(len(texts))]
    got = ts.synthesize(texts, refs, refs)
    assert ts.intermediates["route"] == route
    _synth_close(got, js.synthesize(texts, refs, refs))


def test_smoothing_gta_takes_the_plain_route():
    """GTA under smoothing: the plain teacher-forced decode (route
    "teacher_forced_plain", no kernel launch) against the JAX synthesizer,
    which scans it; the teacher-forced kernels themselves still refuse
    smoothing, as `build_train_fwd` asserts."""
    js, ts = _synths(0.0, smoothing=True, use_fused_train_decoder=True,
                     fused_train_dtype="float32")
    refs = [inputs()[2][i % B] for i in range(3)]
    rng = np.random.default_rng(5)
    targets = [rng.uniform(-4, 4, (f, 20)).astype(np.float32)
               for f in (37, 50, 23)]
    n = tk.launches
    got = ts.synthesize(TEXTS, refs, refs, mel_targets=targets, gta=True)
    assert ts.intermediates["route"] == "teacher_forced_plain"
    assert tk.launches == n
    want = js.synthesize(TEXTS, refs, refs, mel_targets=targets, gta=True)
    for a, b in zip(got["mels"], want["mels"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got["stop_tokens"],
                               np.asarray(want["stop_tokens"]), atol=2e-4,
                               rtol=0)
    im = ts.intermediates
    dp, kw = ts.teacher_forced_weights()
    with pytest.raises(ValueError, match="smoothing"):
        tk.teacher_forced_fwd(dp, ts.cfg, im["keys"], im["memory"],
                              im["mask"], im["teacher"], im["coins"],
                              im["drop"])


def _train_steps(n_steps, **tc):
    """n whole train steps of the JAX trainer and the port's from the same
    weights (test_torch_train_step.py's set-up with `tc`)."""
    from tacotron2_tpu.train.tacotron_step import TacotronTrainer as JaxTrainer
    from tacotron2_tpu_torch.convert import tacotron_to_flax
    from tacotron2_tpu_torch.train.tacotron_step import TacotronTrainer
    jcfg, tcfg = cfgs(**tc)
    b = batch4()
    trainer_j = JaxTrainer(jcfg)
    state_j = trainer_j.init_state(jax.random.PRNGKey(0), b)
    trainer = TacotronTrainer(tcfg, device="cpu")
    state = trainer.init_state(model=port_model(state_j, tcfg))
    step = jax.jit(trainer_j.train_step)
    for i in range(n_steps):
        state_j, mj = step(state_j, b, jax.random.PRNGKey(i))
        state, mt = trainer.train_step(state, b,
                                       torch.Generator().manual_seed(i))
        for k in TERMS:
            close_rel(float(mt[k]), float(mj[k]), msg=f"step {i} {k}")
        close_rel(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-4,
                  msg=f"step {i} grad_norm")
    params, _ = tacotron_to_flax(state.model)
    for p, v in jax.tree_util.tree_flatten_with_path(
            _to_np(state_j.params))[0]:
        leaf = params
        for key in p:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf, v, rtol=0, atol=STEP_PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(p))


def test_smoothing_train_steps_match_jax_trainer():
    """Three train steps under smoothing: the port's plain route (no
    teacher-forced kernel) against the JAX trainer's scan."""
    n = (tk.train_launches, tk.bwd_launches)
    _train_steps(3, smoothing=True, use_fused_train_decoder=True)
    assert (tk.train_launches, tk.bwd_launches) == n


# ---------------------------------------------------------------- f32


def test_f32_train_step_matches_jax_fused_trainer():
    """One train step with fused_train_dtype=float32 against the JAX
    trainer through its fused teacher-forced kernels in f32 (interpret
    mode). The plain backward against `build_train_bwd(float32)` is held
    on its own by tests/test_torch_train_kernel.py (FusedTeacherForced's
    gradients against make_fused_teacher_forced)."""
    _train_steps(1, use_fused_train_decoder=True)


def test_f32_synthesizer_and_program_match_jax():
    """fused_decoder_dtype=float32 through `TacotronSynthesizer` (both
    routes) and `TextToWavProgram` against the JAX ones: the f32 weights
    reach every route uncast."""
    js, ts = _synths(fused_decoder_dtype="float32")
    assert ts.dec_params.l1_wp.dtype == torch.float32
    for texts in (TEXTS, LONG):
        refs = [inputs()[2][i % B] for i in range(len(texts))]
        _synth_close(ts.synthesize(texts, refs, refs),
                     js.synthesize(texts, refs, refs))
    tparams, stats, wparams = flax_weights()
    ids, lengths, refs = inputs()
    cfg_j, cfg_t = small_cfg(), torch_cfg()
    assert cfg_t.tacotron.fused_decoder_dtype == "float32"
    jp = JaxProgram(cfg_j, tparams, stats, None, batch=B, steps=STEPS,
                    t_in=T_IN, t_ref=T_REF, vocoder="griffin_lim",
                    interpret=True)
    tp = TextToWavProgram(cfg_t, tparams, stats, None, batch=B, steps=STEPS,
                          t_in=T_IN, t_ref=T_REF, device="cpu",
                          vocoder="griffin_lim")
    assert tp.dec_params.l1_wp.dtype == torch.float32
    want = jp(ids, lengths, refs, refs)
    got = tp(ids, lengths, refs, refs)
    # the mel and its length, as tests/test_torch_pipeline.py holds them
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-3, atol=2e-4)


# ---------------------------------------------------------------- refusals


def test_unequal_prenet_widths_raise_value_error():
    """The decode kernels' weights and the program refuse a prenet other
    than two layers of one width (the synthesizer decodes it through the
    plain version: tests/test_torch_variant_routes.py)."""
    from tacotron2_tpu_torch import convert
    cfg_t = _tc(torch_cfg(), prenet_layers=(32, 16))
    tparams, stats = convert.tacotron_to_flax(convert.init_tacotron(
        cfg_t, torch.Generator().manual_seed(0), "cpu"))
    dp = dk.extract_decoder_params(tparams, cfg_t, device="cpu")
    with pytest.raises(ValueError, match="prenet"):
        dk.pack_weights(dp)
    with pytest.raises(ValueError, match="prenet"):
        TextToWavProgram(cfg_t, tparams, stats, None, batch=B, steps=STEPS,
                         t_in=T_IN, device="cpu", vocoder="griffin_lim")


class _NoLibrary(Exception):
    pass


def test_launchers_refuse_mixed_weight_types(whole, monkeypatch):
    """Kernel weights of two types raise ValueError before any library is
    loaded; one type, bf16 or f32, passes the check."""
    def no_lib():
        raise _NoLibrary
    monkeypatch.setattr(dk, "_lib", no_lib)
    monkeypatch.setattr(tk, "_bwd_lib", no_lib)
    params, keys, memory, mask = whole
    cfg_t = torch_cfg()
    dp = dk.extract_decoder_params({"decoder": params}, cfg_t, device="cpu")
    args = (cfg_t, torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask))
    for wd in (torch.float32, torch.bfloat16):
        kw = dk.pack_weights(tk.cast_params(dp, wd))
        assert kw.l1_w.dtype == wd
        with pytest.raises(_NoLibrary):
            dk.prepare_launch(kw, *args)
        for name in ("wq", "proj_w"):
            other = torch.bfloat16 if wd == torch.float32 else torch.float32
            mixed = kw._replace(**{name: getattr(kw, name).to(other)})
            with pytest.raises(ValueError, match="one type"):
                dk.prepare_launch(mixed, *args)
            with pytest.raises(ValueError, match="one type"):
                tk._bwd_cuda(mixed, cfg_t, {}, *args[1:3], None, None, None,
                             torch.zeros(B, 1, 1), None)


def test_model_routes_smoothing_to_the_plain_decode(monkeypatch):
    """Under smoothing `Tacotron.forward` takes the plain teacher-forced
    decode in train and eval mode whatever `decode` says; the kernels'
    wrappers are never called."""
    def refuse(*a, **k):
        raise AssertionError("a teacher-forced kernel wrapper was called")
    for name in ("teacher_forced_fwd", "teacher_forced_train_fwd",
                 "teacher_forced_bwd"):
        monkeypatch.setattr(tk, name, refuse)
    _, tcfg = cfgs(smoothing=True)
    from tacotron2_tpu_torch.train.tacotron_step import TacotronTrainer
    trainer = TacotronTrainer(tcfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    b = batch4()
    terms, *_ = trainer.gradients(state, b, torch.Generator().manual_seed(1),
                                  decode="fused")
    assert np.isfinite(float(terms["loss"].detach()))
    out, _ = trainer.eval_step(state, b, torch.Generator().manual_seed(2))
    a = out["alignments"].numpy()
    np.testing.assert_allclose(a.sum(1), 1.0, rtol=0, atol=1e-5)
