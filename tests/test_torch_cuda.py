"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these need an NVIDIA GPU (sm_90a) and nvcc, and skip
elsewhere. Run them on the GPU machine with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Small configuration, random numpy weights in the flax tree layout (no JAX
needed: the GPU machine has none), injected random numbers (prenet dropout
on, live sampler noise), so both sides see the same inputs. The plain
versions run on the same card with TF32 off. Tolerances: the
decode kernel and its plain version both upcast the bf16 weights and sum
in f32, differing in summation order only (frames atol 1e-3 over 8
steps, stop probabilities and alignments 1e-4; the same under emt_attn,
whose scorer the kernel also computes in another sum order, for every
state field, context_emt too); the teacher-forced mode
of the same kernel and its plain version also round each activation to
bf16 where it enters a product, so another sum order may move one such
rounding by a step (~0.4%) (frames atol 1e-3, stop logits 1e-3 times
max(1, |logit|), alignments 1e-4, chip_smoke.py's gates); the sampler's Gaussian
head in f32 throughout (atol 1e-4 over 64 fed-back samples), and every
head and dtype by the teacher-forced oracle of tests/test_pallas_kernels.py
:142 (the plain version replays the kernel's own trajectory): each draw is
the plain version's — the class its logits pick by inverse CDF at the
same uniform, or the MoL sample of that component within
SAMPLER_REPLAY_ATOL — except at ties, u·total within 1e-5 relative of a
cumulative boundary (in bf16, where another f32 sum order may move a bf16
rounding of x or h by one step, ~0.4%, for at most 5% of the draws, as
chip_smoke.py holds them), at batch sizes that span the kernel's 8-row
clusters; Griffin-Lim on both routes, the per-frame f32 FFTs (n_fft a power
of two) and the DFT products over the 800-sample window support as 3xTF32
tensor-core products, each 8-deep step added in f32 (any other n_fft),
both in another sum order than the plain version's products (samples atol
1e-4 at iters 0 and GL_ITERS4_ATOL after 4 iterations, and the
spectral-consistency error, tests/test_pallas_kernels.py:237's measure,
within 1% of the plain version's). The train mode of the
teacher-forced kernel (Bernoulli zoneout from injected masks) is held as
its eval mode, each residual at the frames' tolerance (the alignments'
and cumulative alignments' at theirs); the backward kernel against its
plain version on the same (the kernel's) residuals, each gradient within
BWD_RTOL of its largest magnitude: both take the same rounded operands and
f32 gradients, in another sum order. The WaveNet stack kernels (5a, 5b)
against their plain versions within STACK_RTOL of each output's largest
value, and a train step through them against the layer loop by the
cosine of all gradients.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tacotron2_tpu_torch.models.tacotron.decoder import (BLOCK, Casts,
                                                         drop_masks,
                                                         emt_operands,
                                                         zoneout_masks)
from tacotron2_tpu_torch.models.wavenet.distributions import (
    draw_noise, inverse_cdf_pick)

Q = 256
from tacotron2_tpu_torch.models.wavenet.sampler import extract_sampler_params
from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.ops import griffin_lim_kernel as glk
from tacotron2_tpu_torch.ops import stft as tst
from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
from tacotron2_tpu_torch.ops import wavenet_kernel as wk

MELS, P, U, A, F, KW, M, R = 20, 16, 32, 16, 8, 7, 48, 2
# Griffin-Lim kernel vs plain after 4 iterations on the noise below, by
# start: the readings were 2.7e-4 from the zero-phase start (where plain f32
# itself lies 3.1e-4 from float64) and 3.8e-6 from random phases, on an
# H100 (scripts/griffin_lim_accuracy.py)
GL_ITERS4_ATOL = {"zero-phase": 1e-3, "random-phase": 2e-5}
# kernel vs the plain version replaying its trajectory, one step at a time:
# f32 differs in sum order only; bf16 also where that moves a rounding
SAMPLER_REPLAY_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}
SAMPLER_BF16_MOVED = 0.05
BWD_RTOL = 1e-3


def torch_cfg():
    cfg = Config()
    return cfg.replace(
        tacotron=dataclasses.replace(
            cfg.tacotron, attention_dim=A, attention_filters=F,
            attention_kernel=KW, prenet_layers=(P, P), decoder_lstm_units=U,
            outputs_per_step=R, dropout_rate=0.0,
            fused_decoder_dtype="float32"),
        audio=dataclasses.replace(cfg.audio, num_mels=MELS, hop_size=4),
        wavenet=dataclasses.replace(
            cfg.wavenet, layers=4, stacks=2, upsample_scales=(2, 2),
            cin_channels=MELS))


def _w(rng, *shape):
    return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)


def decoder_tree(seed=0, mw=M):
    rng = np.random.default_rng(seed)
    M = mw
    d = lambda i, o: {"kernel": _w(rng, i, o), "bias": _w(rng, o)}
    cell = {
        "prenet": {"Dense_0": d(MELS, P), "Dense_1": d(P, P)},
        "lstm1": d(P + M + U, 4 * U), "lstm2": d(2 * U, 4 * U),
        "attention": {
            "query_layer": {"kernel": _w(rng, U, A)},
            "location_features_convolution": {
                "kernel": _w(rng, KW, 1, F), "bias": _w(rng, F)},
            "location_features_layer": {"kernel": _w(rng, F, A)},
            "attention_variable_projection": _w(rng, A, 1),
            "attention_bias": _w(rng, A)},
        "frame_projection": {"Dense_0": d(U + M, R * MELS)},
        "stop_projection": {"Dense_0": d(U + M, R)}}
    return {"decoder": {"cell": cell}}


def sampler_tree(cfg, seed=1):
    """Random WaveNet weights for `cfg`'s head: the Gaussian head keeps its
    samples off the ±1 clip; mixture and categorical logits spread the
    picks over many components and classes."""
    rng = np.random.default_rng(seed)
    wn = cfg.wavenet
    Rc, G, S = wn.residual_channels, wn.gate_channels, wn.skip_out_channels
    n_in = wn.quantize_channels if wn.input_type == "mulaw-quantize" else 1
    d = lambda i, o: {"Dense_0": {"kernel": _w(rng, i, o),
                                  "bias": _w(rng, o)}}
    tree = {f"residual_block_{i}": {
        "causal_conv": {"Conv_0": {"kernel": _w(rng, 3, Rc, G) / 2,
                                   "bias": _w(rng, G)}},
        "cin_conv": d(MELS, G), "skip_conv": d(G // 2, S),
        "out_conv": d(G // 2, Rc)} for i in range(wn.layers)}
    tree.update(input_convolution=d(n_in, Rc), final_convolution_1=d(S, S),
                final_convolution_2=d(S, wn.out_channels))
    head = tree["final_convolution_2"]["Dense_0"]
    if wn.out_channels == 2:                           # keep samples off
        head["kernel"] *= 0.1                          # the ±1 clip
        head["bias"][:] = (0.0, -3.0)
    elif wn.input_type != "mulaw-quantize":            # MoL: means and
        nr = wn.out_channels // 3                      # scales off the clip
        head["kernel"][:, nr:] *= 0.1
        head["bias"][2 * nr:] = -3.0
    return tree


def head_cfg(kind, **extra):
    cfg = torch_cfg()
    heads = {"gaussian": dict(out_channels=2), "mol": dict(out_channels=30),
             "categorical": dict(out_channels=256, quantize_channels=256,
                                 input_type="mulaw-quantize")}
    return cfg.replace(wavenet=dataclasses.replace(
        cfg.wavenet, **heads[kind], **extra))

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) for the port's kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_decoder_kernel_matches_plain(dev):
    tparams = decoder_tree()
    cfg = torch_cfg()
    cfg = cfg.replace(tacotron=dataclasses.replace(
        cfg.tacotron, dropout_rate=0.5, fused_decoder_dtype="bfloat16"))
    B, T, steps = 3, 24, 8
    rng = np.random.default_rng(0)
    memory = torch.as_tensor(rng.normal(size=(B, T, M)), dtype=torch.float32,
                             device=dev)
    keys = torch.as_tensor(rng.normal(size=(B, T, 16)) * 0.3,
                           dtype=torch.float32, device=dev)
    mask = torch.arange(T, device=dev)[None] < torch.as_tensor(
        [T, 17, 9], device=dev)[:, None]
    dp = dk.extract_decoder_params(tparams, cfg, device=dev)
    drop = drop_masks(cfg, B, steps, torch.Generator(dev).manual_seed(1), dev)
    before = dk.rows_launches
    f_k, s_k, a_k = dk.decode(dp, cfg, keys, memory, mask, drop, steps=steps,
                              early_stop_block=4,
                              kernel_weights=dk.pack_weights(dp))
    assert dk.rows_launches == before + 2          # one launch per 4-step block
    f_p, s_p, a_p = dk.decode_plain(dp, cfg, keys, memory, mask, drop,
                                    steps=steps, early_stop_block=4)
    torch.cuda.synchronize()
    np.testing.assert_allclose(f_k.cpu(), f_p.cpu(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(s_k.cpu(), s_p.cpu(), atol=1e-4, rtol=0)
    assert a_k.shape == (B, T, steps)
    np.testing.assert_allclose(a_k.cpu(), a_p.cpu(), atol=1e-4, rtol=0)


def _decoder_case(dev, B, T, steps, seed=0, wd="bfloat16", mw=M, **tc):
    cfg = torch_cfg()
    cfg = cfg.replace(tacotron=dataclasses.replace(
        cfg.tacotron, dropout_rate=0.5, fused_decoder_dtype=wd,
        fused_train_dtype=wd, **tc))
    rng = np.random.default_rng(seed)
    memory = torch.as_tensor(rng.normal(size=(B, T, mw)),
                             dtype=torch.float32, device=dev)
    keys = torch.as_tensor(rng.normal(size=(B, T, A)) * 0.3,
                           dtype=torch.float32, device=dev)
    lens = torch.as_tensor([max(T - 7 * i, min(T, 3)) for i in range(B)],
                           device=dev)
    mask = torch.arange(T, device=dev)[None] < lens[:, None]
    dp = dk.extract_decoder_params(decoder_tree(seed, mw), cfg, device=dev)
    drop = drop_masks(cfg, B, steps, torch.Generator(dev).manual_seed(1), dev)
    return cfg, dp, keys, memory, mask, drop


def test_decoder_early_stop_waits_for_every_row(dev):
    """Rows that fire in different blocks: the chained launches stop the
    batch at the first boundary where all rows have fired, as the plain
    version (and the TPU kernel) do."""
    _early_stop_case(dev, 3)


def test_rows_early_stop_spans_clusters(dev):
    """The same at B=9 (the three rows thrice): two clusters of
    csrc/decoder_rows.cu, which count their fired rows into one slot a
    launch; the chain stops only when the rows of both have fired."""
    _early_stop_case(dev, 9)


def _early_stop_case(dev, B):
    T, steps, K = 24, 32, 4
    cfg, dp, keys, memory, mask, drop = _decoder_case(dev, 3, T, steps)
    rows = torch.arange(B, device=dev) % 3
    keys, memory, mask, drop = (x[rows].contiguous()
                                for x in (keys, memory, mask, drop))
    r = cfg.tacotron.outputs_per_step
    # stop projection weights ×10: the stop logits wander over a wider
    # range, so rows cross a threshold at well separated steps
    fo = r * cfg.audio.num_mels
    dp = dp._replace(proj_wo=dp.proj_wo.clone(), proj_wc=dp.proj_wc.clone())
    dp.proj_wo[:, fo:] *= 10
    dp.proj_wc[:, fo:] *= 10
    _, s_full, _ = dk.decode_plain(dp, cfg, keys, memory, mask, drop,
                                   steps=steps)
    p = s_full.reshape(B, steps, r).min(-1).values.cpu().numpy()
    logit = np.log(p / (1 - p))

    def first_fire(shift):
        return [int(np.argmax(row + shift > 0)) if (row + shift > 0).any()
                else steps for row in logit]

    # a stop-bias shift (the stop logits do not feed back) half-way between
    # two logits at least 0.004 apart (kernel and plain stop probabilities
    # differ by ~1e-5), under which the rows fire in different blocks and
    # the batch stops before the last block
    vals = np.sort(logit.ravel())
    picks = [-(a + b) / 2 for a, b in zip(vals[:-1], vals[1:])
             if b - a > 0.004]
    ok = [sh for sh in picks if len({f // K for f in first_fire(sh)}) > 1
          and max(first_fire(sh)) < steps - K]
    assert ok, np.array2string(logit, precision=3, threshold=10 ** 4)
    shift = ok[0]
    first = first_fire(shift)
    stop_at = K * (max(first) // K + 1)
    dp = dp._replace(proj_b=dp.proj_b.clone())
    dp.proj_b[-r:] += float(shift)
    before = dk.rows_launches
    f_k, s_k, a_k = dk.decode(dp, cfg, keys, memory, mask, drop, steps=steps,
                              early_stop_block=K,
                              kernel_weights=dk.pack_weights(dp))
    assert dk.rows_launches == before + steps // K
    f_p, s_p, a_p = dk.decode_plain(dp, cfg, keys, memory, mask, drop,
                                    steps=steps, early_stop_block=K)
    torch.cuda.synchronize()
    np.testing.assert_allclose(f_k.cpu(), f_p.cpu(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(s_k.cpu(), s_p.cpu(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(a_k.cpu(), a_p.cpu(), atol=1e-4, rtol=0)
    assert torch.all(s_k[:, stop_at * r:] == 1.0)
    assert torch.all(f_k[:, stop_at * r:] == 0.0)
    assert torch.all(f_k[:, (stop_at - 1) * r:stop_at * r] != 0.0)


@pytest.mark.parametrize("T", [300, 1000])
def test_decode_block_matches_plain_past_256(dev, T):
    """K-step blocks from explicit state past the TPU's 256-character
    monolithic envelope: two chained blocks, outputs and carried state."""
    B, K = 2, 4
    cfg, dp, keys, memory, mask, drop = _decoder_case(dev, B, T, 2 * K)
    kw = dk.pack_weights(dp)
    st_k = st_p = dk.init_decoder_state(cfg, B, T, M, dev)
    for blk in range(2):
        d = drop[:, blk * K:(blk + 1) * K]
        f_k, s_k, a_k, st_k = dk.decode_block(dp, cfg, keys, memory, mask,
                                              st_k, d, kernel_weights=kw)
        f_p, s_p, a_p, st_p = dk.decode_block_plain(dp, cfg, keys, memory,
                                                    mask, st_p, d)
        torch.cuda.synchronize()
        np.testing.assert_allclose(f_k.cpu(), f_p.cpu(), atol=1e-3, rtol=0)
        np.testing.assert_allclose(s_k.cpu(), s_p.cpu(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(a_k.cpu(), a_p.cpu(), atol=1e-4, rtol=0)
        assert st_k.ctx_emt is None and st_p.ctx_emt is None
        for name in st_k._fields[:-1]:
            x, y = getattr(st_k, name), getattr(st_p, name)
            if name == "pmax":
                assert torch.equal(x, y)
            else:
                np.testing.assert_allclose(x.cpu(), y.cpu(), atol=1e-3,
                                           rtol=0, err_msg=name)


# (weights, smoothing): the envelope beyond bf16 softmax, which the tests
# above hold
ENVELOPE = {"f32": ("float32", False), "f32-smoothing": ("float32", True),
            "bf16-smoothing": ("bfloat16", True)}


@pytest.mark.parametrize("case", list(ENVELOPE))
def test_decoder_envelope_matches_plain(dev, case):
    """Kernel 1 (the whole-decode chain with the batch-wide early stop) and
    kernel 3 (two chained blocks past 256 input positions, at the block
    kernel's default energy_mode and at "vpu") with f32 weights and under
    smoothing, against the plain version: the tolerances of the bf16
    softmax tests above (f32 sums in another order)."""
    wd, smoothing = ENVELOPE[case]
    B, T, steps, K = 3, 24, 8, 4
    cfg, dp, keys, memory, mask, drop = _decoder_case(dev, B, T, steps, wd=wd,
                                                      smoothing=smoothing)
    kw = dk.pack_weights(dp)
    assert kw.l1_w.dtype == getattr(torch, wd)
    before = dk.rows_launches
    f_k, s_k, a_k = dk.decode(dp, cfg, keys, memory, mask, drop, steps=steps,
                              early_stop_block=K, kernel_weights=kw)
    assert dk.rows_launches == before + steps // K
    f_p, s_p, a_p = dk.decode_plain(dp, cfg, keys, memory, mask, drop,
                                    steps=steps, early_stop_block=K)
    torch.cuda.synchronize()
    np.testing.assert_allclose(f_k.cpu(), f_p.cpu(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(s_k.cpu(), s_p.cpu(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(a_k.cpu(), a_p.cpu(), atol=1e-4, rtol=0)
    if smoothing:         # the sigmoids, not the softmax
        _, _, a_soft = dk.decode_plain(dp, cfg.replace(
            tacotron=dataclasses.replace(cfg.tacotron, smoothing=False)),
            keys, memory, mask, drop, steps=steps)
        assert float((a_soft - a_p).abs().max()) > 1e-2
    T2 = 300
    cfg, dp, keys, memory, mask, drop = _decoder_case(dev, 2, T2, 2 * K,
                                                      wd=wd,
                                                      smoothing=smoothing)
    kw = dk.pack_weights(dp)
    # the default energy_mode ("vmat") and "vpu" (the tanh kept f32)
    for casts in (BLOCK, Casts(True, True, False)):
        st_k = st_p = dk.init_decoder_state(cfg, 2, T2, M, dev)
        for blk in range(2):
            d = drop[:, blk * K:(blk + 1) * K]
            f_k, s_k, a_k, st_k = dk.decode_block(
                dp, cfg, keys, memory, mask, st_k, d, kernel_weights=kw,
                casts=casts)
            f_p, s_p, a_p, st_p = dk.decode_block_plain(
                dp, cfg, keys, memory, mask, st_p, d, casts=casts)
            torch.cuda.synchronize()
            np.testing.assert_allclose(f_k.cpu(), f_p.cpu(), atol=1e-3,
                                       rtol=0)
            np.testing.assert_allclose(s_k.cpu(), s_p.cpu(), atol=1e-4,
                                       rtol=0)
            np.testing.assert_allclose(a_k.cpu(), a_p.cpu(), atol=1e-4,
                                       rtol=0)
            for name in st_k._fields[:-1]:
                x, y = getattr(st_k, name), getattr(st_p, name)
                if name == "pmax":
                    assert torch.equal(x, y)
                else:
                    np.testing.assert_allclose(x.cpu(), y.cpu(), atol=1e-3,
                                               rtol=0, err_msg=name)


def test_bf16_decode_rounds_where_the_tpu_kernels_round(dev):
    """The bf16 autoregressive kernel computes the rounded function: it
    lies far closer to the plain version with the roundings than to the
    same weights in f32 without them."""
    B, T, steps = 3, 24, 8
    cfg, dp, keys, memory, mask, drop = _decoder_case(dev, B, T, steps)
    f_k, _, _ = dk.decode(dp, cfg, keys, memory, mask, drop, steps=steps,
                          kernel_weights=dk.pack_weights(dp))
    f_p, _, _ = dk.decode_plain(dp, cfg, keys, memory, mask, drop,
                                steps=steps)
    cfg32 = cfg.replace(tacotron=dataclasses.replace(
        cfg.tacotron, fused_decoder_dtype="float32"))
    f_u, _, _ = dk.decode_plain(tk.cast_params(dp, torch.float32), cfg32,
                                keys, memory, mask, drop, steps=steps)
    torch.cuda.synchronize()
    near, far = float((f_k - f_p).abs().max()), float((f_k - f_u).abs().max())
    assert near <= 1e-3 and far > 10 * near, (near, far)


def _close_decode(got, want):
    np.testing.assert_allclose(got[0].cpu(), want[0].cpu(), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(got[1].cpu(), want[1].cpu(), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got[2].cpu(), want[2].cpu(), atol=1e-4,
                               rtol=0)


def _close_state(st_k, st_p):
    for name in st_k._fields[:-1]:
        x, y = getattr(st_k, name), getattr(st_p, name)
        if name == "pmax":
            assert torch.equal(x, y)
        else:
            np.testing.assert_allclose(x.cpu(), y.cpu(), atol=1e-3, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("mw", [M, 40], ids=["cs16", "cs8"])
@pytest.mark.parametrize("wd", ["bfloat16", "float32"])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 16])
def test_rows_decode_matches_plain(dev, B, wd, mw):
    """csrc/decoder_rows.cu at batch sizes that fill, split and pad its
    8-row clusters, with 16 CTAs a cluster (M 48) and 8 (M 40, which does
    not split 16 ways), against the plain version: kernel 1's chain of
    4-step launches and kernel 3's block route (two chained 4-step blocks,
    every state field); a rerun repeats every bit."""
    steps, K = 8, 4
    cfg, dp, keys, memory, mask, drop = _decoder_case(dev, B, 24, steps,
                                                      wd=wd, mw=mw)
    kw = dk.pack_weights(dp)
    assert kw.rows.cs == (16 if mw == M else 8)
    before = dk.rows_launches
    got = dk.decode(dp, cfg, keys, memory, mask, drop, steps=steps,
                    early_stop_block=K, kernel_weights=kw)
    assert dk.rows_launches == before + steps // K
    again = dk.decode(dp, cfg, keys, memory, mask, drop, steps=steps,
                      early_stop_block=K, kernel_weights=kw)
    want = dk.decode_plain(dp, cfg, keys, memory, mask, drop, steps=steps,
                           early_stop_block=K)
    torch.cuda.synchronize()
    _close_decode(got, want)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    st_k = st_p = dk.init_decoder_state(cfg, B, 24, mw, dev)
    for blk in range(2):
        d = drop[:, blk * K:(blk + 1) * K]
        *out_k, st_k = dk.decode_block(dp, cfg, keys, memory, mask, st_k, d,
                                       kernel_weights=kw)
        *out_p, st_p = dk.decode_block_plain(dp, cfg, keys, memory, mask,
                                             st_p, d)
        torch.cuda.synchronize()
        _close_decode(out_k, out_p)
        _close_state(st_k, st_p)


def test_rows_decode_spills_past_shared_memory(dev):
    """At T_in 3,000 the attention's buffers of 8 rows do not fit a CTA's
    shared memory: they live in the CTA's global scratch (the plan says
    so), and the block route still matches the plain version, bf16 and
    f32."""
    B, T, K = 3, 3000, 2
    for wd in ("bfloat16", "float32"):
        cfg, dp, keys, memory, mask, drop = _decoder_case(dev, B, T, 2 * K,
                                                          wd=wd)
        kw = dk.pack_weights(dp)
        plan = dk.rows_plan(dk.rows_widths(cfg, M, T), kw.rows.cs,
                            wd == "float32")
        small = dk.rows_plan(dk.rows_widths(cfg, M, 24), kw.rows.cs,
                             wd == "float32")
        assert plan["spill"] > 0 and plan["in_smem"] < small["in_smem"]
        st_k = st_p = dk.init_decoder_state(cfg, B, T, M, dev)
        for blk in range(2):
            d = drop[:, blk * K:(blk + 1) * K]
            *out_k, st_k = dk.decode_block(dp, cfg, keys, memory, mask, st_k,
                                           d, kernel_weights=kw)
            *out_p, st_p = dk.decode_block_plain(dp, cfg, keys, memory, mask,
                                                 st_p, d)
            torch.cuda.synchronize()
            _close_decode(out_k, out_p)
            _close_state(st_k, st_p)


EMT_CASES = {"simple": ("simple", True), "simple-no-ref": ("simple", False),
             "multihead": ("multihead", True)}


def emt_case(dev, kind, with_ref, B=3, T=24, Te=5, seed=3, wd="bfloat16"):
    """A decoder under emt_attn (reference_depth 8: V = 16; multihead with
    2 heads of 8 and the 128-wide attn_emt_out) with random weights in the
    flax layout, prenet dropout on, decode weights in `wd`: (cfg, dp,
    kernel weights, keys, memory, mask, emt operands)."""
    cfg = torch_cfg()
    cfg = cfg.replace(
        tacotron=dataclasses.replace(cfg.tacotron, dropout_rate=0.5,
                                     fused_decoder_dtype=wd),
        gst=dataclasses.replace(cfg.gst, emt_attn=True, emt_attn_type=kind,
                                reference_depth=8, num_heads=2,
                                style_att_dim=16))
    V, E = 16, 16 if kind == "simple" else 128
    Rr = 128 if kind == "simple" and with_ref else 0
    rng = np.random.default_rng(seed)
    tree = decoder_tree(seed)
    cell = tree["decoder"]["cell"]
    cell["lstm1"]["kernel"] = _w(rng, P + M + E + Rr + U, 4 * U)
    d = lambda i, o: {"kernel": _w(rng, i, o), "bias": _w(rng, o)}
    if kind == "simple":
        cell["attention_emt"] = {"W1": d(V, 16), "W2": d(U, 16),
                                 "V": d(16, 1)}
    else:
        cell["attention_emt"] = {
            "q_proj": d(U, 16), "k_proj": d(V, 16),
            "attention_v": _w(rng, 8), "attention_g": np.float32(0.35),
            "attention_b": _w(rng, 8)}
        cell["attn_emt_out"] = d(2 * V, 128)
    emt_only = kind == "simple" and not with_ref
    dp = dk.extract_decoder_params(tree, cfg, device=dev, emt_only=emt_only)
    ep = dk.extract_emt_params(tree, cfg, device=dev, emt_only=emt_only)
    t = lambda *s: torch.as_tensor(rng.normal(size=s) * 0.5,
                                   dtype=torch.float32, device=dev)
    memory, keys = t(B, T, M), t(B, T, A) * 0.6
    lens = torch.as_tensor([max(T - 7 * i, min(T, 3)) for i in range(B)],
                           device=dev)
    mask = torch.arange(T, device=dev)[None] < lens[:, None]
    emt = emt_operands(ep, cfg, t(B, Te, V), t(B, 128) if with_ref else None)
    return (cfg, dp, dk.pack_weights(dp, emt=ep), keys, memory, mask, emt)


@pytest.mark.parametrize("wd", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", list(EMT_CASES))
def test_emt_decode_block_matches_plain(dev, case, wd):
    """Kernel 3's emt scorers: two chained 4-step blocks from the zero
    state under emt_attn, against the plain version — frames, stops,
    alignments and every state field, ctx_emt too (the tolerances of the
    non-emt block test); then the whole-decode chain with the batch-wide
    early stop. bf16 and f32 decode weights."""
    cfg, dp, kw, keys, memory, mask, emt = emt_case(dev, *EMT_CASES[case],
                                                    wd=wd)
    assert kw.l1_w.dtype == kw.w2e.dtype == getattr(torch, wd)
    B, T = memory.shape[:2]
    K = 4
    drop = drop_masks(cfg, B, 2 * K, torch.Generator(dev).manual_seed(1), dev)
    st_k = st_p = dk.init_decoder_state(cfg, B, T, M, dev)
    assert st_k.ctx_emt.shape == (B, kw.E)
    before = dk.launches
    for blk in range(2):
        d = drop[:, blk * K:(blk + 1) * K]
        f_k, s_k, a_k, st_k = dk.decode_block(dp, cfg, keys, memory, mask,
                                              st_k, d, kernel_weights=kw,
                                              emt=emt)
        f_p, s_p, a_p, st_p = dk.decode_block_plain(dp, cfg, keys, memory,
                                                    mask, st_p, d, emt)
        torch.cuda.synchronize()
        np.testing.assert_allclose(f_k.cpu(), f_p.cpu(), atol=1e-3, rtol=0)
        np.testing.assert_allclose(s_k.cpu(), s_p.cpu(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(a_k.cpu(), a_p.cpu(), atol=1e-4, rtol=0)
        for name in st_k._fields:
            x, y = getattr(st_k, name), getattr(st_p, name)
            if name == "pmax":
                assert torch.equal(x, y)
            else:
                np.testing.assert_allclose(x.cpu(), y.cpu(), atol=1e-3,
                                           rtol=0, err_msg=name)
    assert dk.launches == before + 2
    assert float(st_p.ctx_emt.abs().max()) > 1e-3   # the scorer ran
    f_k, s_k, _ = dk.decode(dp, cfg, keys, memory, mask, drop, steps=2 * K,
                            early_stop_block=K, kernel_weights=kw, emt=emt)
    f_p, s_p, _ = dk.decode_plain(dp, cfg, keys, memory, mask, drop,
                                  steps=2 * K, early_stop_block=K, emt=emt)
    torch.cuda.synchronize()
    np.testing.assert_allclose(f_k.cpu(), f_p.cpu(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(s_k.cpu(), s_p.cpu(), atol=1e-4, rtol=0)


def test_emt_kernel_refuses_what_it_does_not_take(dev):
    """No emt operands with emt kernel weights or the other way round, and
    no style_tokens (the plain version decodes it)."""
    cfg, dp, kw, keys, memory, mask, emt = emt_case(dev, "multihead", True)
    B, T = memory.shape[:2]
    drop = drop_masks(cfg, B, 2, None, dev)
    st = dk.init_decoder_state(cfg, B, T, M, dev)
    with pytest.raises(ValueError):
        dk.decode_block(dp, cfg, keys, memory, mask, st, drop,
                        kernel_weights=kw)
    with pytest.raises(ValueError):
        dk.decode_block(dp, cfg, keys, memory, mask, st, drop,
                        kernel_weights=kw, emt=emt._replace(
                            score=emt.score[:1].contiguous()))
    kw_plain = dk.pack_weights(dp)
    with pytest.raises(ValueError):
        dk.decode(dp, cfg, keys, memory, mask, drop, steps=2,
                  kernel_weights=kw_plain, emt=emt)


def _teacher_forced_case(dev, B, T, steps, coins, seed=0, wd="bfloat16"):
    """Teacher-forced kernel and plain version on the same inputs, train
    weights in `wd`: returns ((frames, stop logits, alignments) of each,
    launches made)."""
    cfg, _, keys, memory, mask, drop = _decoder_case(dev, B, T, steps, seed,
                                                     wd)
    dp = tk.extract_params(decoder_tree(seed), cfg, device=dev)
    assert dp.l1_wp.dtype == getattr(torch, wd)
    rng = np.random.default_rng(seed + 1)
    teacher = torch.as_tensor(rng.uniform(-4, 4, (steps, B, MELS)),
                              dtype=torch.float32, device=dev)
    coins = torch.as_tensor(coins, dtype=torch.int32)
    args = (dp, cfg, keys, memory, mask, teacher, coins, drop)
    before = tk.launches
    got = tk.teacher_forced_fwd(*args, kernel_weights=dk.pack_weights(dp))
    n = tk.launches - before
    want = tk.teacher_forced_fwd_plain(*args)
    torch.cuda.synchronize()
    return got, want, n


def _teacher_forced_close(got, want):
    (f_k, s_k, a_k), (f_p, s_p, a_p) = got, want
    assert f_k.shape == f_p.shape and a_k.shape == a_p.shape
    np.testing.assert_allclose(f_k.cpu(), f_p.cpu(), atol=1e-3, rtol=0)
    assert bool(((s_k - s_p).abs() <= 1e-3 * s_p.abs().clamp(min=1)).all())
    np.testing.assert_allclose(a_k.cpu(), a_p.cpu(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("wd", ["bfloat16", "float32"])
@pytest.mark.parametrize("coins", ["ones", "mixed"])
def test_teacher_forced_kernel_matches_plain(dev, coins, wd):
    """Small widths, prenet dropout on, stop logits (not probabilities):
    one launch for all steps; the mixed coins feed the kernel's own frames
    back on some steps. bf16 and f32 train weights."""
    B, T, steps = 3, 24, 12
    pick = {"ones": [1] * steps, "mixed": [1, 0, 0, 1, 1, 0] * 2}[coins]
    got, want, n = _teacher_forced_case(dev, B, T, steps, pick, wd=wd)
    assert n == 1
    assert got[2].shape == (B, T, steps)
    _teacher_forced_close(got, want)
    # logits, not probabilities
    assert float(got[1].min()) < 0 or float(got[1].max()) > 1


def test_teacher_forced_kernel_past_256(dev):
    got, want, n = _teacher_forced_case(dev, 2, 300, 8, [1, 1, 0, 1] * 2)
    assert n == 1
    _teacher_forced_close(got, want)


def _train_case(dev, B, T, steps, coins, seed=0, wd="bfloat16", mw=M):
    """The train forward (kernel and plain, same masks), then the backward
    (kernel and plain) on the kernel's residuals; train weights in `wd`,
    memory width mw."""
    cfg, _, keys, memory, mask, drop = _decoder_case(dev, B, T, steps, seed,
                                                     wd, mw=mw)
    cfg = cfg.replace(tacotron=dataclasses.replace(cfg.tacotron,
                                                   zoneout_rate=0.1))
    g = torch.Generator(device=dev).manual_seed(seed)
    zmask = zoneout_masks(cfg, B, steps, g, device=dev)
    dp = tk.extract_params(decoder_tree(seed, mw), cfg, device=dev)
    kw = dk.pack_weights(dp)
    rng = np.random.default_rng(seed + 1)
    teacher = torch.as_tensor(rng.uniform(-4, 4, (steps, B, MELS)),
                              dtype=torch.float32, device=dev)
    coins = torch.as_tensor(coins, dtype=torch.int32)
    args = (dp, cfg, keys, memory, mask, teacher, coins, drop, zmask)
    n0 = (tk.train_launches, tk.bwd_launches)
    got = tk.teacher_forced_train_fwd(*args, kernel_weights=kw)
    want = tk.teacher_forced_train_fwd_plain(*args)
    res = got[3]
    FO = R * MELS + R
    dout = torch.as_tensor(rng.normal(size=(B, steps, FO)),
                           dtype=torch.float32, device=dev)
    dalign = torch.as_tensor(rng.normal(size=(B, steps, T)) * 0.1,
                             dtype=torch.float32, device=dev)
    bargs = (dp, cfg, res, keys, memory, mask, coins, drop, zmask, dout,
             dalign)
    b_k = tk.teacher_forced_bwd(*bargs, kernel_weights=kw)
    # bf16: the plain backward replayed on the kernel's own gradients (a
    # rounding that another sum order moved cannot feed earlier steps),
    # and the same without the gradient rounding as the control
    replay = b_k if wd == "bfloat16" else None
    b_p = tk.teacher_forced_bwd_plain(*bargs, replay=replay)
    b_c = (tk.teacher_forced_bwd_plain(*bargs, round_gradients=False,
                                       replay=replay) if replay else None)
    torch.cuda.synchronize()
    n = (tk.train_launches - n0[0], tk.bwd_launches - n0[1])
    return got, want, b_k, b_p, n, b_c, (bargs, kw)


# kernel 4b with bf16 weights against its plain version replayed on its
# gradients (chip_smoke.py's phase 16 gate): each gradient's largest
# difference within BWD_CAP_STEPS bf16 steps of its largest magnitude, its
# mean difference at most BWD_MEAN_SHARE of the unrounded control's; what
# the rounding does not reach (the control gives it bit for bit) within
# BWD_RTOL
BWD_CAP_STEPS, BWD_MEAN_SHARE = 4, 0.1


def _bwd_close(b_k, b_p, b_c):
    assert set(b_k) == set(b_p)
    for name, x in b_k.items():
        y = b_p[name]
        assert x.shape == y.shape, name
        d = (x - y).abs()
        err = float(d.max()) / max(float(y.abs().max()), 1e-6)
        if b_c is None or torch.equal(b_c[name], y):
            assert err <= BWD_RTOL, (name, err)
            continue
        assert err <= BWD_CAP_STEPS * 2.0 ** -8, (name, err)
        share = float(d.mean()) / float((b_c[name] - y).abs().mean())
        assert share <= BWD_MEAN_SHARE, (name, share)


@pytest.mark.parametrize("B", [3, 8, 9, 16])
@pytest.mark.parametrize("wd", ["bfloat16", "float32"])
@pytest.mark.parametrize("coins", ["ones", "mixed"])
def test_train_kernels_match_plain(dev, coins, wd, B):
    """Kernel 4a's train mode (outputs and every residual) and kernel 4b
    (every activation gradient and per-row sum) against their plain
    versions, zoneout 0.1 and prenet dropout on injected masks; bf16 and
    f32 train weights, batches that fill, pad and span kernel 4b's 8-row
    clusters."""
    T, steps = 24, 12
    pick = {"ones": [1] * steps, "mixed": [1, 0, 0, 1, 1, 0] * 2}[coins]
    got, want, b_k, b_p, n, b_c, _ = _train_case(dev, B, T, steps, pick,
                                                 wd=wd)
    assert n == (1, 1)
    _teacher_forced_close(got[:3], want[:3])
    for name in tk.RES_NAMES:
        atol = 1e-4 if name == "cum_pre" else 1e-3
        np.testing.assert_allclose(got[3][name].cpu(), want[3][name].cpu(),
                                   atol=atol, rtol=0, err_msg=name)
    _bwd_close(b_k, b_p, b_c)


# kernel 4a against its plain version: f32 weights, every element within
# its tolerance (frames, residuals 1e-3; stop logits 1e-3 of max(1, |l|);
# alignments, cumulative alignments 1e-4); bf16, where another sum order
# may move a rounding by a step that the fed-back frames carry on (chip_
# smoke.py's TF_WITHIN rule), at least TF_SHARE of each field's elements
# within it and none past BWD_CAP_STEPS bf16 steps of max(1, its scale)
TF_SHARE = 0.99


def _train_fwd_close(got, want, wd):
    for name, y in want.items():
        d = (got[name] - y).abs()
        tol = 1e-4 if name in ("align", "cum_pre") else 1e-3
        if name == "stops":
            d = d / y.abs().clamp(min=1)
        within = float((d <= tol).float().mean())
        if wd == "float32":
            assert within == 1.0, (name, float(d.max()))
            continue
        cap = BWD_CAP_STEPS * 2.0 ** -8 * max(1.0, float(y.abs().max()))
        assert within >= TF_SHARE and float(d.max()) <= cap, (
            name, within, float(d.max()))


@pytest.mark.parametrize("mw", [M, 40], ids=["cs16", "cs8"])
@pytest.mark.parametrize("wd", ["bfloat16", "float32"])
@pytest.mark.parametrize("B", [1, 9, 16, 32])
def test_teacher_forced_rows_kernel_matches_plain(dev, B, wd, mw):
    """Kernel 4a, csrc/decoder_rows.cu's teacher-forced mode, at batch sizes
    that fill, pad and span its 8-row clusters, with 16 CTAs a cluster (M
    48) and 8 (M 40), mixed coins: the eval mode and the train mode
    (outputs and every residual) against their plain versions, one launch
    each, reruns bit for bit; and kernel 4b on the new residuals against
    its plain backward."""
    T, steps = 24, 12
    pick = [1, 0, 0, 1, 1, 0] * 2
    got, want, b_k, b_p, n, b_c, (bargs, kw) = _train_case(
        dev, B, T, steps, pick, wd=wd, mw=mw)
    assert kw.rows.cs == (16 if mw == M else 8)
    assert n == (1, 1)
    fields = lambda o: dict(zip(("frames", "stops", "align"), o[:3]),
                            **{k: o[3][k] for k in tk.RES_NAMES})
    _train_fwd_close(fields(got), fields(want), wd)
    _bwd_close(b_k, b_p, b_c)
    dp, cfg, res, keys, memory, mask, coins, drop, zmask = bargs[:9]
    teacher = torch.as_tensor(
        np.random.default_rng(1).uniform(-4, 4, (steps, B, MELS)),
        dtype=torch.float32, device=dev)
    fargs = (dp, cfg, keys, memory, mask, teacher, coins, drop)
    again = [tk.teacher_forced_train_fwd(*fargs, zmask, kernel_weights=kw)
             for _ in range(2)]
    before = tk.launches
    ev = [tk.teacher_forced_fwd(*fargs, kernel_weights=kw) for _ in range(2)]
    assert tk.launches == before + 2
    ev_p = tk.teacher_forced_fwd_plain(*fargs)
    torch.cuda.synchronize()
    _train_fwd_close(dict(zip(("frames", "stops", "align"), ev[0])),
                     dict(zip(("frames", "stops", "align"), ev_p)), wd)
    assert all(torch.equal(x, y) for x, y in zip(ev[0], ev[1]))
    assert all(torch.equal(x, y) for x, y in zip(again[0][:3], again[1][:3]))
    assert all(torch.equal(again[0][3][k], again[1][3][k])
               for k in tk.RES_NAMES)


# AdaIN's memory: the encoder's 512 states and its 128-wide speaker
# embedding
ADAIN_M = 640


@pytest.mark.parametrize("wd", ["bfloat16", "float32"])
def test_kernels_at_adain_memory_width(dev, wd):
    """The rows kernel (kernel 1's chain of launches), kernel 4a (train
    mode) and kernel 4b at AdaIN's 640-wide memory, against their plain
    versions, as the tests above hold them at M 48."""
    B, T, steps, K = 9, 24, 8, 4
    cfg, dp, keys, memory, mask, drop = _decoder_case(dev, B, T, steps,
                                                      wd=wd, mw=ADAIN_M)
    kw = dk.pack_weights(dp)
    assert kw.rows.cs == 16
    before = dk.rows_launches
    got = dk.decode(dp, cfg, keys, memory, mask, drop, steps=steps,
                    early_stop_block=K, kernel_weights=kw)
    assert dk.rows_launches == before + steps // K
    want = dk.decode_plain(dp, cfg, keys, memory, mask, drop, steps=steps,
                           early_stop_block=K)
    torch.cuda.synchronize()
    _close_decode(got, want)
    got, want, b_k, b_p, n, b_c, _ = _train_case(
        dev, B, T, 12, [1, 0, 0, 1, 1, 0] * 2, wd=wd, mw=ADAIN_M)
    assert n == (1, 1)
    fields = lambda o: dict(zip(("frames", "stops", "align"), o[:3]),
                            **{k: o[3][k] for k in tk.RES_NAMES})
    _train_fwd_close(fields(got), fields(want), wd)
    _bwd_close(b_k, b_p, b_c)


@pytest.mark.parametrize("variant", ["prenet_16_8", "emt_simple"])
def test_plain_route_runs_on_cuda_tensors(dev, variant):
    """A prenet other than (P, P) and emt_attn take the plain decode on the
    card: synthesis (the prenet), GTA and a train step run on CUDA tensors
    and launch no decode kernel (the rows kernel, decoder.cu, 4a, 4b)."""
    from tacotron2_tpu_torch import convert
    from tacotron2_tpu_torch.synth.tacotron_synth import TacotronSynthesizer
    from tacotron2_tpu_torch.train.tacotron_step import TacotronTrainer
    cfg = torch_cfg()
    cfg = cfg.replace(
        tacotron=dataclasses.replace(
            cfg.tacotron, embedding_dim=32, enc_conv_num_layers=2,
            enc_conv_channels=32, encoder_lstm_units=16,
            postnet_num_layers=2, postnet_channels=32,
            fused_train_dtype="float32",
            prenet_layers=(16, 8) if variant == "prenet_16_8" else (P, P)),
        gst=dataclasses.replace(
            cfg.gst, num_gst=4, num_heads=2, style_embed_depth=8,
            style_att_dim=8, reference_filters=(4, 4), reference_depth=8,
            n_emt=4, n_spk=3, emt_attn=variant == "emt_simple"))
    model = convert.init_tacotron(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    params, stats = convert.tacotron_to_flax(model)
    synth = TacotronSynthesizer(cfg, params, stats, device="cuda",
                                keep_intermediates=True)
    rng = np.random.default_rng(0)
    mels = [rng.uniform(-4, 4, (f, MELS)).astype(np.float32)
            for f in (24, 30)]
    counts = lambda: (dk.rows_launches, dk.launches, tk.launches,
                      tk.train_launches, tk.bwd_launches)
    before = counts()
    if variant == "prenet_16_8":
        out = synth.synthesize(["a b c.", "d e."], mels, mels, max_steps=6)
        assert synth.intermediates["route"] == "plain"
        assert synth.intermediates["memory"].is_cuda
        assert all(np.isfinite(m).all() for m in out["mels"])
    out = synth.synthesize(["a b c.", "d e."], mels, mels, mel_targets=mels,
                           gta=True)
    assert synth.intermediates["route"] == "teacher_forced_plain"
    assert synth.intermediates["memory"].is_cuda
    assert all(np.isfinite(m).all() for m in out["mels"])
    trainer = TacotronTrainer(cfg)
    state = trainer.init_state(model=model)
    batch = dict(
        inputs=rng.integers(2, 60, (2, 10)), input_lengths=np.array([10, 7]),
        mel_targets=np.stack([m[:24] for m in mels]),
        stop_token_targets=np.zeros((2, 24), np.float32),
        targets_lengths=np.array([24, 20]), emt_labels=np.array([0, 1]),
        spk_labels=np.array([1, 2]), ref_mel_emt=np.stack([m[:24] for m in
                                                           mels]),
        ref_mel_spk=np.stack([m[:24] for m in mels]))
    state, m = trainer.train_step(state, batch,
                                  torch.Generator(device=dev).manual_seed(0))
    assert next(state.model.parameters()).is_cuda
    assert np.isfinite(float(m["loss"]))
    assert counts() == before


@pytest.mark.parametrize("wd", ["bfloat16", "float32"])
@pytest.mark.parametrize("cs", [8, 16])
def test_train_bwd_reruns_bit_for_bit(dev, wd, cs):
    """Kernel 4b's sums go in a fixed order: a rerun gives the same bits,
    at either cluster size; and either size holds the plain version."""
    _, _, b_k, b_p, _, b_c, (bargs, kw) = _train_case(
        dev, 9, 24, 12, [1, 0, 0, 1, 1, 0] * 2, wd=wd)
    again = [tk.teacher_forced_bwd(*bargs, kernel_weights=kw, cs=cs)
             for _ in range(2)]
    torch.cuda.synchronize()
    for name in b_k:
        assert torch.equal(again[0][name], again[1][name]), name
    replay = again[0] if wd == "bfloat16" else None
    _bwd_close(again[0], tk.teacher_forced_bwd_plain(*bargs, replay=replay),
               None if replay is None else tk.teacher_forced_bwd_plain(
                   *bargs, round_gradients=False, replay=replay))


def test_train_bwd_envelope_holds_the_previous_kernel(dev):
    """Every (T_in, widths) kernel 4b took before its 8-row clusters (one
    8-CTA cluster a row: U and M multiples of 8, 4U/8 of 8, P and A of 8,
    and its shared-memory formula within 227 KB) `bwd_supported` still
    takes, at either cluster size where the widths split 16 ways, at T_in
    up to 640 and widths up to 4096 (the function says nothing of B: every
    B runs, in ceil(B/8) clusters)."""
    cfg = torch_cfg()

    def previous(T, mels, P, U, M, A, KW, FOp, r):
        Uc, Mc, Tc = U // 8, M // 8, -(-T // 8)
        floats = (FOp + 5 * T + 3 * A + 2 * KW * A + 4 * Tc * A + Tc * KW
                  + A + 2 * T + A + Uc + 2 * Mc + 4 * Uc + 2 * Uc + 4 * Uc
                  + 2 * U + (P + M + U) + 4 * P + mels + 32)
        return (U % 8 == 0 and M % 8 == 0 and (4 * U // 8) % 8 == 0
                and P % 8 == 0 and A % 8 == 0 and floats * 4 <= 232448)

    taken = missed = 0
    for T in (1, 24, 96, 200, 400, 560, 640):
        for U in (16, 64, 512, 1024, 2048, 4096):
            for M in (8, 48, 512, 1024, 1536):
                for P in (8, 256, 1024):
                    for A in (8, 128, 256):
                        for KW, mels, r in ((31, 80, 1), (7, 20, 2)):
                            FOp = -(-(r * mels + r) // 8) * 8
                            w = (T, mels, P, U, M, A, KW, FOp, r)
                            if not previous(*w):
                                continue
                            taken += 1
                            missed += not tk.bwd_supported(w, 8)
                            if U % 32 == 0 and M % 16 == 0:
                                missed += not tk.bwd_supported(w, 16)
    assert taken > 1000 and missed == 0, (taken, missed)


@pytest.mark.parametrize("route,n_fft", [("fft", 2048), ("dft", 2000)])
@pytest.mark.parametrize("iters", [0, 4])
def test_griffin_lim_kernel_matches_plain(dev, iters, route, n_fft):
    hop, win, B, F = 200, 800, 2, 33
    assert glk.route(n_fft) == route
    g = torch.Generator(dev).manual_seed(0)
    y = torch.randn(B, hop * (F - 1), generator=g, device=dev)
    S = tst.stft_mag(y, n_fft, hop, win)
    phase = torch.rand(S.shape, generator=g, device=dev) * 6.2831855
    for start, (re0, im0) in (
            ("zero-phase", (S, torch.zeros_like(S))),
            ("random-phase", (S * torch.cos(phase), S * torch.sin(phase)))):
        before = (glk.launches, glk.launches_fft, glk.launches_dft)
        y_k = glk.fused_griffin_lim(S, re0, im0, n_fft, hop, win, iters)
        fft = int(route == "fft")
        assert (glk.launches, glk.launches_fft, glk.launches_dft) == (
            before[0] + 1, before[1] + fft, before[2] + 1 - fft)
        y_p = glk.griffin_lim_plain(S, re0, im0, n_fft, hop, win, iters)
        torch.cuda.synchronize()
        assert y_k.shape == y_p.shape == (B, hop * (F - 1))
        # samples up to ~5: iters 0 is one iSTFT (f32 sums in another
        # order); after 4 iterations phases of bins near zero carry the
        # rounding noise forward
        np.testing.assert_allclose(
            y_k.cpu(), y_p.cpu(), rtol=0,
            atol=1e-4 if iters == 0 else GL_ITERS4_ATOL[start], err_msg=start)
        err = lambda x: float((tst.stft_mag(x.contiguous(), n_fft, hop, win)
                               - S).abs().mean())
        assert err(y_k) <= 1.01 * err(y_p), (err(y_k), err(y_p))


# R, G, S besides the default widths (R 128, G 256, S 128), each one the
# kernel before the 8-row clusters took too: a CTA's h units and residual
# columns 16 or 8 bytes a row, padded m-tiles; several m-tiles a CTA and
# fewer chain warps than m-tiles (R 256); weight slices too large for
# shared memory, read from global memory (R 512)
SAMPLER_WIDTHS = {"R64-G128-S64": (64, 128, 64), "R32-G64-S32": (32, 64, 32),
                  "R256-G512-S256": (256, 512, 256),
                  "R512-G1024-S512": (512, 1024, 512)}


@pytest.mark.parametrize("B,widths,wd", [
    *[(b, "default", torch.float32) for b in (1, 3, 8, 9)],
    *[(9, w, dt) for w in SAMPLER_WIDTHS
      for dt in (torch.float32, torch.bfloat16)]],
    ids=lambda v: str(v).replace("torch.", ""))
def test_sampler_kernel_matches_plain(dev, B, widths, wd):
    """B spans the kernel's 8-row clusters: one with missing rows, one
    full, two. f32 weights against the plain version; bf16 weights (at
    the other widths) against the plain version replaying the kernel's
    trajectory."""
    cfg = torch_cfg()
    if widths != "default":
        Rw, G, S = SAMPLER_WIDTHS[widths]
        cfg = cfg.replace(wavenet=dataclasses.replace(
            cfg.wavenet, residual_channels=Rw, gate_channels=G,
            skip_out_channels=S))
    wparams = sampler_tree(cfg)
    T = 64
    sp = extract_sampler_params(wparams, cfg, device=dev)
    g = torch.Generator(dev).manual_seed(2)
    c_up = torch.rand(B, T, MELS, generator=g, device=dev)
    z = torch.randn(B, T, generator=g, device=dev)
    kw = wk.pack_weights(sp, cfg, cache_dtype=wd, weight_dtype=wd)
    before = wk.launches
    y_k = wk.sample(sp, cfg, c_up, z, kernel_weights=kw)
    assert wk.launches == before + 1
    if wd == torch.float32:
        y_p = wk.sample_plain(sp, cfg, c_up, z)
        torch.cuda.synchronize()
        np.testing.assert_allclose(y_k.cpu(), y_p.cpu(), atol=1e-4, rtol=0)
        return
    y_r, _ = wk.teacher_forced_replay(sp, cfg, c_up, z, y_k, cache_dtype=wd,
                                      weight_dtype=wd)
    torch.cuda.synchronize()
    assert float(y_k.abs().max()) > 1e-2
    assert float((y_k - y_r).abs().max()) <= SAMPLER_REPLAY_ATOL[wd]


def test_sampler_envelope_holds_the_previous_kernels(dev):
    """Every width the sampler kernel took before its 8-row clusters (one
    cluster of 8 CTAs a row: G a multiple of 64, R and S of 32, (S + R)/8
    of 4, its taps [L, 3R + C] and vectors in 227 KB of shared memory, S
    and the head's columns in one pass of its 512 threads) it still takes,
    in both weight types, at R ≤ 1024, G ≤ 2048, S ≤ 2048."""
    lib = wk._lib()
    C, NO, n_out = 80, 4, 2

    def previous(L, R, G, S):
        gc, sc, rc = G // 16, S // 8, R // 8
        floats = (L * (3 * R + C) + R + G // 2 + 2 * gc + sc + rc + 3 * S
                  + NO + 4 + 512 * 4)
        return (G % 64 == 0 and S % 32 == 0 and R % 32 == 0
                and (S + R) // 8 % 4 == 0 and floats * 4 <= 232448
                and S // 4 <= 512)

    taken = missed = 0
    for L in (2, 8, 20, 30):
        for R in range(32, 1025, 32):
            for G in range(64, 2049, 64):
                for S in (32, 64, 96, 128, 256, 512, 1024, 2048):
                    if not previous(L, R, G, S):
                        continue
                    for wbf in (0, 1):
                        taken += 1
                        missed += not lib.taco_sampler_supported(
                            L, R, G, S, C, NO, n_out, 0, wbf)
    assert taken > 10000 and missed == 0, (taken, missed)


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("kind,cd,wd", [
    ("gaussian", BF16, BF16), ("gaussian", BF16, F32), ("mol", F32, F32),
    ("mol", BF16, BF16), ("categorical", F32, F32),
    ("categorical", BF16, BF16)],
    ids=lambda v: str(v).replace("torch.", "") if not isinstance(v, str)
    else v)
@pytest.mark.parametrize("B", [1, 3, 8, 9])
def test_sampler_kernel_heads_match_plain(dev, kind, cd, wd, B):
    cfg = head_cfg(kind)
    sp = extract_sampler_params(sampler_tree(cfg), cfg, device=dev)
    T = 64
    g = torch.Generator(dev).manual_seed(2)
    c_up = torch.rand(B, T, MELS, generator=g, device=dev)
    noise = draw_noise(cfg, B, T, g, dev)
    kw = wk.pack_weights(sp, cfg, cache_dtype=cd, weight_dtype=wd)
    before = wk.launches
    y_k = wk.sample(sp, cfg, c_up, noise, kernel_weights=kw)
    assert wk.launches == before + 1
    y_r, y_hat = wk.teacher_forced_replay(sp, cfg, c_up, noise, y_k,
                                          cache_dtype=cd, weight_dtype=wd)
    torch.cuda.synchronize()
    atol = SAMPLER_REPLAY_ATOL[wd]
    err = (y_k - y_r).abs()
    if kind == "gaussian":
        print(f"{kind} {cd}/{wd}: max |kernel - replay| {err.max():.3e}")
        assert float(err.max()) <= atol
        return
    nl = cfg.wavenet.out_channels // 3 if kind == "mol" else Q
    want = inverse_cdf_pick(y_hat[..., :nl].reshape(B * T, -1),
                            noise[0].reshape(-1)).reshape(B, T)
    # the kernel's draw is the plain version's: the same class, or for MoL
    # the sample of the component the plain logits pick (the same uniforms)
    same = (y_k == y_r) if kind == "categorical" else err <= atol
    ties = wk.pick_ties(y_hat[..., :nl], noise[0], 1e-5)
    moved = int((~same & ~ties).sum())
    print(f"{kind} {cd}/{wd}: {int((~same).sum())} draws differ ({moved} "
          f"off a tie), {int(ties.sum())} ties, "
          f"{len(torch.unique(want))} distinct picks; max |kernel - "
          f"replay| where they agree {float(err[same].max()):.3e}")
    assert moved <= (SAMPLER_BF16_MOVED * B * T if wd == BF16 else 0)
    assert len(torch.unique(want)) > 4
    assert float(err[same].max()) <= (atol if kind == "mol" else 0.0)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(dev):
    cfg = torch_cfg()                      # f32 decode weights
    tparams, wparams = decoder_tree(), sampler_tree(cfg)
    dp = dk.extract_decoder_params(tparams, cfg, device=dev)
    args = (torch.zeros(1, 4, A, device=dev), torch.zeros(1, 4, M, device=dev),
            torch.ones(1, 4, device=dev), torch.ones(1, 2, 2, P, device=dev))
    # weights of two types (the f32 ones with a bf16 projection); none
    # packed
    kw32 = dk.pack_weights(dp)
    mixed = kw32._replace(proj_w=kw32.proj_w.to(torch.bfloat16))
    for kw in (mixed, None):
        with pytest.raises(ValueError):
            dk.decode(dp, cfg, *args, steps=2, kernel_weights=kw)
    cfg_b = cfg.replace(tacotron=dataclasses.replace(
        cfg.tacotron, fused_decoder_dtype="bfloat16"))
    dp_b = dk.extract_decoder_params(tparams, cfg_b, device=dev)
    state = dk.init_decoder_state(cfg_b, 1, 4, M, dev)
    bad = state._replace(pmax=state.pmax.long())
    with pytest.raises(ValueError):
        dk.decode_block(dp_b, cfg_b, *args[:3], bad, args[3],
                        kernel_weights=dk.pack_weights(dp_b))
    # the teacher-forced kernel: weights of one type, packed weights, the
    # teacher [steps, B, mels], coins [steps]; no emt_attn, no smoothing
    tf_args = (args[0], args[1], args[2], torch.zeros(2, 1, MELS, device=dev),
               torch.ones(2, dtype=torch.int32), args[3])
    dp_t = tk.extract_params(tparams, cfg_b, device=dev)
    kw_t = dk.pack_weights(dp_t)
    with pytest.raises(ValueError):
        tk.teacher_forced_fwd(dp, cfg, *tf_args, kernel_weights=mixed)
    smooth = cfg_b.replace(tacotron=dataclasses.replace(cfg_b.tacotron,
                                                        smoothing=True))
    with pytest.raises(ValueError):
        tk.teacher_forced_fwd(dp_t, smooth, *tf_args, kernel_weights=kw_t)
    with pytest.raises(ValueError):
        tk.teacher_forced_fwd(dp_t, cfg_b, *tf_args)
    for i, bad in ((3, torch.zeros(2, 2, MELS, device=dev)),
                   (4, torch.ones(3, dtype=torch.int32))):
        with pytest.raises(ValueError):
            tk.teacher_forced_fwd(dp_t, cfg_b, *tf_args[:i], bad,
                                  *tf_args[i + 1:], kernel_weights=kw_t)
    emt = cfg_b.replace(gst=dataclasses.replace(cfg_b.gst, emt_attn=True))
    with pytest.raises(ValueError):
        tk.teacher_forced_fwd(dp_t, emt, *tf_args, kernel_weights=kw_t)
    S = torch.ones(1, 3, 100, device=dev)       # K is not n_fft//2+1
    with pytest.raises(ValueError):
        glk.fused_griffin_lim(S, S, S, 2048, 200, 800, 1)
    sp = extract_sampler_params(wparams, cfg, device=dev)
    c_up, z = torch.zeros(1, 8, MELS, device=dev), torch.zeros(1, 8, device=dev)
    with pytest.raises(ValueError):
        wk.sample(sp, cfg, c_up.double(), z,
                  kernel_weights=wk.pack_weights(sp, cfg))
    with pytest.raises(ValueError):
        wk.sample(sp, cfg, c_up, z)
    kw = wk.pack_weights(sp, cfg)
    for bad in (dict(cache_dtype=torch.bfloat16),      # packed for f32
                dict(weight_dtype=torch.float16)):
        with pytest.raises(ValueError):
            wk.sample(sp, cfg, c_up, z, kernel_weights=kw, **bad)
    with pytest.raises(ValueError):                    # two planes
        wk.sample(sp, cfg, c_up, torch.zeros(2, 1, 8, device=dev),
                  kernel_weights=kw)
    with pytest.raises(ValueError):
        wk.pack_weights(sp, cfg, cache_dtype=torch.float16)
    mol = head_cfg("mol")
    sp_m = extract_sampler_params(sampler_tree(mol), mol, device=dev)
    with pytest.raises(ValueError):                    # another head
        wk.sample(sp_m, mol, c_up, torch.zeros(2, 1, 8, device=dev),
                  kernel_weights=kw)
    # R = 120: not a whole number of the products' 16-deep k-tiles
    narrow = head_cfg("gaussian", residual_channels=120)
    sp_n = extract_sampler_params(sampler_tree(narrow), narrow, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError):
            wk.sample(sp_n, narrow, c_up, z, kernel_weights=wk.pack_weights(
                sp_n, narrow, cache_dtype=dt, weight_dtype=dt))


# kernels 5a and 5b against their plain versions. bf16 weights: the same
# bf16 operands, f32 sums in another order, which may move an isolated bf16
# rounding (of h, dy or a saved activation) by one step (~0.4%); those
# carry on through the residual path, so each output is held to 1e-2 of
# its largest value (chip_smoke.py's phase 19 gates at the r5 shapes). f32
# weights: nothing rounded but the saved activations, products as 3xTF32
# in another sum order: the skip sum within STACK_F32_FWD of max(1, its
# largest value), each gradient within STACK_F32_BWD of its largest value
# (chip_smoke.py's phase 21 gates)
STACK_RTOL = 1e-2
STACK_F32_FWD, STACK_F32_BWD = 1e-5, 1e-4
# R, G, S, cin, layers, stacks: the r5 widths, the JAX kernel tests', an
# uneven set (no width a multiple of a tile, G != 2R), a wide one
STACK_WIDTHS = {"r5": (128, 256, 128, 80, 4, 2),
                "jax-tests": (8, 16, 8, 10, 4, 2),
                "uneven": (24, 40, 16, 12, 3, 1),
                "wide": (256, 512, 256, 80, 4, 2)}


def _wavenet_stack_case(dev, B=4, T=300, widths="r5", wd="bfloat16",
                        acts="bfloat16", layers_stacks=None):
    from tacotron2_tpu_torch import convert
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    R, G, S, Ci, layers, stacks = STACK_WIDTHS[widths]
    if layers_stacks:
        layers, stacks = layers_stacks
    cfg = Config()
    cfg = cfg.replace(wavenet=dataclasses.replace(
        cfg.wavenet, layers=layers, stacks=stacks, residual_channels=R,
        gate_channels=G, skip_out_channels=S, cin_channels=Ci,
        compute_dtype=wd, use_fused_train_stack=True))
    m = convert.init_wavenet(cfg, torch.Generator().manual_seed(0), dev)
    sp = wtk.StackParams(*(t.detach() for t in wtk.extract_stack_params(
        m.residual_blocks, cfg)))
    g = torch.Generator(dev).manual_seed(1)
    x0 = torch.randn(B * T, R, generator=g, device=dev) * 0.5
    c2 = torch.rand(B * T, Ci, generator=g, device=dev)
    dskip = torch.randn(B * T, S, generator=g, device=dev)
    return cfg, wtk, wtk.make_plan(cfg, B, acts), sp, x0, c2, dskip


@pytest.mark.parametrize("acts", ["bfloat16", "float32"])
@pytest.mark.parametrize("wd", ["bfloat16", "float32"])
@pytest.mark.parametrize("widths", list(STACK_WIDTHS))
def test_wavenet_stack_kernels_match_plain(dev, widths, wd, acts):
    """Kernel 5a (skip sum, saved activations) and 5b (every weight
    gradient, dx0, dc) against stack_fwd_plain / stack_bwd_plain, dropout
    0.05 from one seed, per weight type, saved-activation type and width
    set; a rerun is bit-exact; each wrapper counts its call."""
    _hold_stack(*_wavenet_stack_case(dev, widths=widths, wd=wd, acts=acts),
                wd, acts)


def _hold_stack(cfg, wtk, plan, sp, x0, c2, dskip, wd, acts):
    """Both kernels against their plain versions at one case; a backward
    rerun is bit-exact; each wrapper counts its call, the forward a
    pre-pass and one kernel launch a layer, the backward at most 4 a
    layer."""
    n0 = (wtk.fwd_launches, wtk.bwd_launches, wtk.bwd_kernel_launches,
          wtk.fwd_kernel_launches)
    ks, ka = wtk.stack_fwd_cuda(plan, sp, x0, c2, 7)
    ps, pa = wtk.stack_fwd_plain(plan, sp, x0, c2, 7)
    kb = wtk.stack_bwd_cuda(plan, sp, ka, c2, dskip, 7)
    pb = wtk.stack_bwd_plain(plan, sp, ka, c2, dskip, 7)
    again = wtk.stack_bwd_cuda(plan, sp, ka, c2, dskip, 7)
    torch.cuda.synchronize()
    assert (wtk.fwd_launches - n0[0], wtk.bwd_launches - n0[1]) == (1, 2)
    per_layer = (wtk.bwd_kernel_launches - n0[2]) / (2 * plan.L)
    assert per_layer <= 4, per_layer
    assert wtk.fwd_kernel_launches - n0[3] == plan.L + 1
    assert ka.dtype == pa.dtype and ka.shape == pa.shape
    rel = lambda a, b: float((a - b).abs().max()) / float(b.abs().max())
    scale = lambda b: max(1.0, float(b.abs().max()))
    if wd == "bfloat16":
        fwd_tol, bwd_tol = STACK_RTOL * float(ps.abs().max()), STACK_RTOL
    else:
        fwd_tol, bwd_tol = STACK_F32_FWD * scale(ps), STACK_F32_BWD
    assert float((ks - ps).abs().max()) <= fwd_tol
    # saved activations: bf16 weights as phase 19 reads them; f32 weights
    # one bf16 step of their scale, or f32 sum order
    if wd == "bfloat16":
        act_tol = 2 ** -6
    else:
        act_tol = (2 ** -7 if acts == "bfloat16" else 1e-5) * scale(
            pa.float())
    assert float((ka.float() - pa.float()).abs().max()) <= act_tol
    for name, a, b in zip(list(wtk.StackParams._fields) + ["dx0", "dc"],
                          [*kb[0], kb[1], kb[2]], [*pb[0], pb[1], pb[2]]):
        assert a.shape == b.shape, name
        assert rel(a, b) <= bwd_tol, name
    for a, b in zip([*kb[0], kb[1], kb[2]], [*again[0], again[1], again[2]]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wd", ["bfloat16", "float32"])
@pytest.mark.parametrize("B", [1, 3, 16])
def test_wavenet_stack_rows_and_dilations(dev, B, wd):
    """The stack kernels at B 1, 3 and 16 with N = B·1,007 rows (not a
    multiple of the 128-row tile) and 16 layers in 2 stacks, whose top
    dilation shifts the taps 2·128·B rows, past a tile: against the plain
    versions as above, bit-exact reruns, at most 4 launches a backward
    layer."""
    _hold_stack(*_wavenet_stack_case(dev, B=B, T=1007, wd=wd,
                                     layers_stacks=(16, 2)), wd, "bfloat16")


# The stack kernels' mainloop alone against torch.matmul (a yardstick in a
# test only, TF32 off) at the r5 backward's shapes, N = 128,000 rows: dh =
# go [N, 256] · W_os [128, 256]ᵀ (K-major on the ring) and the tap and cin
# weight gradients Σ_r P[r]ᵀ·Q[r + 2·512·16] (MN-major, 13 row splits
# summed in a fixed order). bf16 operands are exact in f32, so the two
# differ in sum order only; f32 runs as 3xTF32 (each product ~2^-22 of
# itself off) in another order: max |d| within these shares of max |ref|.
MAINLOOP_RTOL = {"kmajor": 1e-5, "wgrad": 1e-4}


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_stack_mainloop_matches_matmul(dev, dt):
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(dev).manual_seed(5)
    N, shift = 128_000, 2 * 512 * 16
    a = torch.randn(N, 256, generator=g, device=dev).to(dt)
    b = torch.randn(128, 256, generator=g, device=dev).to(dt)
    got = wtk.mainloop_product(a, b)
    want = a.float() @ b.float().t()
    torch.cuda.synchronize()
    rel = lambda x, y: float((x - y).abs().max()) / float(y.abs().max())
    assert rel(got, want) <= MAINLOOP_RTOL["kmajor"]
    q = torch.randn(N, 256, generator=g, device=dev).to(dt)
    for K1 in (128, 80):
        p = torch.randn(N, K1, generator=g, device=dev).to(dt)
        got = wtk.wgrad_product(p, q, shift, 13)
        want = p[:N - shift].float().t() @ q[shift:].float()
        torch.cuda.synchronize()
        assert got.shape == (K1, 256)
        assert rel(got, want) <= MAINLOOP_RTOL["wgrad"], K1


@pytest.mark.parametrize("wd", ["bfloat16", "float32"])
def test_wavenet_train_step_takes_the_kernels(dev, wd):
    """A train step with the gate open (CUDA, use_fused_train_stack)
    launches kernels 5a and 5b in either weight type, and its gradients
    agree with the layer loop's (the gate closed) at dropout 0: cosine >=
    0.999."""
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer
    cfg, *_ = _wavenet_stack_case(dev, wd=wd)
    cfg = cfg.replace(wavenet=dataclasses.replace(cfg.wavenet, dropout=0.0),
                      audio=dataclasses.replace(cfg.audio, hop_size=200))
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 0.5, (2, 2000, 1)).astype(np.float32)
    batch = dict(x=x, y=x[..., 0], c=rng.uniform(0, 1, (2, 10, 80)).astype(
        np.float32), input_lengths=np.full(2, 2000, np.int32))
    grads = []
    for fused in (True, False):
        c = cfg.replace(wavenet=dataclasses.replace(
            cfg.wavenet, use_fused_train_stack=fused))
        tr = WaveNetTrainer(c)
        state = tr.init_state(torch.Generator().manual_seed(0), batch)
        n0 = (wtk.fwd_launches, wtk.bwd_launches)
        _, _, gr = tr.gradients(state, batch, seed=3)
        torch.cuda.synchronize()
        n = (wtk.fwd_launches - n0[0], wtk.bwd_launches - n0[1])
        assert n == ((1, 1) if fused else (0, 0))
        grads.append(torch.cat([t.flatten() for t in gr]))
    cos = torch.nn.functional.cosine_similarity(grads[0], grads[1], dim=0)
    assert float(cos) >= 0.999
