"""The port's Tacotron_emt_attn decode, emt_only and use_gst=False against
the JAX package's, on the CPU.

Same inputs from numpy seeds and the same flax weights into both
packages, at small widths and `tacotron.dropout_rate=0` (as
tests/test_decoder_kernel.py:290,396 hold the TPU block kernel's emt
scorers). The JAX side runs as its own tests run it: the block kernel
`build_decoder_block_kernel(..., emt_T=Te, weight_dtype=f32,
interpret=True)`, the flax scan `Decoder.autoregressive`, the JAX
synthesizer's CPU routes and `TextToWavProgram(interpret=True)`; the port
runs its kernels' plain versions. Tolerances: against the block kernel
frames atol 2e-4, stop probabilities 2e-5, every carried state field
(context_emt too) 2e-4 and alignments 8e-3 (that kernel stores them in
bf16), tests/test_torch_decoder.py's; against the flax scan frames 3e-4
and stops 3e-5 (tests/test_decoder_kernel.py:342-345) and alignments 1e-4
(both f32); the memory pass's five outputs 1e-5 (f32 convolutions and
GRUs in another sum order, ~3e-7 seen); synthesis and the program as
tests/test_torch_synth.py and tests/test_torch_pipeline.py hold them (mels
atol 2e-4 / rtol 1e-3, stops 2e-5, alignments 1e-4, samples atol 2e-3 /
rtol 1e-2). The converter's round trip is exact.

The simple variant's decoder feeds the 128-wide speaker embedding into
LSTM1 through reference_depth rows in the JAX kernel's extraction
(tacotron_decoder_kernel.py:113), so the cases with ref_spk run at
reference_depth 128; the others at 8.
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.tacotron.decoder import Decoder
from tacotron2_tpu.models.tacotron.model import Tacotron as JaxTacotron
from tacotron2_tpu.models.tacotron.modules import \
    ReferenceEncoder as JaxReferenceEncoder
from tacotron2_tpu.ops.tacotron_decoder_kernel import (
    build_decoder_block_kernel, extract_decoder_params, init_decoder_state)
from tacotron2_tpu.synth.pipeline import TextToWavProgram as JaxProgram
from tacotron2_tpu.synth.tacotron_synth import \
    TacotronSynthesizer as JaxSynthesizer
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.models.tacotron import decoder as tdec
from tacotron2_tpu_torch.models.tacotron.modules import ReferenceEncoder
from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
from tacotron2_tpu_torch.synth.tacotron_synth import TacotronSynthesizer
from torch_port_helpers import (B, MELS, STEPS, T_IN, T_REF, flax_weights,
                                inputs, small_cfg, to_numpy, torch_cfg)

B2, T2, M2, TE, K = 2, 20, 32, 3, 3

# decode cases: (emt_attn_type, reference_depth, with ref_spk, emt_only)
DECODE = {"simple": ("simple", 128, True, False),
          "simple-emt_only": ("simple", 8, False, True),
          "multihead": ("multihead", 8, True, False),
          "style_tokens": ("style_tokens", 8, True, False)}
# model cases: (gst overrides, emt_only)
MODELS = {
    "simple": (dict(emt_attn=True, emt_attn_type="simple",
                    reference_depth=128), False),
    "multihead": (dict(emt_attn=True, emt_attn_type="multihead",
                       reference_depth=128), False),
    "style_tokens": (dict(emt_attn=True, emt_attn_type="style_tokens",
                          reference_depth=128), False),
    "multihead-gru_multi": (dict(emt_attn=True, emt_attn_type="multihead",
                                 emt_ref_gru="gru_multi"), False),
    "simple-emt_only": (dict(emt_attn=True, emt_attn_type="simple"), True),
    "emt_only": ({}, True),
    "no-gst": (dict(use_gst=False), False),
}


def _gst(cfg, **gst):
    return cfg.replace(gst=dataclasses.replace(cfg.gst, **gst))


def _decode_cfgs(kind, depth):
    gst = dict(emt_attn=True, emt_attn_type=kind, reference_depth=depth)
    return _gst(small_cfg(), **gst), _gst(torch_cfg(), **gst)


@pytest.fixture(scope="module", params=list(DECODE))
def decode_case(request):
    """A flax emt decoder and its inputs: (name, cfgs, params, keys,
    memory, mask, emt_memory, ref_spk, labels)."""
    kind, depth, with_ref, emt_only = DECODE[request.param]
    cfg, cfg_t = _decode_cfgs(kind, depth)
    rng = np.random.default_rng(5)
    f = lambda *s, sc=0.4: (rng.normal(size=s) * sc).astype(np.float32)
    memory, keys = f(B2, T2, M2), f(B2, T2, cfg.tacotron.attention_dim, sc=0.3)
    mask = np.arange(T2)[None, :] < np.asarray([T2, T2 - 5])[:, None]
    emt_memory = f(B2, TE, 2 * depth)
    ref_spk = f(B2, 128) if with_ref else None
    labels = np.asarray([1, 3]) if kind == "style_tokens" else None
    onehot = (None if labels is None
              else jax.nn.one_hot(jnp.asarray(labels), cfg.gst.n_emt))
    dec = Decoder(config=cfg)
    params = to_numpy(dec.init(
        dict(params=jax.random.PRNGKey(3), dropout=jax.random.PRNGKey(1),
             zoneout=jax.random.PRNGKey(2)),
        B2, 2 * K, jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask),
        emt_memory=jnp.asarray(emt_memory),
        ref_spk=None if ref_spk is None else jnp.asarray(ref_spk),
        labels=onehot, method=Decoder.autoregressive)["params"])
    return (request.param, emt_only, cfg, cfg_t, params, keys, memory, mask,
            emt_memory, ref_spk, labels, onehot)


def _port_operands(cfg_t, params, emt_only, emt_memory, ref_spk, labels):
    tree = {"decoder": params}
    dp = dk.extract_decoder_params(tree, cfg_t, device="cpu",
                                   emt_only=emt_only)
    ep = dk.extract_emt_params(tree, cfg_t, device="cpu", emt_only=emt_only)
    t = lambda x: None if x is None else torch.as_tensor(x)
    return dp, tdec.emt_operands(ep, cfg_t, t(emt_memory), t(ref_spk),
                                 t(labels))


def test_plain_emt_blocks_match_tpu_block_kernel(decode_case):
    """(a) `decode_block_plain` under emt_attn against the TPU block kernel
    with its in-kernel scorers, block by block from the zero state: the
    outputs and every carried state field, context_emt too. style_tokens
    has no kernel (the JAX package scans it): (b) holds it."""
    (name, emt_only, cfg, cfg_t, params, keys, memory, mask, emt_memory,
     ref_spk, labels, _) = decode_case
    if name == "style_tokens":
        assert dk.extract_emt_params({"decoder": params}, cfg_t,
                                     device="cpu").mh_out_w is None
        return
    run = build_decoder_block_kernel(cfg, B2, T2, K, M2,
                                     weight_dtype=jnp.float32, emt_T=TE,
                                     interpret=True)
    dp_j = extract_decoder_params({"decoder": params}, cfg,
                                  emt_only=emt_only)
    st_j = init_decoder_state(cfg, B2, T2, M2)
    dp, emt = _port_operands(cfg_t, params, emt_only, emt_memory, ref_spk,
                             labels)
    st_t = dk.init_decoder_state(cfg_t, B2, T2, M2, device="cpu")
    assert st_t.ctx_emt.shape == st_j.ctx_emt.shape
    drop = tdec.drop_masks(cfg_t, B2, K, device="cpu")
    mels = cfg.audio.num_mels
    for blk in range(2):
        f_j, s_j, a_j, st_j = run(
            dp_j, jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask),
            st_j, 3 + blk, jnp.asarray(emt_memory),
            None if ref_spk is None else jnp.asarray(ref_spk))
        f_t, s_t, a_t, st_t = dk.decode_block_plain(
            dp, cfg_t, torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask), st_t, drop, emt)
        np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=0, atol=2e-4)
        np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=2e-5)
        np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=0, atol=8e-3)
        want = dict(xprev=np.asarray(st_j.xprev)[:, :mels],
                    c1=st_j.c1, h1=st_j.h1, c2=st_j.c2, h2=st_j.h2,
                    ctx=st_j.ctx, cum=np.asarray(st_j.cum)[:, :T2],
                    ctx_emt=st_j.ctx_emt)
        for key, w in want.items():
            np.testing.assert_allclose(getattr(st_t, key), np.asarray(w),
                                       rtol=0, atol=2e-4, err_msg=key)
        np.testing.assert_array_equal(st_t.pmax, np.asarray(st_j.pmax)[:, 0])
    assert float(st_t.ctx_emt.abs().max()) > 1e-2


def test_plain_emt_decode_matches_flax_scan(decode_case):
    """(b) the plain emt decode, two chained blocks, against flax
    `Decoder.autoregressive` with emt_memory, ref_spk and the labels."""
    (name, emt_only, cfg, cfg_t, params, keys, memory, mask, emt_memory,
     ref_spk, labels, onehot) = decode_case
    f_j, s_j, a_j, _ = Decoder(config=cfg).apply(
        {"params": params}, B2, 2 * K, jnp.asarray(keys),
        jnp.asarray(memory), jnp.asarray(mask),
        emt_memory=jnp.asarray(emt_memory),
        ref_spk=None if ref_spk is None else jnp.asarray(ref_spk),
        labels=onehot, method=Decoder.autoregressive,
        rngs=dict(dropout=jax.random.PRNGKey(7),
                  zoneout=jax.random.PRNGKey(8)))
    dp, emt = _port_operands(cfg_t, params, emt_only, emt_memory, ref_spk,
                             labels)
    drop = tdec.drop_masks(cfg_t, B2, 2 * K, device="cpu")
    f_t, s_t, a_t = dk.decode_plain(
        dp, cfg_t, torch.as_tensor(keys), torch.as_tensor(memory),
        torch.as_tensor(mask), drop, steps=2 * K, early_stop_block=K,
        emt=emt)
    np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=0, atol=3e-4)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=3e-5)
    np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=0, atol=1e-4)
    if name == "style_tokens":       # another label moves the frames
        emt2 = tdec.emt_operands(
            dk.extract_emt_params({"decoder": params}, cfg_t, device="cpu"),
            cfg_t, torch.as_tensor(emt_memory), torch.as_tensor(ref_spk),
            torch.as_tensor([0, 2]))
        f2 = dk.decode_plain(dp, cfg_t, torch.as_tensor(keys),
                             torch.as_tensor(memory), torch.as_tensor(mask),
                             drop, steps=2 * K, emt=emt2)[0]
        assert float((f2 - f_t).abs().max()) > 1e-4


def test_emt_decode_needs_its_operands(decode_case):
    """An emt decode wants both the operands and state.ctx_emt; the
    style_tokens variant wants its labels."""
    (name, emt_only, _, cfg_t, params, keys, memory, mask, emt_memory,
     ref_spk, labels, _) = decode_case
    dp, emt = _port_operands(cfg_t, params, emt_only, emt_memory, ref_spk,
                             labels)
    st = dk.init_decoder_state(cfg_t, B2, T2, M2, device="cpu")
    args = (dp, cfg_t, torch.as_tensor(keys), torch.as_tensor(memory),
            torch.as_tensor(mask))
    drop = tdec.drop_masks(cfg_t, B2, 1, device="cpu")
    with pytest.raises(ValueError):
        dk.decode_block_plain(*args, st, drop)
    with pytest.raises(ValueError):
        dk.decode_block_plain(*args, st._replace(ctx_emt=None), drop, emt)
    if name == "style_tokens":
        ep = dk.extract_emt_params({"decoder": params}, cfg_t, device="cpu")
        with pytest.raises(ValueError, match="labels"):
            tdec.emt_operands(ep, cfg_t, torch.as_tensor(emt_memory))


@pytest.mark.parametrize("mode", ["gru", "gru_multi", "none"])
def test_reference_encoder_all_outputs_matches_flax(mode):
    """(c) `ReferenceEncoder(all_outputs=True)` in each `emt_ref_gru` mode
    against flax apply, BatchNorm statistics away from (0, 1)."""
    cfg = small_cfg()
    gst = cfg.gst
    refs = inputs()[2]
    enc = JaxReferenceEncoder(tuple(gst.reference_filters),
                              gst.reference_depth, all_outputs=True,
                              emt_ref_gru=mode)
    v = to_numpy(enc.init(jax.random.PRNGKey(4), jnp.asarray(refs),
                          train=False))
    rng = np.random.default_rng(2)
    for bn in v["batch_stats"].values():
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    want = np.asarray(enc.apply(v, jnp.asarray(refs), train=False))
    port = ReferenceEncoder(MELS, tuple(gst.reference_filters),
                            gst.reference_depth, all_outputs=True,
                            emt_ref_gru=mode)
    for name, p in port.named_parameters():
        name = f"refnet_emt.{name}"
        path = convert.flax_path(name).split("/", 1)[1]
        with torch.no_grad():
            p.copy_(torch.as_tensor(convert.from_flax_array(
                name, convert.tree_get(v["params"], path))))
    for name, b in port.named_buffers():
        path = convert.flax_path(f"refnet_emt.{name}").split("/", 1)[1]
        b.copy_(torch.as_tensor(convert.tree_get(v["batch_stats"], path)))
    with torch.no_grad():
        got = port(torch.as_tensor(refs)).numpy()
    assert got.shape == want.shape and got.shape[-1] == port.out_width
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@lru_cache(maxsize=None)
def flax_model(name, pin_stop=-30.0):
    """(JAX config, port config, emt_only, params, batch_stats) of a small
    flax Tacotron of `MODELS[name]`, the stop projection pinned and the
    BatchNorm statistics drawn away from (0, 1)."""
    gst, emt_only = MODELS[name]
    cfg = _gst(small_cfg(), **gst)
    ids, lengths, refs = inputs()
    v = JaxTacotron(config=cfg, emt_only=emt_only).init(
        dict(params=jax.random.PRNGKey(0), dropout=jax.random.PRNGKey(1),
             zoneout=jax.random.PRNGKey(2),
             teacher_forcing=jax.random.PRNGKey(3)),
        jnp.asarray(ids), jnp.asarray(lengths), ref_mel_emt=refs,
        ref_mel_spk=refs, synthesis=True, max_steps=STEPS, train=False)
    params, stats = to_numpy(v["params"]), to_numpy(v["batch_stats"])
    rng = np.random.default_rng(7)

    def jitter(t):
        for k, x in t.items():
            if isinstance(x, dict):
                jitter(x)
            elif k == "mean":
                t[k] = (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
            elif k == "var":
                t[k] = (x * rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
    jitter(stats)
    sp = params["decoder"]["cell"]["stop_projection"]["Dense_0"]
    sp["bias"] = np.full_like(sp["bias"], pin_stop)
    return cfg, _gst(torch_cfg(), **gst), emt_only, params, stats


@pytest.mark.parametrize("name", list(MODELS))
def test_synthesis_memory_ext_matches_flax(name):
    """(d) the memory pass's five outputs (keys, memory, mask, emt_memory,
    ref_spk) under each emt_attn type, emt_only and use_gst=False."""
    cfg, cfg_t, emt_only, params, stats = flax_model(name)
    ids, lengths, refs = inputs()
    want = JaxTacotron(config=cfg, emt_only=emt_only).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(ids),
        jnp.asarray(lengths), refs, refs,
        method=JaxTacotron.synthesis_memory_ext)
    taco = convert.tacotron_from_flax(cfg_t, params, stats, "cpu",
                                      emt_only=emt_only)
    got = taco.synthesis_memory_ext(
        torch.as_tensor(ids).long(), torch.as_tensor(lengths).long(),
        torch.as_tensor(refs), torch.as_tensor(refs))
    assert got[1].shape[-1] == taco.memory_width
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, i
            continue
        assert tuple(g.shape) == tuple(w.shape), i
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=1e-5, err_msg=str(i))
    assert (got[3] is None) == (not cfg.gst.emt_attn)
    assert (got[4] is None) == (not cfg.gst.emt_attn or emt_only)


@pytest.mark.parametrize("name", list(MODELS))
def test_converter_round_trip_per_variant(name):
    """(g) flax -> port -> flax is the identity for every variant, and
    `init_tacotron` draws a tree of the same paths and shapes."""
    _, cfg_t, emt_only, params, stats = flax_model(name)
    taco = convert.tacotron_from_flax(cfg_t, params, stats, "cpu",
                                      emt_only=emt_only)
    p2, s2 = convert.tacotron_to_flax(taco)

    def leaves(t, pre=""):
        out = {}
        for k, x in t.items():
            out.update(leaves(x, f"{pre}{k}/") if isinstance(x, dict)
                       else {pre + k: np.asarray(x)})
        return out
    for a, b in ((leaves(params), leaves(p2)), (leaves(stats), leaves(s2))):
        assert set(a) == set(b), set(a) ^ set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    fresh = convert.tacotron_to_flax(convert.init_tacotron(
        cfg_t, torch.Generator().manual_seed(0), "cpu", emt_only=emt_only))[0]
    shapes = lambda t: {k: v.shape for k, v in leaves(t).items()}
    assert shapes(fresh) == shapes(params)


SHORT = ["hello there.", "a b c d e.", "ok."]
TACO = dict(early_stop_block=4, fused_block_steps=4, max_iters=STEPS)


def _synth_cfg(cfg, **taco):
    return cfg.replace(tacotron=dataclasses.replace(
        cfg.tacotron, **dict(TACO, **taco)))


@pytest.mark.parametrize("name,route,labels,early", [
    ("simple", "block", None, 4), ("multihead", "block", None, 4),
    ("style_tokens", "plain", [1, 3, 2], 4), ("style_tokens", "plain", None, 4),
    ("simple", "fused", None, 0), ("simple-emt_only", "block", None, 4)])
def test_synthesize_emt_matches_jax(name, route, labels, early):
    """(e) `TacotronSynthesizer.synthesize` under emt_attn against the JAX
    synthesizer on the CPU (its scan-block route, or for style_tokens and
    without an early stop its one-shot scan): the port's block route, the
    chain without an early stop, and style_tokens through the plain
    version with the labels (label 0 without them)."""
    cfg, cfg_t, emt_only, params, stats = flax_model(name)
    cfg, cfg_t = (_synth_cfg(c, early_stop_block=early) for c in (cfg, cfg_t))
    refs = list(inputs()[2][:3])
    js = JaxSynthesizer(cfg, params, stats,
                        model=JaxTacotron(config=cfg, emt_only=emt_only))
    ts = TacotronSynthesizer(cfg_t, params, stats, device="cpu",
                             keep_intermediates=True, emt_only=emt_only)
    want = js.synthesize(SHORT, refs, refs, emt_labels=labels)
    got = ts.synthesize(SHORT, refs, refs, emt_labels=labels)
    assert ts.intermediates["route"] == route
    assert ts.intermediates["emt"] is not None
    assert got["lengths"] == want["lengths"] == [STEPS * 2] * 3
    s_t, s_j = got["stop_tokens"], np.asarray(want["stop_tokens"])
    np.testing.assert_allclose(s_t[:, :s_j.shape[1]], s_j, rtol=0, atol=2e-5)
    for a, b in zip(got["mels"], want["mels"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-4)
    for a, b in zip(got["alignments"], want["alignments"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_gta_embed_and_program_refuse_emt_attn():
    """TextToWavProgram (as the JAX program) refuses emt_attn, naming it;
    GTA and embed, which once refused it too, now run it through the plain
    teacher-forced decode (their parity with JAX:
    tests/test_torch_variant_routes.py)."""
    cfg, cfg_t, _, params, stats = flax_model("multihead")
    ts = TacotronSynthesizer(cfg_t, params, stats, device="cpu")
    mel = np.zeros((8, MELS), np.float32)
    got = ts.synthesize(["ok."], [mel], [mel], mel_targets=[mel], gta=True)
    assert np.isfinite(got["mels"][0]).all()
    assert got["alignments_emt"][0].shape[0] == 1      # multihead: zeros
    emb = ts.embed(["ok."], [mel])
    assert np.isfinite(emb["emb_mo_emt"]).all()
    with pytest.raises(ValueError, match="emt_attn"):
        TextToWavProgram(cfg_t, params, stats, None, batch=B, steps=STEPS,
                         t_in=T_IN, device="cpu", vocoder="griffin_lim")


@pytest.mark.parametrize("name", ["no-gst", "emt_only"])
def test_program_without_gst_or_speaker_matches_jax(name):
    """(f) `TextToWavProgram` under use_gst=False (the `paper` preset's
    memory: the raw reference embeddings, M = encoder + 2·128) and with
    emt_only, against the JAX program: samples, mel and stops."""
    cfg, cfg_t, emt_only, params, stats = flax_model(name)
    wparams = flax_weights()[2]
    jp = JaxProgram(cfg, params, stats, wparams, batch=B, steps=STEPS,
                    t_in=T_IN, t_ref=T_REF, taco_chunk=2, upsample_chunk=2,
                    interpret=True, emt_only=emt_only)
    tp = TextToWavProgram(cfg_t, params, stats, wparams, batch=B,
                          steps=STEPS, t_in=T_IN, t_ref=T_REF, device="cpu",
                          emt_only=emt_only)
    ids, lengths, refs = inputs()
    want = [np.asarray(x) for x in jp(ids, lengths, refs, refs)]
    got = [x.numpy() for x in tp(ids, lengths, refs, refs)]
    enc = 2 * cfg.tacotron.encoder_lstm_units
    assert tp.memory_width == enc + (2 * 128 if name == "no-gst"
                                     else cfg.gst.style_embed_depth)
    for i in (1, 4):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[2], want[2], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got[3], want[3], atol=2e-5, rtol=0)
    assert np.abs(want[0]).max() > 1e-3
    np.testing.assert_allclose(got[0], want[0], atol=2e-3, rtol=1e-2)
