"""The routes of the Tacotron variants the port once refused, and their
synthesis modes against the JAX package's, on the CPU.

The route of each config (`teacher_forced_route`, the synthesizer's
`plain_synthesis`) and that the model's forward reaches the fused
teacher-forced decode only on the kernel route; the plain decode with
prenets (16, 8) and (16, 16, 16) against the JAX synthesizer's scan, free
running and GTA; AdaIN synthesis and GTA; emt_attn GTA (with its
alignments) and `embed` for simple, multihead and style_tokens, and
AdaIN's; two emt_attn train steps (the file's one jitted JAX step); and
where the JAX package itself raises (style_embs under AdaIN and emt_attn,
the unpaired pass under emt_attn with the speaker embedding in LSTM1 or
the model's own emotion head on the unpaired output), the port raises
too.

Weights: `convert.init_tacotron` at tests/torch_port_helpers.py's small
widths (dropout 0, f32 decode weights), the stop projection's bias pinned
to -30 so no row stops early, handed to both packages as numpy trees.
Tolerances are tests/test_torch_gta.py's: mels atol 2e-4 / rtol 1e-3,
alignments 1e-4, stop logits 2e-4 (probabilities 2e-5), embeddings 1e-4;
the train steps' as tests/test_torch_train_step.py's.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import ScopeParamShapeError

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model_variants import (SMALL_CBHG, leaves,  # noqa: E402
                                       variant_cfgs)
from test_torch_synth import _cfg  # noqa: E402
from test_torch_train_step import (PARAM_ATOL, _close, _to_np,  # noqa: E402
                                   batch4, cfgs)

from tacotron2_tpu.models.tacotron.model import Tacotron as JaxTacotron
from tacotron2_tpu.synth import tacotron_synth as jts
from tacotron2_tpu.train.tacotron_step import TacotronTrainer as JaxTrainer
from tacotron2_tpu.train.tacotron_step import TrainState
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.models.tacotron.decoder import teacher_forced_route
from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
from tacotron2_tpu_torch.synth import tacotron_synth as tts
from tacotron2_tpu_torch.train.tacotron_step import TacotronTrainer
from torch_port_helpers import MELS, inputs, small_cfg, torch_cfg

TEXTS = ["hello there.", "a b c d e.", "ok."]
TARGET_FRAMES = (37, 50, 23)
LABELS = [1, 3, 0]
# config: (section, overrides) -> (teacher-forced route, plain synthesis)
ROUTES = {
    "default": ((None, {}), ("kernel", False)),
    "smoothing": (("tacotron", dict(smoothing=True)), ("plain", False)),
    "adain": (("gst", dict(adain=True)), ("kernel", False)),
    "se_concat_false": (("gst", dict(se_concat=False)), ("kernel", False)),
    "predict_linear": (("tacotron", dict(predict_linear=True,
                                         **SMALL_CBHG)), ("kernel", False)),
    "prenet_16_8": (("tacotron", dict(prenet_layers=(16, 8))),
                    ("plain", True)),
    "prenet_16_16_16": (("tacotron", dict(prenet_layers=(16, 16, 16))),
                        ("plain", True)),
    "emt_simple": (("gst", dict(emt_attn=True, emt_attn_type="simple")),
                   ("plain", False)),
    "emt_multihead": (("gst", dict(emt_attn=True,
                                   emt_attn_type="multihead")),
                      ("plain", False)),
    "emt_style_tokens": (("gst", dict(emt_attn=True,
                                      emt_attn_type="style_tokens")),
                         ("plain", True)),
}


def _over(cfg, name):
    sec, over = ROUTES[name][0]
    if sec is None:
        return cfg
    return cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec),
                                                   **over)})


def _weights(cfg_t, pin_stop=-30.0):
    m = convert.init_tacotron(cfg_t, torch.Generator().manual_seed(0), "cpu")
    params, stats = convert.tacotron_to_flax(m)
    sp = params["decoder"]["cell"]["stop_projection"]["Dense_0"]
    sp["bias"] = np.full_like(sp["bias"], pin_stop)
    return params, stats


def synths(name, pin_stop=-30.0):
    """(JAX synthesizer, port synthesizer) of one config at the small
    widths with the synthesizer tests' audio and early-stop settings."""
    cfg_j, cfg_t = (_over(_cfg(c), name) for c in (small_cfg, torch_cfg))
    over = dict(fused_train_dtype="float32")
    cfg_j, cfg_t = (c.replace(tacotron=dataclasses.replace(c.tacotron,
                                                           **over))
                    for c in (cfg_j, cfg_t))
    params, stats = _weights(cfg_t, pin_stop)
    return (jts.TacotronSynthesizer(cfg_j, params, stats),
            tts.TacotronSynthesizer(cfg_t, params, stats, device="cpu",
                                    keep_intermediates=True))


def _refs(n):
    refs = inputs()[2]
    return [refs[i % len(refs)] for i in range(n)]


def _mels(frames, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-4, 4, (f, MELS)).astype(np.float32) for f in frames]


def _synth_close(got, want, stop_atol):
    assert got["lengths"] == list(want["lengths"])
    for g, w in zip(got["mels"], want["mels"]):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4, rtol=1e-3)
    for g, w in zip(got["alignments"], want["alignments"]):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)
    s_j = np.asarray(want["stop_tokens"])
    np.testing.assert_allclose(got["stop_tokens"][:, :s_j.shape[1]], s_j,
                               atol=stop_atol, rtol=0)


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_of_each_config(name, monkeypatch):
    """The route comes from the config alone: `teacher_forced_route` and
    `plain_synthesis`, and the train forward with decode="fused" reaches
    `FusedTeacherForced` on the kernel route and never on the plain one."""
    want_tf, want_plain = ROUTES[name][1]
    tcfg = _over(cfgs()[1], name)
    assert teacher_forced_route(tcfg) == want_tf
    assert tts.plain_synthesis(tcfg) == want_plain
    calls = []
    real = tk.FusedTeacherForced.apply
    monkeypatch.setattr(tk.FusedTeacherForced, "apply",
                        lambda *a: calls.append(1) or real(*a))
    b = batch4()
    if tcfg.tacotron.predict_linear:
        b["linear_targets"] = np.zeros((4, 12, tcfg.audio.num_freq),
                                       np.float32)
    trainer = TacotronTrainer(tcfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    terms, _, grads, _ = trainer.gradients(
        state, b, torch.Generator().manual_seed(0))
    assert np.isfinite(float(terms["loss"].detach()))
    assert len(calls) == (want_tf == "kernel")


@pytest.mark.parametrize("name", ["prenet_16_8", "prenet_16_16_16", "adain"])
def test_synthesis_and_gta_match_jax(name):
    """Free-running synthesis and GTA against the JAX synthesizer (its
    scan on the CPU): a prenet other than (P, P) on the plain route in
    both modes; AdaIN on the kernels' routes (their plain versions here).
    se_concat=False synthesizes the default model bit for bit
    (tests/test_torch_model_variants.py); predict_linear's CBHG does not
    enter synthesis."""
    js, ts = synths(name)
    refs = _refs(3)
    want = js.synthesize(TEXTS, refs, refs)
    got = ts.synthesize(TEXTS, refs, refs)
    plain = name.startswith("prenet")
    assert ts.intermediates["route"] == ("plain" if plain else "fused")
    _synth_close(got, want, 2e-5)
    targets = _mels(TARGET_FRAMES)
    want = js.synthesize(TEXTS, refs, refs, mel_targets=targets, gta=True)
    got = ts.synthesize(TEXTS, refs, refs, mel_targets=targets, gta=True)
    assert ts.intermediates["route"] == (
        "teacher_forced_plain" if plain else "teacher_forced")
    _synth_close(got, want, 2e-4)


def _embed_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if got[k] is None:
            # JAX wraps a missing embedding as array(None)
            assert w is None or np.asarray(w).dtype == object, k
            continue
        np.testing.assert_allclose(got[k], np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["emt_simple", "emt_multihead",
                                  "emt_style_tokens", "adain"])
def test_emt_attn_gta_and_embed_match_jax(name):
    """GTA (with emotion labels, and its emt alignments) and `embed` under
    each emt_attn type, through the plain teacher-forced decode, and
    AdaIN's (the kernel route's plain version; `embed` gives only the
    speaker embedding, where JAX gives array(None) and None), against
    flax `apply(gta=True)` on the JAX synthesizer's padded inputs (what
    its `synthesize(gta=True)` and `embed` run, jitted once here), trimmed
    as the JAX synthesizer trims."""
    js, ts = synths(name, pin_stop=0.0)
    refs, targets = _refs(3), _mels(TARGET_FRAMES)
    mels = _mels((16, 21), seed=3)
    ids, lengths = js.prepare_inputs(TEXTS)
    ids_e, lengths_e = js.prepare_inputs(["a b", "c d"])
    tg, rf, em = (js._pad_refs(x, 64) for x in (targets, refs, mels))
    model = JaxTacotron(config=js.cfg)

    @jax.jit
    def reference(params, stats):
        v = {"params": params, "batch_stats": stats}
        g = model.apply(v, ids, lengths, mel_targets=tg, ref_mel_emt=rf,
                        ref_mel_spk=rf, emt_labels=np.asarray(LABELS),
                        gta=True, train=False, rngs=js._rngs())
        e = model.apply(v, ids_e, lengths_e, mel_targets=em, ref_mel_emt=em,
                        ref_mel_spk=em, gta=True, train=False,
                        synth_embeddings=True, rngs=js._rngs())
        return (g.mel_outputs, g.alignments, g.stop_token_prediction,
                g.alignments_emt, dict(
                    emb_emt=e.refnet_out_emt, emb_spk=e.refnet_out_spk,
                    emb_mo_emt=e.refnet_out_mel_emt,
                    emb_mo_spk=e.refnet_out_mel_spk))

    mel_j, al_j, st_j, ae_j, emb_j = (
        jax.tree_util.tree_map(np.asarray, x)
        for x in reference(js.params, js.batch_stats))
    got = ts.synthesize(TEXTS, refs, refs, mel_targets=targets, gta=True,
                        emt_labels=LABELS)
    emt = js.cfg.gst.emt_attn
    assert ts.intermediates["route"] == ("teacher_forced_plain" if emt
                                         else "teacher_forced")
    r, m = js.cfg.tacotron.outputs_per_step, js.cfg.audio.max_abs_value
    want = dict(lengths=list(TARGET_FRAMES), stop_tokens=st_j,
                mels=[np.clip(mel_j[i, :L], -m, m)
                      for i, L in enumerate(TARGET_FRAMES)],
                alignments=[al_j[i, :lengths[i], :L // r]
                            for i, L in enumerate(TARGET_FRAMES)])
    _synth_close(got, want, 2e-4)
    if emt:
        np.testing.assert_allclose(np.stack(got["alignments_emt"]), ae_j,
                                   atol=1e-4, rtol=0)
    else:
        assert "alignments_emt" not in got
    emb = ts.embed(["a b", "c d"], mels)
    assert (emb["emb_emt"] is None) == js.cfg.gst.adain
    _embed_close(emb, emb_j)


def _corpus(root):
    os.makedirs(os.path.join(root, "ds", "mels"))
    rows = []
    for i, f in enumerate((16, 21)):
        np.save(os.path.join(root, "ds", "mels", f"m{i}.npy"),
                _mels((f,), seed=i)[0])
        rows.append(f"ds|a{i}.npy|m{i}.npy|l|e|{f * 16}|{f}|text {i}.|"
                    f"{i}|{i}|u{i}.wav|F")
    path = os.path.join(root, "train.txt")
    with open(path, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return path


@pytest.mark.parametrize("name", ["adain", "emt_simple"])
def test_style_embs_raises_where_jax_does(name, tmp_path):
    """`run_style_embs` cannot write AdaIN's missing emotion
    embedding nor emt_attn's sequence: the JAX function raises, and the port
    raises ValueError naming the option."""
    js, ts = synths(name)
    path = _corpus(str(tmp_path))
    with pytest.raises((TypeError, ValueError)):
        jts.run_style_embs(js, path, str(tmp_path), str(tmp_path / "j"))
    with pytest.raises(ValueError, match=name.split("_")[0]):
        tts.run_style_embs(ts, path, str(tmp_path), str(tmp_path / "t"))


def _up_batch():
    b = batch4()
    for k in ("ref_mel_up_emt", "ref_mel_up_spk"):
        b[k] = b["ref_mel_emt"][::-1].copy()
    for k in ("emt_up_labels", "spk_up_labels"):
        b[k] = b[k.replace("_up", "")][::-1].copy()
    return b


@pytest.mark.parametrize("name", ["emt_simple", "emt_multihead"])
def test_unpaired_emt_attn_raises_as_jax(name):
    """The unpaired pass under emt_attn, traced by the JAX model and the
    JAX trainer's losses: simple (the speaker embedding in LSTM1) fails in
    flax on the second pass's narrower LSTM1 input, multihead in the loss,
    whose emotion head on the unpaired output gets the encoder's sequence; the port raises
    ValueError for both. Multihead with the pretrained classifiers, which
    re-embed the output themselves, trains."""
    jcfg, tcfg = variant_cfgs(name)
    b = _up_batch()
    trainer_j = JaxTrainer(jcfg, use_unpaired=True)
    kw = dict(mel_targets=b["mel_targets"], ref_mel_emt=b["ref_mel_emt"],
              ref_mel_spk=b["ref_mel_spk"], ref_mel_up_emt=b["ref_mel_up_emt"],
              ref_mel_up_spk=b["ref_mel_up_spk"], use_unpaired=True,
              train=True)

    def losses(r):
        rngs = dict(params=r, dropout=r, zoneout=r, teacher_forcing=r)
        v = trainer_j.model.init(rngs, b["inputs"], b["input_lengths"], **kw)
        out, _ = trainer_j.model.apply(v, b["inputs"], b["input_lengths"],
                                       rngs=rngs, mutable=["batch_stats"],
                                       **kw)
        return trainer_j._losses(out, b, v["params"])

    with pytest.raises(ValueError if name == "emt_multihead"
                       else ScopeParamShapeError):
        jax.eval_shape(losses, jax.random.PRNGKey(0))
    trainer = TacotronTrainer(tcfg, device="cpu", use_unpaired=True)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="use_unpaired"):
        trainer.train_step(state, b, torch.Generator().manual_seed(0))
    if name == "emt_multihead":
        trainer = TacotronTrainer(tcfg, device="cpu", use_unpaired=True,
                                  pretrained_emb_disc=True)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        state, m = trainer.train_step(state, b,
                                      torch.Generator().manual_seed(0))
        assert np.isfinite(float(m["loss"]))


def test_emt_attn_train_steps_match_jax_trainer():
    """Two whole emt_attn (simple, l2_spk_emb) steps from the same weights
    against `jax.jit(trainer.train_step)`: every term and grad_norm at
    each step, every parameter and statistic after each."""
    jcfg, tcfg = variant_cfgs("emt_simple")
    b = batch4()
    m = convert.init_tacotron(tcfg, torch.Generator().manual_seed(0), "cpu")
    params, stats = jax.tree_util.tree_map(jnp.asarray,
                                           convert.tacotron_to_flax(m))
    trainer_j = JaxTrainer(jcfg)
    tx_main, _, _ = trainer_j.ensure_tx(params)
    state_j = TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state_main=tx_main.init(params), opt_state_refnet=None,
        opt_state_nat=None)
    trainer = TacotronTrainer(tcfg, device="cpu")
    state = trainer.init_state(model=m)
    step = jax.jit(trainer_j.train_step)
    for i in range(2):
        state_j, mj = step(state_j, b, jax.random.PRNGKey(i))
        state, mt = trainer.train_step(state, b,
                                       torch.Generator().manual_seed(i))
        assert float(mj["style_emb_orthog_loss"]) > 0
        for k in mj:
            if k not in ("grad_norm", "teacher_forcing_ratio"):
                _close(float(mt[k]), float(mj[k]), msg=f"step {i} {k}")
        _close(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-4,
               msg=f"step {i} grad_norm")
        p_t, s_t = convert.tacotron_to_flax(state.model)
        for k, v in leaves(_to_np(state_j.params)).items():
            _close(leaves(p_t)[k], v, rtol=0, atol=PARAM_ATOL,
                   msg=f"step {i + 1} {k}")
        for k, v in leaves(_to_np(state_j.batch_stats)).items():
            _close(leaves(s_t)[k], v, rtol=1e-5, atol=1e-6,
                   msg=f"step {i + 1} stats {k}")
