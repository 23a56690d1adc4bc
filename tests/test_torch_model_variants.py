"""The Tacotron variants the port once refused, against the JAX package on
the CPU: AdaIN, `gst.se_concat=False`, `predict_linear` with its linear
loss, prenets (16, 8) and (16, 16, 16), and emt_attn training (simple,
multihead, style_tokens) with `l2_spk_emb`.

At tests/test_tacotron_model.py's tiny configuration in f32 with dropout
and zoneout 0 and teacher-forcing ratio 1 (the parity rule of
tests/test_torch_train_step.py), the weights `convert.init_tacotron` draws
in the flax tree (`weights`). Tolerances, each an f32 computation in
another order: the forwards' outputs 1e-4 relative (1e-5 absolute), the
loss terms 1e-5
(1e-6), each gradient leaf within 1e-5 of the largest gradient of the
tree (its scale), BatchNorm statistics 1e-5 (1e-6); parameters after each
of two AdaIN train steps (the file's one jitted JAX step) within
PARAM_ATOL.
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
from test_torch_train_step import (PARAM_ATOL, _close, _to_np,  # noqa: E402
                                   batch4, cfgs)

from tacotron2_tpu.models.tacotron.model import Tacotron as JaxTacotron
from tacotron2_tpu.train.tacotron_step import TacotronTrainer as JaxTrainer
from tacotron2_tpu.train.tacotron_step import TrainState
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.models.tacotron.losses import compute_losses
from tacotron2_tpu_torch.train.tacotron_step import TacotronTrainer

# the CBHG head at small widths (the other widths are tiny_config's)
SMALL_CBHG = dict(cbhg_kernels=3, cbhg_conv_channels=8, cbhg_projection=16,
                  cbhg_highwaynet_layers=2, cbhg_highway_units=16,
                  cbhg_rnn_units=8)
# variant: (config section, overrides)
VARIANTS = {
    "adain": ("gst", dict(adain=True)),
    "se_concat_false": ("gst", dict(se_concat=False)),
    "predict_linear": ("tacotron", dict(predict_linear=True, **SMALL_CBHG)),
    "prenet_16_8": ("tacotron", dict(prenet_layers=(16, 8))),
    "prenet_16_16_16": ("tacotron", dict(prenet_layers=(16, 16, 16))),
    "emt_simple": ("gst", dict(emt_attn=True, emt_attn_type="simple",
                               l2_spk_emb=True)),
    "emt_multihead": ("gst", dict(emt_attn=True, emt_attn_type="multihead",
                                  l2_spk_emb=True)),
    "emt_style_tokens": ("gst", dict(emt_attn=True,
                                     emt_attn_type="style_tokens",
                                     l2_spk_emb=True)),
}
OUT_KEYS = ("decoder_output", "mel_outputs", "stop_token_prediction",
            "alignments", "refnet_out_emt", "refnet_out_spk",
            "style_emb_logit_emt", "style_emb_logit_spk", "linear_outputs")
RNGS = dict(dropout=jax.random.PRNGKey(1), zoneout=jax.random.PRNGKey(2),
            teacher_forcing=jax.random.PRNGKey(3))


def variant_cfgs(name, **tc):
    sec, over = VARIANTS[name]
    jcfg, tcfg = cfgs(**tc)
    rep = lambda c: c.replace(**{sec: dataclasses.replace(getattr(c, sec),
                                                          **over)})
    return rep(jcfg), rep(tcfg)


def variant_batch(cfg):
    """batch4, with seeded linear targets under predict_linear."""
    b = batch4()
    if cfg.tacotron.predict_linear:
        b["linear_targets"] = np.random.default_rng(9).uniform(
            -4, 4, b["mel_targets"].shape[:2] + (cfg.audio.num_freq,)
        ).astype(np.float32)
    return b


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def weights(tcfg):
    """(port model, flax params, batch_stats): `init_tacotron`'s draw in the
    flax tree. The tree is the JAX model's: flax refuses a missing or
    misshapen leaf, and a leaf that only the port would use shows in the
    gradients (and, after an optimizer step, in the parameters)."""
    m = convert.init_tacotron(tcfg, torch.Generator().manual_seed(0), "cpu")
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    return (m, *map(to_j, convert.tacotron_to_flax(m)))


def _grad_close(got, want, msg):
    """Every leaf within 1e-5 of the tree's largest gradient."""
    g, w = leaves(got), leaves(_to_np(want))
    assert set(g) == set(w), set(g) ^ set(w)
    scale = max(float(np.abs(v).max()) for v in w.values())
    for k, v in w.items():
        np.testing.assert_allclose(g[k], v, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{msg} {k}")


# se_concat=False is the default model bit for bit (the test after this
# one), whose parity with JAX tests/test_torch_train_step.py holds
@pytest.mark.parametrize("name", [n for n in VARIANTS
                                  if n != "se_concat_false"])
def test_variant_train_forward_losses_and_gradients_match_jax(name):
    """The train forward, every loss term, the gradient of 'loss' for
    every parameter and the running statistics against flax `apply(train=
    True)`, the JAX compute_losses and `jax.grad`; then the eval forward
    (train=False, natural ratio 0) against flax `apply(train=False)` (the
    JAX side in one jitted function)."""
    mask = name == "predict_linear"
    jcfg, tcfg = variant_cfgs(name, mask_decoder=mask)
    b = variant_batch(jcfg)
    m, params, stats = weights(tcfg)
    model_j = JaxTacotron(config=jcfg)
    kw = dict(mel_targets=b["mel_targets"], ref_mel_emt=b["ref_mel_emt"],
              ref_mel_spk=b["ref_mel_spk"], emt_labels=b["emt_labels"])
    trainer_j = JaxTrainer(jcfg)

    def loss_fn(p):
        out, upd = model_j.apply(
            {"params": p, "batch_stats": stats}, b["inputs"],
            b["input_lengths"], teacher_forcing_ratio=1.0, train=True,
            mutable=["batch_stats"], rngs=RNGS, **kw)
        terms = trainer_j._losses(out, b, p)
        return terms["loss"], (out, terms, upd)

    @jax.jit
    def reference(p):
        """The train forward, its terms and statistics, the gradient of
        'loss', and the eval forward (natural ratio 0) on the statistics
        the train forward left."""
        (_, (out, terms, upd)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        out_e = model_j.apply(
            {"params": p, "batch_stats": upd["batch_stats"]}, b["inputs"],
            b["input_lengths"], teacher_forcing_ratio=0.0, train=False,
            rngs=RNGS, **kw)
        return out, terms, upd, grads, out_e

    out, want, upd, grads_j, out_e = reference(params)

    trainer = TacotronTrainer(tcfg, device="cpu")
    tb = trainer.batch_to_device(b)
    args = (tb["inputs"], tb["input_lengths"], tb["mel_targets"],
            tb["ref_mel_emt"], tb["ref_mel_spk"])
    got = m(*args, teacher_forcing_ratio=1.0, emt_labels=tb["emt_labels"],
            generator=torch.Generator().manual_seed(0))
    keys = OUT_KEYS + (("alignments_emt",) if jcfg.gst.emt_attn else ())
    for k in keys:
        w = getattr(out, k)
        assert (got.get(k) is None) == (w is None), k
        if w is not None:
            _close(got[k].detach(), w, rtol=1e-4, atol=1e-5, msg=k)
    named = convert.flax_named_parameters(m)
    terms = compute_losses(got, tb, named, tcfg)
    assert set(want) <= set(terms), set(want) - set(terms)
    for k, w in want.items():
        _close(float(terms[k].detach()), float(w), msg=k)
    if jcfg.tacotron.predict_linear:
        assert float(want["linear_loss"]) > 0
    if name.startswith("emt_") and name != "emt_style_tokens":
        assert float(want["style_emb_orthog_loss"]) > 0     # l2_spk_emb
    g = torch.autograd.grad(terms["loss"], [p for _, p in named],
                            allow_unused=True)
    tree = {}
    for (n, p), x in zip(m.named_parameters(), g):
        convert.tree_set(tree, convert.flax_path(n), convert.to_flax_array(
            n, torch.zeros_like(p) if x is None else x, offset=False))
    _grad_close(tree, grads_j, name)
    stats_t = convert.tacotron_to_flax(m)[1]
    for k, v in leaves(_to_np(upd["batch_stats"])).items():
        _close(leaves(stats_t)[k], v, rtol=1e-5, atol=1e-6, msg=k)

    # the eval forward on the statistics the train forward left
    with torch.no_grad():
        got_e = m(*args, teacher_forcing_ratio=0.0, train=False,
                  emt_labels=tb["emt_labels"],
                  generator=torch.Generator().manual_seed(0))
    for k in keys:
        w = getattr(out_e, k)
        if w is not None:
            _close(got_e[k], w, rtol=1e-4, atol=1e-5, msg=f"eval {k}")


def test_se_concat_false_is_the_default_model_bit_for_bit():
    """The JAX model never reads `se_concat` and always concatenates: the
    port's se_concat=False model computes the default one's loss terms,
    gradients and synthesized mels bit for bit on the same weights."""
    from tacotron2_tpu_torch.synth.tacotron_synth import TacotronSynthesizer
    _, tcfg = cfgs()
    _, tcfg_f = variant_cfgs("se_concat_false")
    b = batch4()
    outs = []
    for cfg in (tcfg, tcfg_f):
        m = convert.init_tacotron(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
        params, stats = convert.tacotron_to_flax(m)
        mels = TacotronSynthesizer(cfg, params, stats, device="cpu").\
            synthesize(["hello there."], [b["ref_mel_emt"][0]],
                       [b["ref_mel_spk"][0]], max_steps=6)["mels"]
        trainer = TacotronTrainer(cfg, device="cpu")
        state = trainer.init_state(model=m)
        terms, params, grads, _ = trainer.gradients(
            state, b, torch.Generator().manual_seed(0))
        outs.append(([float(v.detach()) for v in terms.values()],
                     [x.clone() for x in grads], mels))
    assert outs[0][0] == outs[1][0]
    assert all(torch.equal(x, y) for x, y in zip(outs[0][1], outs[1][1]))
    assert all(np.array_equal(x, y) for x, y in zip(outs[0][2], outs[1][2]))


def test_adain_train_steps_match_jax_trainer():
    """Two whole AdaIN steps with the refnet optimizer on
    (`opt_ref_no_mo`), against `jax.jit(trainer.train_step)`: JAX's name
    predicate gives AdaIN's `reference_encoder` to the main optimizer and
    nothing to the refnet one, and so does the port; every term and
    grad_norm at each step, every parameter and statistic after each."""
    jcfg, tcfg = variant_cfgs("adain")
    b = batch4()
    m, params, stats = weights(tcfg)
    trainer_j = JaxTrainer(jcfg, opt_ref_no_mo=True)
    tx_main, tx_r, _ = trainer_j.ensure_tx(params)
    state_j = TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state_main=tx_main.init(params),
        opt_state_refnet=tx_r.init(params), opt_state_nat=None)
    trainer = TacotronTrainer(tcfg, device="cpu", opt_ref_no_mo=True)
    state = trainer.init_state(model=m)
    names = [n for n, _ in convert.flax_named_parameters(state.model)]
    ref_enc = [n.startswith("reference_encoder/") for n in names]
    assert any(ref_enc) and all(
        on for on, r in zip(state.opt.mask, ref_enc) if r)
    assert not any(state.opt_refnet.mask)
    step = jax.jit(trainer_j.train_step)
    for i in range(2):
        state_j, mj = step(state_j, b, jax.random.PRNGKey(i))
        state, mt = trainer.train_step(state, b,
                                       torch.Generator().manual_seed(i))
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
