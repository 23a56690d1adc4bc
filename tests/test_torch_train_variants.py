"""The port's Tacotron training variants against the JAX package's, on the
CPU: `emt_only`, `gst.use_gst=False`, the adversarial heads, the unpaired
second pass, the pretrained classifiers, `pretrained_emb_disc_all`,
nat-GAN with its discriminator pretraining, the refnet optimizer, the
feeder's options, `cli train` with the fork's flags and the checkpoint of
three optimizers.

At tests/test_tacotron_model.py's tiny configuration with dropout and
zoneout 0, teacher-forcing ratio 1 and the decode's weights in f32 (see
tests/test_torch_train_step.py), the weights from the JAX trainer's
`init_state` through `convert.load_tacotron`. Tolerances are
test_torch_train_step.py's: outputs 1e-4 relative (1e-5 absolute), loss
terms 1e-5 (1e-6), grad_norm 1e-4, parameters after 1 and 3 steps within
PARAM_ATOL, BatchNorm statistics 1e-5 (1e-6).
"""

import dataclasses
import json
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

from tacotron2_tpu.ops.grad_reversal import flip_gradient as jax_flip
from tacotron2_tpu.train.tacotron_step import TacotronTrainer as JaxTrainer
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.ops.grad_reversal import flip_gradient
from tacotron2_tpu_torch.train.tacotron_step import (MODEL_FLAGS,
                                                     TacotronTrainer)

# flag sets: (trainer flags, gst overrides)
VARIANTS = {
    "emt_only": (dict(emt_only=True), {}),
    "no_gst": ({}, dict(use_gst=False)),
    "adv": (dict(adv_emb_disc=True), {}),
    "unpaired": (dict(use_unpaired=True), {}),
    "unpaired_pretrained": (dict(use_unpaired=True, pretrained_emb_disc=True),
                            {}),
    "pretrained_all_unpaired": (dict(use_unpaired=True,
                                     pretrained_emb_disc_all=True), {}),
    "nat_gan_unpaired": (dict(use_unpaired=True, nat_gan=True), {}),
    "all_on": (dict(use_unpaired=True, adv_emb_disc=True, nat_gan=True,
                    opt_ref_no_mo=True), {}),
    "refnet_unpaired": (dict(use_unpaired=True, opt_ref_no_mo=True), {}),
    "nat_gan_adv_unpaired": (dict(use_unpaired=True, nat_gan=True,
                                  adv_emb_disc=True), {}),
    "pretrained_all": (dict(pretrained_emb_disc_all=True), {}),
    "nat_gan": (dict(nat_gan=True), {}),
}
OUT_KEYS = ("decoder_output", "mel_outputs", "stop_token_prediction",
            "alignments", "refnet_out_emt", "refnet_out_spk",
            "style_emb_logit_emt", "style_emb_logit_spk",
            "style_emb_logit_emt_adv", "style_emb_logit_spk_adv",
            "decoder_output_up", "mel_outputs_up", "refnet_out_up_emt",
            "refnet_out_up_spk", "style_emb_logit_up_emt",
            "style_emb_logit_up_spk", "refnet_out_mel_up_emt",
            "refnet_out_mel_up_spk", "style_emb_logit_mel_out_up_emt",
            "style_emb_logit_mel_out_up_spk")


def variant_cfgs(name):
    flags, gst = VARIANTS[name]
    jcfg, tcfg = cfgs()
    if gst:
        jcfg = jcfg.replace(gst=dataclasses.replace(jcfg.gst, **gst))
        tcfg = tcfg.replace(gst=dataclasses.replace(tcfg.gst, **gst))
    return flags, jcfg, tcfg


def batch_up(seed=5):
    """batch4 with the unpaired pass's crossed references and labels."""
    b = batch4()
    rng = np.random.default_rng(seed)
    for k in ("ref_mel_up_emt", "ref_mel_up_spk"):
        b[k] = rng.uniform(-4, 4, (4, 9, 20)).astype(np.float32)
    b["emt_up_labels"] = rng.integers(0, 4, (4,)).astype(np.int32)
    b["spk_up_labels"] = rng.integers(0, 3, (4,)).astype(np.int32)
    return b


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


_STATES = {}


def jax_state(name):
    """(JAX trainer, a JAX TrainState) of a variant, made once a module:
    the weights `convert.init_tacotron` draws (seed 0) in the flax tree,
    which is the JAX trainer's own `init_state` tree leaf for leaf and
    shape for shape (checked on its abstract evaluation), and fresh
    optimizer states."""
    if name not in _STATES:
        from tacotron2_tpu.train.tacotron_step import TrainState
        flags, jcfg, tcfg = variant_cfgs(name)
        trainer = JaxTrainer(jcfg, **flags)
        b = batch_up()
        want = jax.eval_shape(lambda r: trainer.init_state(r, b),
                              jax.random.PRNGKey(0))
        m = convert.init_tacotron(
            tcfg, torch.Generator().manual_seed(0), "cpu",
            **{k: v for k, v in flags.items() if k in MODEL_FLAGS})
        params, stats = jax.tree_util.tree_map(
            jnp.asarray, convert.tacotron_to_flax(m))
        shapes = lambda tree: {
            jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        for got, w in ((params, want.params), (stats, want.batch_stats)):
            assert shapes(got) == shapes(w), set(shapes(got)) ^ set(shapes(w))
        tx_main, tx_r, tx_n = trainer.ensure_tx(params)
        _STATES[name] = (trainer, TrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state_main=tx_main.init(params),
            opt_state_refnet=tx_r.init(params) if tx_r else None,
            opt_state_nat=tx_n.init(params) if tx_n else None))
    return _STATES[name]


def port_model(name, state):
    flags, _, tcfg = variant_cfgs(name)
    m = Tacotron(tcfg, **{k: v for k, v in flags.items() if k in MODEL_FLAGS})
    return convert.load_tacotron(m, _to_np(state.params),
                                 _to_np(state.batch_stats))


def _close_tree(got, want, msg, **tol):
    g, w = leaves(got), leaves(want)
    assert set(g) == set(w), (msg, set(g) ^ set(w))
    for k, v in w.items():
        _close(g[k], v, msg=f"{msg} {k}", **tol)


RNGS = dict(dropout=jax.random.PRNGKey(1), zoneout=jax.random.PRNGKey(2),
            teacher_forcing=jax.random.PRNGKey(3))


@pytest.mark.parametrize("name", ["emt_only", "no_gst", "adv", "unpaired",
                                  "unpaired_pretrained",
                                  "pretrained_all_unpaired",
                                  "nat_gan_unpaired", "all_on"])
def test_variant_forward_and_losses_match_jax(name):
    """The train forward (both passes, every head), every loss term and
    the running statistics after it, against flax `apply(train=True)` and
    the JAX compute_losses with the variant's flags (the port's parameter
    tree is the flax tree, leaf for leaf: `jax_state`)."""
    trainer_j, state = jax_state(name)
    flags, jcfg, tcfg = variant_cfgs(name)
    b = batch_up()
    up = flags.get("use_unpaired", False)
    out, upd = trainer_j.model.apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        b["inputs"], b["input_lengths"], mel_targets=b["mel_targets"],
        ref_mel_emt=b["ref_mel_emt"], ref_mel_spk=b["ref_mel_spk"],
        ref_mel_up_emt=b["ref_mel_up_emt"], ref_mel_up_spk=b["ref_mel_up_spk"],
        teacher_forcing_ratio=1.0, train=True, use_unpaired=up,
        mutable=["batch_stats"], rngs=RNGS)
    want = trainer_j._losses(out, b, state.params)
    m = port_model(name, state)
    trainer = TacotronTrainer(tcfg, device="cpu", **flags)
    tb = trainer.batch_to_device(b)
    got = m(tb["inputs"], tb["input_lengths"], tb["mel_targets"],
            tb["ref_mel_emt"], tb["ref_mel_spk"], tb["ref_mel_up_emt"],
            tb["ref_mel_up_spk"], teacher_forcing_ratio=1.0,
            generator=torch.Generator().manual_seed(0), use_unpaired=up)
    for k in OUT_KEYS:
        w = getattr(out, k)
        assert (got.get(k) is None) == (w is None), k
        if w is not None:
            _close(got[k].detach(), w, rtol=1e-4, atol=1e-5, msg=k)
    assert set(got.get("nat_gan", {})) == set(out.nat_gan)
    for k, w in out.nat_gan.items():
        _close(got["nat_gan"][k].detach(), w, rtol=1e-4, atol=1e-5, msg=k)
    terms = trainer._losses(got, tb, m, up)
    assert set(want) <= set(terms), set(want) - set(terms)
    for k, w in want.items():
        _close(float(terms[k].detach()), float(w), msg=k)
    _close_tree(convert.tacotron_to_flax(m)[1], _to_np(upd["batch_stats"]),
                "batch_stats", rtol=1e-5, atol=1e-6)


def test_adversarial_terms_enter_the_loss():
    """JAX keeps the adversarial cross-entropies out of its terms dict but
    in 'loss'; the port names them, and 'loss' less them is JAX's loss
    without the adversarial heads' logits' cross-entropy."""
    trainer_j, state = jax_state("adv")
    _, _, tcfg = variant_cfgs("adv")
    b = batch_up()
    m = port_model("adv", state)
    trainer = TacotronTrainer(tcfg, device="cpu", adv_emb_disc=True)
    tb = trainer.batch_to_device(b)
    got = m(tb["inputs"], tb["input_lengths"], tb["mel_targets"],
            tb["ref_mel_emt"], tb["ref_mel_spk"],
            generator=torch.Generator().manual_seed(0))
    terms = trainer._losses(got, tb, m, False)
    log_sm = torch.log_softmax(got["style_emb_logit_emt_adv"], -1)
    want = -log_sm.gather(-1, tb["spk_labels"].long()[:, None]).mean()
    _close(float(terms["style_emb_loss_emt_adv"].detach()),
           float(want.detach()))
    rest = sum(float(terms[k].detach()) for k in (
        "before_loss", "after_loss", "stop_token_loss", "regularization_loss",
        "style_emb_loss_emt", "style_emb_loss_spk", "style_emb_orthog_loss",
        "style_emb_loss_emt_adv", "style_emb_loss_spk_adv"))
    _close(float(terms["loss"].detach()), rest)


# A reference encoder's conv bias sits right before BatchNorm in train
# mode, so its gradient is zero in exact arithmetic wherever no eval-mode
# call reaches it: nat-GAN's encoder under 'd_loss', the model's own under
# the refnet optimizer's 'loss_no_mo_up', which leaves out the eval-mode
# calls on mel_outputs_up. Each package then moves such a leaf by Adam
# steps on rounding noise, lr·g/(|g| + eps) for |g| <= NOISE_GRAD (about
# 1e-8 here, against 1e-4 to 1e-1 for the other leaves): after n steps the
# two differ by at most 2·n such steps. The leaves of that form whose own
# optimizer's gradient is within NOISE_GRAD at the first step (measured
# on the port) are held to that; every other leaf to PARAM_ATOL.
BN_BIAS = r"(refnet_\w+|nat_gan_enc)\.conv_biases\.\d+"
NOISE_GRAD = 1e-7


def noise_leaves(trainer, state_j, name, batch):
    """{flax keystr} of the conv biases before train-mode BatchNorm whose
    own optimizer's first gradient is within NOISE_GRAD."""
    import re
    probe = trainer.init_state(model=port_model(name, state_j))
    _, _, grads, _ = trainer.step_gradients(probe, batch,
                                            torch.Generator().manual_seed(0))
    out = set()
    for t, opt in probe.optimizers():
        for (n, _), m, x in zip(probe.model.named_parameters(), opt.mask,
                                grads[t]):
            if m and re.fullmatch(BN_BIAS, n) and \
                    float(x.abs().max()) <= NOISE_GRAD:
                out.add("".join(f"['{k}']" for k in
                                convert.flax_path(n).split("/")))
    return out


def _params_close(model, state_j, msg, noise=(), steps=1):
    params, stats = convert.tacotron_to_flax(model)
    g, w = leaves(params), leaves(_to_np(state_j.params))
    assert set(g) == set(w), set(g) ^ set(w)
    lr, eps = 1e-3, 1e-6
    noise_atol = 2 * steps * lr * NOISE_GRAD / eps
    for k, v in w.items():
        atol = noise_atol if k in noise else PARAM_ATOL
        _close(g[k], v, rtol=0, atol=atol, msg=f"{msg} {k}")
    # the running mean after such a bias moves with it
    noisy_means = {k.replace("conv2d_", "BatchNorm_").replace("bias", "mean")
                   for k in noise}
    g, w = leaves(stats), leaves(_to_np(state_j.batch_stats))
    assert set(g) == set(w)
    for k, v in w.items():
        _close(g[k], v, rtol=1e-5,
               atol=noise_atol if k in noisy_means else 1e-6,
               msg=f"{msg} stats {k}")


@pytest.mark.parametrize("name", ["refnet_unpaired", "nat_gan_adv_unpaired",
                                  "pretrained_all"])
def test_variant_train_steps_match_jax_trainer(name):
    """Three whole steps from the same weights against
    `jax.jit(trainer.train_step)`: every term and grad_norm at each step,
    every parameter and statistic after steps 1 and 3, the optimizers'
    counts."""
    trainer_j, state_j = jax_state(name)
    flags, _, tcfg = variant_cfgs(name)
    trainer = TacotronTrainer(tcfg, device="cpu", **flags)
    b = batch_up()
    noise = noise_leaves(trainer, state_j, name, b)
    state = trainer.init_state(model=port_model(name, state_j))
    step = jax.jit(trainer_j.train_step)
    for i in range(3):
        state_j, mj = step(state_j, b, jax.random.PRNGKey(i))
        state, mt = trainer.train_step(state, b,
                                       torch.Generator().manual_seed(i))
        for k in mj:
            if k not in ("grad_norm", "teacher_forcing_ratio"):
                _close(float(mt[k]), float(mj[k]), msg=f"step {i} {k}")
        _close(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-4,
               msg=f"step {i} grad_norm")
        if i in (0, 2):
            _params_close(state.model, state_j, f"step {i + 1}", noise,
                          steps=i + 1)
    opts = [o for _, o in state.optimizers()]
    assert [o.count for o in opts] == [3] * len(opts)
    assert len(opts) == 1 + (state_j.opt_state_refnet is not None) + (
        state_j.opt_state_nat is not None)


def test_disc_pretrain_step_matches_jax():
    """disc_pretrain_step (tests/test_train_step.py:106's case, against
    JAX's step): only nat-GAN's parameters move, the step stays 0, the
    terms, parameters and statistics equal JAX's."""
    trainer_j, state_j = jax_state("nat_gan")
    flags, _, tcfg = variant_cfgs("nat_gan")
    trainer = TacotronTrainer(tcfg, device="cpu", **flags)
    b = batch_up()
    noise = noise_leaves(trainer, state_j, "nat_gan", b)
    state = trainer.init_state(model=port_model("nat_gan", state_j))
    before = {n: p.detach().clone()
              for n, p in convert.flax_named_parameters(state.model)}
    new_j, dm = jax.jit(trainer_j.disc_pretrain_step)(
        state_j, b, jax.random.PRNGKey(1))
    state, dt = trainer.disc_pretrain_step(state, b,
                                           torch.Generator().manual_seed(1))
    assert state.step == 0 == int(new_j.step)
    for k in dm:
        _close(float(dt[k]), float(dm[k]), msg=k)
    moved = {n for n, p in convert.flax_named_parameters(state.model)
             if not torch.equal(p, before[n])}
    assert moved and all("nat_gan" in n for n in moved), moved
    assert state.opt.count == 0 and state.opt_nat.count == 1
    _params_close(state.model, new_j, "disc pretrain", noise)


@pytest.mark.parametrize("scale", [1.0, 0.3])
def test_flip_gradient_matches_jax(scale):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    ct = rng.normal(size=(3, 5)).astype(np.float32)
    y, vjp = jax.vjp(lambda v: jax_flip(v, scale), jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(ct))
    xt = torch.tensor(x, requires_grad=True)
    yt = flip_gradient(xt, scale)
    (gt,) = torch.autograd.grad(yt, xt, torch.tensor(ct))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    _close(gt, gj, rtol=1e-6, atol=0)


def test_fused_teacher_forced_serves_two_backwards():
    """Two backwards over one forward through `FusedTeacherForced` (the
    plain pieces on the CPU): both equal, and equal to a fresh forward's."""
    _, state = jax_state("unpaired")
    _, _, tcfg = variant_cfgs("unpaired")
    b = batch_up()
    tb = TacotronTrainer(tcfg, device="cpu").batch_to_device(b)
    grads = []
    for _ in range(2):
        m = port_model("unpaired", state)
        got = m(tb["inputs"], tb["input_lengths"], tb["mel_targets"],
                tb["ref_mel_emt"], tb["ref_mel_spk"], tb["ref_mel_up_emt"],
                tb["ref_mel_up_spk"], use_unpaired=True,
                generator=torch.Generator().manual_seed(0))
        loss = (got["mel_outputs"] ** 2).mean() + got["mel_outputs_up"].mean()
        params = list(m.parameters())
        first = torch.autograd.grad(loss, params, retain_graph=True,
                                    allow_unused=True)
        second = torch.autograd.grad(loss, params, allow_unused=True)
        for x, y in zip(first, second):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)
        grads.append(first)
    for x, y in zip(*grads):
        if x is not None:
            assert torch.equal(x, y)
    assert sum(x is not None and bool(x.abs().sum() > 0)
               for x in grads[0]) > len(grads[0]) // 2


def test_three_gradients_agree_across_decode_routes():
    """The all-on step's three gradients through the fused route, autograd
    through the plain decode, and "replay" (autograd's backward on the
    fused forward's values) from the same weights, batch and draws: on the
    CPU the fused route's pieces are the plain versions, so all agree to
    1e-5 of each target's largest magnitude."""
    _, state_j = jax_state("all_on")
    flags, _, tcfg = variant_cfgs("all_on")
    trainer = TacotronTrainer(tcfg, device="cpu", **flags)
    got = {}
    for route in ("fused", "autograd", "replay"):
        state = trainer.init_state(model=port_model("all_on", state_j))
        _, _, grads, _ = trainer.step_gradients(
            state, batch_up(), torch.Generator().manual_seed(0),
            decode=route)
        got[route] = {t: torch.cat([x.flatten() for x in g if x is not None])
                      for t, g in grads.items()}
    assert set(got["fused"]) == {"loss", "loss_no_mo_up", "d_loss"}
    for route in ("autograd", "replay"):
        for t, y in got[route].items():
            err = float((got["fused"][t] - y).abs().max())
            assert err <= 1e-5 * float(y.abs().max()), (route, t, err)


def test_eval_step_under_unpaired():
    """The port's eval_step under use_unpaired runs the paired forward:
    its terms equal JAX's eval_step with use_unpaired=False on the
    feeder's test batch, where JAX's own unpaired eval raises TypeError
    (the test batch carries no crossed references)."""
    from tacotron2_tpu.data.feeder import TacotronFeeder as JaxFeeder
    trainer_j, state = jax_state("nat_gan_adv_unpaired")
    flags, jcfg, tcfg = variant_cfgs("nat_gan_adv_unpaired")
    feeder = JaxFeeder(_feeder_cfg(jcfg), _corpus(), unpaired=True, seed=3)
    test = feeder.test_batches(2)[0]
    assert "ref_mel_up_emt" not in test
    with pytest.raises(TypeError):
        trainer_j.eval_step(state, test, jax.random.PRNGKey(0))
    paired = JaxTrainer(jcfg, **dict(flags, use_unpaired=False))
    _, want = jax.jit(paired.eval_step)(state, test, jax.random.PRNGKey(0))
    trainer = TacotronTrainer(tcfg, device="cpu", **flags)
    st = trainer.init_state(model=port_model("nat_gan_adv_unpaired", state))
    _, got = trainer.eval_step(st, test, torch.Generator().manual_seed(0))
    assert set(want) <= set(got)
    for k, w in want.items():
        _close(float(got[k]), float(w), msg=k)


# ------------------------------------------------- feeder, CLI, checkpoint

_CORPUS = {}


def _corpus():
    """A train.txt over random mels (20 bins) of 4 emotions and 3 speakers,
    emt4 and vctk rows, basenames utt_NNN.wav (rows 21 and 23 among them),
    row 5's metadata at 600 frames; made once a module."""
    if "path" not in _CORPUS:
        import tempfile
        root = tempfile.mkdtemp(prefix="taco_variants_")
        rng = np.random.default_rng(0)
        rows = []
        for i in range(30):
            ds = "emt4" if i % 3 else "vctk"
            os.makedirs(os.path.join(root, ds, "mels"), exist_ok=True)
            frames = int(rng.integers(9, 30))
            np.save(os.path.join(root, ds, "mels", f"mel-{i}.npy"),
                    rng.uniform(-4, 4, (frames, 20)).astype(np.float32))
            text = "".join(rng.choice(list("abcdefghij"),
                                      int(rng.integers(4, 12))))
            meta_frames = 600 if i == 5 else frames
            rows.append(f"{ds}|audio-{i}.npy|mel-{i}.npy|l|e|{frames * 4}|"
                        f"{meta_frames}|{text}|{i % 4}|{i % 3}|"
                        f"utt_{i:03d}.wav|F")
        path = os.path.join(root, "train.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")
        _CORPUS["path"] = path
    return _CORPUS["path"]


def _feeder_cfg(c):
    over = dict(tacotron_batch_size=2, tacotron_test_size=0.25)
    return c.replace(train=dataclasses.replace(c.train, **over))


FEEDER_OPTIONS = {
    "emt_only": dict(emt_only=True),
    "intercross_both": dict(intercross_both=True),
    "intercross_spk_only": dict(intercross_spk_only=True),
    "unpaired": dict(unpaired=True),
    "unpaired_intercross": dict(unpaired=True, intercross_both=True),
    "unpaired_match_p": dict(unpaired=True, up_ref_match_p=True),
    "unpaired_no_general": dict(unpaired=True, no_general=True),
    "remove_long_samples": dict(remove_long_samples=True),
    "test_inputs": dict(test_inputs=True, unpaired=True),
    "test_max_len": dict(test_max_len=True),
}


@pytest.mark.parametrize("option", list(FEEDER_OPTIONS))
def test_feeder_options_match_jax(option, capsys):
    """The split, three train batches and the test batches of one seed
    under each option, against the JAX TacotronFeeder's."""
    from tacotron2_tpu.data.feeder import TacotronFeeder as JaxFeeder
    from tacotron2_tpu_torch.data.feeder import TacotronFeeder
    jcfg, tcfg = (_feeder_cfg(c) for c in cfgs())
    kw = dict(batches_per_group=2, pad_text_multiple=4, pad_mel_multiple=8,
              seed=3, **FEEDER_OPTIONS[option])
    fj = JaxFeeder(jcfg, _corpus(), **kw)
    ft = TacotronFeeder(tcfg, _corpus(), **kw)
    assert ft.train_meta == fj.train_meta and ft.test_meta == fj.test_meta
    assert (ft.emt_list, ft.spk_list) == (fj.emt_list, fj.spk_list)
    gj, gt = fj.train_batches(2), ft.train_batches(2)
    train = [(next(gj), next(gt)) for _ in range(3)]
    pairs = train + list(zip(fj.test_batches(2), ft.test_batches(2)))
    for bj, bt in pairs:
        assert set(bt) == set(bj)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    up = "ref_mel_up_emt" in train[0][1]
    assert up == bool(kw.get("unpaired"))
    assert all("ref_mel_up_emt" not in bt for _, bt in pairs[3:])
    if option == "remove_long_samples":
        assert len(ft.metadata) == 27
    if option == "test_max_len":
        frames = [int(m[6]) for m in ft.train_meta]
        assert frames == sorted(frames, reverse=True)
    capsys.readouterr()


def _cli_cfg(tcfg):
    tcfg = _feeder_cfg(tcfg)
    return tcfg.replace(
        tacotron=dataclasses.replace(tcfg.tacotron, max_iters=6),
        audio=dataclasses.replace(tcfg.audio, griffin_lim_iters=2),
        train=dataclasses.replace(tcfg.train, eval_num_sentences=1,
                                  checkpoint_interval=2,
                                  nat_gan_pretrain_steps_unpaired=2))


def test_cli_train_with_the_fork_flags(tmp_path, monkeypatch):
    """`cli train --model Tacotron` with --unpaired --intercross-both
    --adv-emb-disc --nat-gan --opt-ref-no-mo for 3 steps after 2
    discriminator-pretraining steps: checkpoints, the curve with the held-
    out metrics, the three optimizers in the checkpoint."""
    from tacotron2_tpu_torch import cli
    from tacotron2_tpu_torch.utils import flax_msgpack
    _, tcfg = cfgs()
    monkeypatch.setattr(cli, "get_config", lambda *a, **k: _cli_cfg(tcfg))
    flags = ["--unpaired", "--intercross-both", "--adv-emb-disc", "--nat-gan",
             "--opt-ref-no-mo"]
    base = ["train", "--model", "Tacotron", "--input-path", _corpus(),
            "--base-dir", str(tmp_path), "--batch-size", "2", "--device",
            "cpu"]
    ckpt_dir = cli.main(base + ["--train-steps", "3", "--eval-interval",
                                "3"] + flags)
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt-2.msgpack",
                                            "ckpt-3.msgpack"]
    recs = [json.loads(x) for x in open(os.path.join(
        os.path.dirname(ckpt_dir), "taco_curve.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert "held_mel_mae" in recs[2]
    tree = flax_msgpack.load(os.path.join(ckpt_dir, "ckpt-3.msgpack"))
    assert {"opt_state", "opt_state_refnet", "opt_state_nat"} <= set(tree)
    assert int(tree["opt_state"]["count"]) == 3
    assert int(tree["opt_state_refnet"]["count"]) == 3
    # 2 pretraining steps and 3 train steps
    assert int(tree["opt_state_nat"]["count"]) == 5
    assert set(tree["opt_state_nat"]["mu"]) == {
        "nat_gan_enc", "nat_gan_disc", "nat_gan_disc_emt", "nat_gan_disc_spk"}
    assert set(tree["opt_state_refnet"]["mu"]) == {
        "refnet_emt", "refnet_spk", "style_disc_emt", "style_disc_spk",
        "style_disc_emt_adv", "style_disc_spk_adv"}


@pytest.mark.parametrize("name", ["pretrained_all_unpaired", "emt_only"])
def test_eval_synthesis_of_the_variant(name, tmp_path):
    """The host loop's eval synthesis builds the variant's own model (no
    GST attention under pretrained_emb_disc_all, no speaker encoder under
    emt_only) and writes its wav, with no failure counted."""
    from tacotron2_tpu_torch.train.eval_guard import EvalFailureGuard
    from tacotron2_tpu_torch.train.tacotron_train import _eval_synthesis
    flags, _, tcfg = variant_cfgs(name)
    tcfg = _cli_cfg(tcfg)
    trainer = TacotronTrainer(tcfg, device="cpu", **flags)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    guard = EvalFailureGuard("eval synthesis")
    _eval_synthesis(tcfg, state, batch_up(), str(tmp_path), 2, None, guard,
                    trainer)
    assert guard.consecutive == 0
    assert os.listdir(tmp_path / "step_0" / "wavs") == ["step-2-eval-0.wav"]


@pytest.mark.parametrize("argv", [["--pretrained-disc-emt", "x"],
                                  ["--pretrained-disc-spk", "x"],
                                  ["--save-output-vars"]])
def test_cli_train_passes_the_disc_and_dump_options(argv, tmp_path,
                                                    monkeypatch):
    """The discriminator grafts and the output-var dumps reach the
    trainer as the JAX command passes them (tests/test_torch_host_extras.py
    runs them)."""
    from tacotron2_tpu_torch import cli
    from tacotron2_tpu_torch.train import tacotron_train
    seen = {}
    monkeypatch.setattr(tacotron_train, "tacotron_train",
                        lambda *a, **k: seen.update(k) or ("ckpt", None))
    cli.main(["train", "--model", "Tacotron", "--input-path", _corpus(),
              "--base-dir", str(tmp_path), "--device", "cpu"] + argv)
    key = argv[0][2:].replace("-", "_")
    assert seen[key] == (argv[1] if len(argv) > 1 else True)


@pytest.mark.parametrize("argv", [["--pretrained-disc-emt", "missing"],
                                  ["--pretrained-disc-spk", "missing"],
                                  ["--pretrained-disc-emt", "empty"]])
def test_cli_train_refuses_the_left_options(argv, tmp_path):
    """The discriminator options, which the port once refused outright,
    are refused by name where their path holds no checkpoint: a path that
    does not exist, or a directory with none in it."""
    from tacotron2_tpu_torch import cli
    path = tmp_path / argv[1]
    if argv[1] == "empty":
        path.mkdir()
    with pytest.raises(FileNotFoundError, match=str(path)):
        cli.main(["train", "--model", "Tacotron", "--input-path", _corpus(),
                  "--base-dir", str(tmp_path / "run"), "--device", "cpu",
                  argv[0], str(path)])


def test_checkpoint_round_trip_of_three_optimizers(tmp_path):
    """Two all-on steps (pretrained classifiers too), a checkpoint and a
    restore into a fresh state: every parameter, statistic, moment and
    count of the three optimizers; with keep_fresh the `pretrained`
    parameters keep the fresh state's values."""
    from tacotron2_tpu_torch.train.checkpoint import CheckpointManager
    flags = dict(use_unpaired=True, adv_emb_disc=True, nat_gan=True,
                 opt_ref_no_mo=True, pretrained_emb_disc=True)
    _, tcfg = cfgs()
    trainer = TacotronTrainer(tcfg, device="cpu", **flags)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    for i in range(2):
        state, _ = trainer.train_step(state, batch_up(),
                                      torch.Generator().manual_seed(i))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, state)
    fresh = trainer.init_state(torch.Generator().manual_seed(9))
    pre = {n: p.detach().clone() for n, p in
           convert.flax_named_parameters(fresh.model) if "pretrained" in n}
    assert pre
    back = mgr.restore(fresh)
    assert back.step == 2
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              back.model.state_dict().items()):
        assert torch.equal(a, b), n
    for (_, o), (_, p) in zip(state.optimizers(), back.optimizers()):
        assert o.count == p.count == 2
        for a, b in zip(o.mu + o.nu, p.mu + p.nu):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)
    fresh = trainer.init_state(torch.Generator().manual_seed(9))
    kept = mgr.restore(fresh, keep_fresh=lambda n: "pretrained" in n)
    for n, p in convert.flax_named_parameters(kept.model):
        if "pretrained" in n:
            assert torch.equal(p, pre[n]), n
        elif "decoder" in n:
            ref = dict(convert.flax_named_parameters(state.model))[n]
            assert torch.equal(p, ref), n
