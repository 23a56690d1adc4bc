"""The port's Tacotron training (model train mode, losses, schedules, the
masked Adam, `TacotronTrainer`, the feeder, checkpoints and `cli train`)
against the JAX package's, on the CPU.

Inputs are numpy arrays from seeds, at tests/test_tacotron_model.py's tiny
configuration (the decode's weights in f32, as the JAX scan runs them at
`compute_dtype="float32"`), with dropout and zoneout 0 and teacher-forcing
ratio 1 (the
random draws of the two packages differ; at these settings neither
draws). Weights come from the JAX trainer's `init_state` through
`convert.load_tacotron`. Tolerances, each an f32 computation in another
order: the forward's outputs and loss terms 1e-5 relative (1e-6 absolute
below 0.1), gradient norms 1e-4 relative; parameters after 1 and 3 Adam
steps (learning rate 1e-3) within PARAM_ATOL, 1% of one step's move;
BatchNorm statistics 1e-5; the schedules and the optimizer on the same
numbers 1e-6 relative.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_tacotron_model import make_batch, tiny_config  # noqa: E402

from tacotron2_tpu.models.tacotron.losses import compute_losses as jax_losses
from tacotron2_tpu.models.tacotron.model import Tacotron as JaxTacotron
from tacotron2_tpu.train import optim as jax_optim
from tacotron2_tpu.train.tacotron_step import TacotronTrainer as JaxTrainer
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.config import Config as TorchConfig
from tacotron2_tpu_torch.models.tacotron.losses import compute_losses
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.models.tacotron.modules import BatchNorm
from tacotron2_tpu_torch.train import optim
from tacotron2_tpu_torch.train.tacotron_step import TacotronTrainer

PARAM_ATOL = 1e-5
TERMS = ("before_loss", "after_loss", "stop_token_loss",
         "regularization_loss", "style_emb_loss_emt", "style_emb_loss_spk",
         "style_emb_orthog_loss", "loss")


def _replace(cfg, **tc):
    tc = dict(dict(dropout_rate=0.0, zoneout_rate=0.0,
                   fused_train_dtype="float32"), **tc)
    return cfg.replace(tacotron=dataclasses.replace(cfg.tacotron, **tc))


def cfgs(**tc):
    """(JAX config, port config): tiny_config's widths in both packages."""
    jcfg = _replace(tiny_config(), **tc)
    base = TorchConfig()
    tcfg = base.replace(**{
        sec: dataclasses.replace(getattr(base, sec),
                                 **dataclasses.asdict(getattr(jcfg, sec)))
        for sec in ("tacotron", "gst", "audio", "train")})
    return jcfg, tcfg


def batch4():
    b = make_batch(B=4, T_in=10, T_out=12)
    return {k: np.array(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_state():
    jcfg, _ = cfgs()
    trainer = JaxTrainer(jcfg)
    return trainer, trainer.init_state(jax.random.PRNGKey(0), batch4())


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(state, tcfg):
    return convert.load_tacotron(Tacotron(tcfg), _to_np(state.params),
                                 _to_np(state.batch_stats))


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("mask_decoder", [False, True])
def test_train_forward_and_losses_match_jax(jax_state, mask_decoder):
    """Model.forward(train=True) (BatchNorm on batch statistics, the decode
    through FusedTeacherForced's plain pieces) and compute_losses against
    flax `apply(train=True)` and the JAX compute_losses; the running
    statistics after the step."""
    _, state = jax_state
    jcfg, tcfg = cfgs(mask_decoder=mask_decoder)
    b = batch4()
    model = JaxTacotron(config=jcfg)
    out, upd = model.apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        b["inputs"], b["input_lengths"], mel_targets=b["mel_targets"],
        ref_mel_emt=b["ref_mel_emt"], ref_mel_spk=b["ref_mel_spk"],
        teacher_forcing_ratio=1.0, train=True, mutable=["batch_stats"],
        rngs=dict(dropout=jax.random.PRNGKey(1),
                  zoneout=jax.random.PRNGKey(2),
                  teacher_forcing=jax.random.PRNGKey(3)))
    want = jax_losses(out, b, state.params, jcfg)
    m = port_model(state, tcfg)
    tb = TacotronTrainer(tcfg, device="cpu").batch_to_device(b)
    got = m(tb["inputs"], tb["input_lengths"], tb["mel_targets"],
            tb["ref_mel_emt"], tb["ref_mel_spk"], teacher_forcing_ratio=1.0,
            generator=torch.Generator().manual_seed(0))
    for k in ("decoder_output", "mel_outputs", "stop_token_prediction",
              "alignments", "refnet_out_emt", "refnet_out_spk",
              "style_emb_logit_emt", "style_emb_logit_spk"):
        _close(got[k].detach(), getattr(out, k), rtol=1e-4, atol=1e-5, msg=k)
    terms = compute_losses(got, tb, convert.flax_named_parameters(m), tcfg)
    for k in TERMS:
        _close(float(terms[k].detach()), float(want[k]), msg=k)
    _, stats = convert.tacotron_to_flax(m)
    for p, v in jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]:
        leaf = stats
        for key in p:
            leaf = leaf[key.key]
        _close(leaf, v, rtol=1e-5, atol=1e-6, msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax_trainer(jax_state, n_steps):
    """Whole train steps from the same weights: every loss term and
    grad_norm at each step, then every parameter and statistic."""
    trainer_j, state_j = jax_state
    _, tcfg = cfgs()
    trainer = TacotronTrainer(tcfg, device="cpu")
    state = trainer.init_state(model=port_model(state_j, tcfg))
    step = jax.jit(trainer_j.train_step)
    b = batch4()
    for i in range(n_steps):
        state_j, mj = step(state_j, b, jax.random.PRNGKey(i))
        state, mt = trainer.train_step(state, b,
                                       torch.Generator().manual_seed(i))
        for k in TERMS:
            _close(float(mt[k]), float(mj[k]), msg=f"step {i} {k}")
        _close(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-4,
               msg=f"step {i} grad_norm")
        assert float(mt["teacher_forcing_ratio"]) == 1.0
    assert state.step == int(state_j.step) == n_steps
    params, stats = convert.tacotron_to_flax(state.model)
    flat = jax.tree_util.tree_flatten_with_path(_to_np(state_j.params))[0]
    assert len(flat) == len(convert.flax_named_parameters(state.model))
    for p, v in flat:
        leaf = params
        for key in p:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf, v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(p))
    for p, v in jax.tree_util.tree_flatten_with_path(
            _to_np(state_j.batch_stats))[0]:
        leaf = stats
        for key in p:
            leaf = leaf[key.key]
        _close(leaf, v, rtol=1e-5, atol=1e-6, msg=jax.tree_util.keystr(p))


def test_train_step_reduces_loss():
    """test_train_step.py:test_train_step_reduces_loss on the port, from
    `init_tacotron`, with the default dropout and zoneout."""
    _, tcfg = cfgs(dropout_rate=0.5, zoneout_rate=0.1)
    trainer = TacotronTrainer(tcfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    b = batch4()
    b["input_lengths"][:] = 10
    b["targets_lengths"][:] = 12
    losses = []
    for i in range(8):
        state, m = trainer.train_step(state, b,
                                      torch.Generator().manual_seed(i))
        losses.append(float(m["after_loss"]))
    assert state.step == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("name", ["lr", "tfr_constant", "tfr_scheduled"])
def test_schedules_match_jax(name):
    jcfg, tcfg = cfgs()
    if name == "tfr_scheduled":
        over = dict(tacotron_teacher_forcing_mode="scheduled")
        jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, **over))
        tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, **over))
    pick = {"lr": "tacotron_lr_schedule"}.get(name, "teacher_forcing_schedule")
    fj, ft = getattr(jax_optim, pick)(jcfg), getattr(optim, pick)(tcfg)
    for step in (0, 1, 9999, 10000, 15000, 25000, 30000, 35000, 50000,
                 400000):
        _close(ft(step), float(fj(step)), rtol=1e-6, atol=0, msg=str(step))


def test_masked_adam_matches_optax():
    """Three updates of optax's masked clip + adam and the port's on the
    same parameters and gradients (one leaf off the mask; gradients large
    enough that clipping acts on the first update, not the others)."""
    _, tcfg = cfgs()
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    mask = {"a": True, "b": False, "c": True}
    jcfg, _ = cfgs()
    tx = jax_optim.masked_only(optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adam(jax_optim.tacotron_lr_schedule(jcfg), b1=0.9, b2=0.999,
                   eps=1e-6)), mask)
    st = tx.init(params)
    pj = dict(params)
    pt = [torch.tensor(params[k]) for k in shapes]
    adam = optim.MaskedAdam(tcfg, pt, [mask[k] for k in shapes])
    for i, scale in enumerate((5.0, 0.1, 0.2)):
        g = {k: (rng.normal(size=s) * scale).astype(np.float32)
             for k, s in shapes.items()}
        upd, st = tx.update(g, st, pj)
        pj = optax.apply_updates(pj, upd)
        adam.step(pt, [torch.tensor(g[k]) for k in shapes])
        for k, t in zip(shapes, pt):
            _close(t, pj[k], rtol=1e-6, atol=1e-7, msg=f"{i} {k}")
    assert np.array_equal(pt[1].numpy(), params["b"])


def test_batchnorm_train_matches_flax():
    import flax.linen as fnn
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, size=(4, 7, 6)).astype(np.float32)
    bn = fnn.BatchNorm(momentum=0.99, epsilon=1e-3)
    scale = rng.normal(size=6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    mean0 = rng.normal(size=6).astype(np.float32)
    var0 = rng.uniform(0.5, 2, size=6).astype(np.float32)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}
    y, upd = bn.apply(v, x, use_running_average=False,
                      mutable=["batch_stats"])
    m = BatchNorm(6)
    for name, val in (("scale", scale), ("bias", bias), ("mean", mean0),
                      ("var", var0)):
        getattr(m, name).data.copy_(torch.tensor(val))
    got = m(torch.tensor(x), train=True)
    _close(got.detach(), y, rtol=1e-5, atol=1e-6)
    _close(m.mean, upd["batch_stats"]["mean"], rtol=1e-6, atol=1e-7)
    _close(m.var, upd["batch_stats"]["var"], rtol=1e-6, atol=1e-7)
    eval_out = m(torch.tensor(x))       # running statistics
    _close(eval_out.detach(), bn.apply(
        {"params": v["params"], "batch_stats": upd["batch_stats"]}, x,
        use_running_average=True), rtol=1e-5, atol=1e-6)


def test_init_and_round_trip_match_the_flax_tree(jax_state):
    """init_tacotron's tree has the JAX init's paths and shapes, draws
    from the same families (kernels within their glorot limits, biases
    0, BatchNorm scales 1, GRU gate biases 1), and tacotron_to_flax
    inverts load_tacotron."""
    _, state = jax_state
    _, tcfg = cfgs()
    m = convert.init_tacotron(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    params, stats = convert.tacotron_to_flax(m)
    want = jax.tree_util.tree_flatten_with_path(_to_np(state.params))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(got) == len(want)
    for p, v in want:
        g = got[p]
        name = jax.tree_util.keystr(p)
        assert g.shape == v.shape, name
        if name.endswith("['bias']") and "BatchNorm" not in name:
            assert not g.any(), name
        if "BatchNorm" in name and name.endswith("['scale']"):
            assert (g == 1).all(), name
        if name.endswith("['gates_bias']"):
            assert (g == 1).all(), name
        if name.endswith("['kernel']") and v.ndim >= 2:
            rf = int(np.prod(v.shape[:-2])) if v.ndim > 2 else 1
            lim = (6.0 / (rf * (v.shape[-2] + v.shape[-1]))) ** 0.5
            assert np.abs(g).max() <= lim and np.abs(v).max() <= lim, name
    m2 = port_model(state, tcfg)
    p2, s2 = convert.tacotron_to_flax(m2)
    for p, v in want:
        leaf = p2
        for key in p:
            leaf = leaf[key.key]
        np.testing.assert_array_equal(leaf, v)
    for p, v in jax.tree_util.tree_flatten_with_path(
            _to_np(state.batch_stats))[0]:
        leaf = s2
        for key in p:
            leaf = leaf[key.key]
        np.testing.assert_array_equal(leaf, v)


@pytest.mark.parametrize("flag", ["emt_attn", "adain", "predict_linear",
                                  "se_concat", "prenet_layers",
                                  "unknown_option"])
def test_unported_training_options_raise(flag):
    """The configs the trainer once refused now train: the emt_attn,
    AdaIN, linear-output (its batch carrying linear_targets) and
    se_concat=False configs and an unequal prenet each build a trainer and
    take one CPU step with finite terms; a flag the JAX trainer does not
    have still raises TypeError with its name (their parity with JAX:
    tests/test_torch_model_variants.py)."""
    _, tcfg = cfgs()
    sec, over = {"emt_attn": ("gst", dict(emt_attn=True)),
                 "adain": ("gst", dict(adain=True)),
                 "predict_linear": ("tacotron", dict(predict_linear=True)),
                 "se_concat": ("gst", dict(se_concat=False)),
                 "prenet_layers": ("tacotron", dict(prenet_layers=(16, 8))),
                 "unknown_option": ("gst", {})}[flag]
    cfg = tcfg.replace(**{sec: dataclasses.replace(getattr(tcfg, sec),
                                                   **over)})
    if flag == "unknown_option":
        with pytest.raises(TypeError, match=flag):
            TacotronTrainer(cfg, device="cpu", **{flag: True})
        return
    trainer = TacotronTrainer(cfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    b = batch4()
    if flag == "predict_linear":
        b["linear_targets"] = np.random.default_rng(1).uniform(
            -4, 4, (4, 12, cfg.audio.num_freq)).astype(np.float32)
    state, m = trainer.train_step(state, b, torch.Generator().manual_seed(0))
    assert state.step == 1
    assert all(np.isfinite(float(v)) for v in m.values()), m
    if flag == "predict_linear":
        assert float(m["linear_loss"]) > 0


# ------------------------------------------------- feeder, checkpoints, CLI

def tiny_corpus(root, n=24, mels=20, seed=0):
    """A train.txt over random mels: emt4 rows (emotion references by
    label) and vctk rows (speaker references by label)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ds = "emt4" if i % 3 else "vctk"
        os.makedirs(os.path.join(root, ds, "mels"), exist_ok=True)
        frames = int(rng.integers(9, 30))
        np.save(os.path.join(root, ds, "mels", f"mel-{i}.npy"),
                rng.uniform(-4, 4, (frames, mels)).astype(np.float32))
        text = "".join(rng.choice(list("abcdefghij"), int(rng.integers(4, 12))))
        rows.append(f"{ds}|audio-{i}.npy|mel-{i}.npy|l|e|{frames * 4}|"
                    f"{frames}|{text}|{i % 4}|{i % 3}|utt{i}.wav|F")
    path = os.path.join(root, "train.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    return path


def feeder_cfgs():
    over = dict(tacotron_batch_size=2, tacotron_test_size=0.25)
    return [c.replace(train=dataclasses.replace(c.train, **over))
            for c in cfgs()]


def test_feeder_batches_match_jax(tmp_path):
    """The split, three train batches and the test batches of one seed,
    against the JAX TacotronFeeder's (numpy path)."""
    from tacotron2_tpu.data.feeder import TacotronFeeder as JaxFeeder
    from tacotron2_tpu_torch.data.feeder import TacotronFeeder
    path = tiny_corpus(str(tmp_path))
    jcfg, tcfg = feeder_cfgs()
    kw = dict(batches_per_group=2, pad_text_multiple=4, pad_mel_multiple=8,
              seed=3)
    fj, ft = JaxFeeder(jcfg, path, **kw), TacotronFeeder(tcfg, path, **kw)
    assert ft.train_meta == fj.train_meta and ft.test_meta == fj.test_meta
    assert len(ft.test_meta) == 6
    gj, gt = fj.train_batches(2), ft.train_batches(2)
    pairs = [(next(gj), next(gt)) for _ in range(3)]
    pairs += list(zip(fj.test_batches(2), ft.test_batches(2)))
    assert len(pairs) == 6
    for bj, bt in pairs:
        assert set(bt) == set(bj)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    assert next(ft.prefetch(iter([{"x": 1}]))) == {"x": 1}


def test_checkpoint_restores_and_feeds_the_synthesizer(tmp_path):
    """Two train steps, a checkpoint, a restore into a fresh state (every
    parameter, statistic and moment, the count and the step), the file
    read by flax's own msgpack reader, and the port's TacotronSynthesizer
    on it (as `cli synthesize --checkpoint` loads it) equal to one built
    from the live model."""
    import flax.serialization as fser
    from tacotron2_tpu_torch.synth.tacotron_synth import TacotronSynthesizer
    from tacotron2_tpu_torch.train.checkpoint import (CheckpointManager,
                                                      partial_restore)
    _, tcfg = cfgs()
    trainer = TacotronTrainer(tcfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    for i in range(2):
        state, _ = trainer.train_step(state, batch4(),
                                      torch.Generator().manual_seed(i))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=1)
    mgr.save(1, state)
    path = mgr.save(2, state)
    assert mgr.steps() == [2]
    fresh = trainer.init_state(torch.Generator().manual_seed(9))
    back = mgr.restore(fresh)
    assert back.step == 2 and back.opt.count == 2
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              back.model.state_dict().items()):
        assert torch.equal(a, b), n
    for a, b in zip(state.opt.mu + state.opt.nu, back.opt.mu + back.opt.nu):
        assert torch.equal(a, b)
    tree = fser.msgpack_restore(open(path, "rb").read())
    params, stats = convert.tacotron_to_flax(state.model)
    np.testing.assert_array_equal(
        tree["params"]["decoder"]["cell"]["lstm1"]["bias"],
        params["decoder"]["cell"]["lstm1"]["bias"])
    assert int(tree["step"]) == 2
    kept = partial_restore(tree["params"], params,
                           lambda n: n.startswith("style_disc"))
    leaf = lambda t, n: t[n]["Dense_0"]["kernel"]
    assert leaf(kept, "style_disc_emt") is leaf(params, "style_disc_emt")
    assert leaf(kept, "postnet_projection") is leaf(tree["params"],
                                                    "postnet_projection")
    tp, ts, _ = convert.load_checkpoints(path)
    refs = [np.zeros((16, 20), np.float32)]
    outs = []
    for p_, s_ in ((tp, ts), (params, stats)):
        synth = TacotronSynthesizer(tcfg, p_, s_, device="cpu", seed=1)
        outs.append(synth.synthesize(["abcde"], refs, refs, max_steps=8))
    assert np.isfinite(outs[0]["mels"][0]).all()
    np.testing.assert_array_equal(outs[0]["mels"][0], outs[1]["mels"][0])


def test_cli_train_three_steps(tmp_path, monkeypatch):
    """`cli train --model Tacotron --device cpu` for 3 steps on a tiny
    corpus: the log directory, a checkpoint every 2 steps and the last,
    the curve with the eval's held-out metrics at step 3, the eval wavs."""
    import json

    from tacotron2_tpu_torch import cli
    path = tiny_corpus(str(tmp_path / "data"))
    _, tcfg = feeder_cfgs()
    tcfg = tcfg.replace(
        tacotron=dataclasses.replace(tcfg.tacotron, max_iters=6),
        audio=dataclasses.replace(tcfg.audio, griffin_lim_iters=2),
        train=dataclasses.replace(tcfg.train, eval_num_sentences=1,
                                  checkpoint_interval=2))
    monkeypatch.setattr(cli, "get_config", lambda *a, **k: tcfg)
    ckpt_dir = cli.main(["train", "--model", "Tacotron", "--input-path", path,
                         "--base-dir", str(tmp_path), "--train-steps", "3",
                         "--batch-size", "2", "--device", "cpu",
                         "--eval-interval", "3"])
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt-2.msgpack",
                                            "ckpt-3.msgpack"]
    log_dir = os.path.dirname(ckpt_dir)
    recs = [json.loads(x) for x in open(os.path.join(
        log_dir, "taco_curve.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert "held_mel_mae" in recs[2] and "held_tf_diag" in recs[2]
    wavs = os.path.join(log_dir, "eval-dir", "step_0", "wavs")
    assert os.listdir(wavs) == ["step-3-eval-0.wav"]
    # --pretrained-disc-emt is taken: a path that holds no checkpoint
    # stops the run before its first step
    with pytest.raises(FileNotFoundError, match="nowhere"):
        cli.main(["train", "--model", "Tacotron", "--input-path", path,
                  "--base-dir", str(tmp_path / "b"), "--pretrained-disc-emt",
                  str(tmp_path / "nowhere"), "--device", "cpu"])
