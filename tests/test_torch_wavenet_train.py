"""The port's WaveNet training (losses, the train forward, `WaveNetTrainer`,
the data-dependent init, the feeder, checkpoints, `wavenet_train` and `cli
train --model WaveNet | Tacotron-2`) against the JAX package's, on the CPU.

Inputs are numpy arrays from seeds at tests/test_wavenet.py's tiny
configuration (4 layers, R 8, G 16, S 8, cin 10, hop 4), f32 and dropout
0 (the two packages' random draws differ; at dropout 0 neither draws), the
weights the JAX model's init through `convert`. Tolerances, each an f32
computation in another order: losses 1e-5 relative (1e-4 for the
Gaussian CDF loss, a difference of two close erf values); gradients 1e-4 of
each tensor's largest value (floored at 1e-4 of the largest of any);
parameters and EMA after 3 Adam steps
(learning rate 1e-3) within PARAM_ATOL, 1% of one step's move; the
data-dependent init's g and bias 1e-4 relative; the bf16 stack's loss
within 2e-2 of JAX's bf16 loss (tests/test_wavenet_train.py's bound
between bf16 and f32); the r5 checkpoint's full-width loss 1e-4 relative
in f32, chip_smoke.py's R5_EMA_BF16_RTOL in bf16.
"""

import dataclasses
import json
import os
import sys
import wave

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_wavenet import tiny_wn_config  # noqa: E402

from tacotron2_tpu.models.wavenet import distributions as JD
from tacotron2_tpu.models.wavenet.model import WaveNet as JaxWaveNet
from tacotron2_tpu.models.wavenet.model import \
    compute_wavenet_loss as jax_wavenet_loss
from tacotron2_tpu.train.wavenet_step import WaveNetTrainer as JaxTrainer
from tacotron2_tpu_torch import cli, convert
from tacotron2_tpu_torch.config import Config as TorchConfig
from tacotron2_tpu_torch.models.wavenet import distributions as D
from tacotron2_tpu_torch.models.wavenet.model import compute_wavenet_loss
from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer

PARAM_ATOL = 1e-5
RNGS = dict(params=jax.random.PRNGKey(0), dropout=jax.random.PRNGKey(1))
B, T_MEL, HOP = 2, 6, 4


def port_cfg(jcfg):
    """The JAX config's sections in the port's Config class."""
    base = TorchConfig()
    return base.replace(**{
        sec: dataclasses.replace(getattr(base, sec),
                                 **dataclasses.asdict(getattr(jcfg, sec)))
        for sec in ("wavenet", "audio", "train")})


def make_batch(cfg, seed=0, b=B, t_mel=T_MEL):
    rng = np.random.default_rng(seed)
    T = t_mel * HOP
    x = rng.uniform(-0.5, 0.5, (b, T, 1)).astype(np.float32)
    return dict(x=x, y=x[..., 0].copy(),
                c=rng.uniform(0, 1, (b, t_mel, cfg.wavenet.cin_channels))
                .astype(np.float32),
                input_lengths=np.asarray([T, T - 5][:b], np.int32))


def jax_params(jcfg, batch):
    v = JaxWaveNet(config=jcfg).init(RNGS, batch["x"], batch["c"],
                                     train=False)
    return jax.tree_util.tree_map(np.asarray, v["params"])


def port_grads(model):
    """Each parameter's gradient in its flax layout; the last block's out
    conv feeds nothing, so its gradient is zero (None in torch)."""
    return {path: convert.wavenet_flax_array(
        path, p.grad if p.grad is not None else torch.zeros_like(p))
        for path, p in convert.wavenet_named_parameters(model)}


def flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def assert_scaled(got, want, rtol, floor, msg=""):
    """max |got - want| <= rtol · max(max |want|, floor): `floor` keeps a
    gradient that is 0 up to rounding (weight norm's v of a 1-row kernel,
    whose direction is its sign) from setting its own scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), floor), (msg, err)


# ------------------------------------------------------------------- losses


def _loss_inputs(kind, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "categorical":
        return (rng.normal(size=(2, 9, 16)).astype(np.float32),
                rng.integers(0, 16, (2, 9)).astype(np.int32))
    C = 30 if kind == "mol" else 2
    y_hat = rng.normal(size=(2, 9, C)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 9, 1)).astype(np.float32)
    y[0, :2, 0] = [-1.0, 1.0]       # the edge branches of the MoL loss
    return y_hat, y


@pytest.mark.parametrize("kind", ["gaussian", "gaussian-cdf", "mol",
                                  "categorical", "log-sum-exp"])
def test_losses_match_jax(kind):
    lengths = np.asarray([9, 6], np.int32)
    if kind == "log-sum-exp":
        x = np.random.default_rng(1).normal(size=(3, 5, 7)).astype(np.float32)
        got, want = D.log_sum_exp(torch.as_tensor(x)), JD.log_sum_exp(x)
    elif kind == "categorical":
        y_hat, y = _loss_inputs(kind)
        got = D.masked_cross_entropy_loss(torch.as_tensor(y_hat),
                                          torch.as_tensor(y), lengths)
        want = JD.masked_cross_entropy_loss(y_hat, y, lengths)
    else:
        y_hat, y = _loss_inputs(kind.split("-")[0])
        cdf = kind.endswith("cdf")
        if kind == "mol":
            fj = lambda a, b, reduce=True: JD.discretized_mix_logistic_loss(
                a, b, num_classes=256, reduce=reduce)
            ft = lambda a, b, reduce=True: D.discretized_mix_logistic_loss(
                a, b, num_classes=256, reduce=reduce)
        else:
            fj = lambda a, b, reduce=True: JD.gaussian_mle_loss(
                a, b, num_classes=256, use_cdf=cdf, reduce=reduce)
            ft = lambda a, b, reduce=True: D.gaussian_mle_loss(
                a, b, num_classes=256, use_cdf=cdf, reduce=reduce)
        yt, yht = torch.as_tensor(y), torch.as_tensor(y_hat)
        # with use_cdf the bin's mass is a difference of two erf values
        # 2/255 apart, which magnifies erf's last-place differences
        rtol = 1e-4 if cdf else 1e-5
        np.testing.assert_allclose(ft(yht, yt).numpy(),
                                   np.asarray(fj(y_hat, y)), rtol=rtol)
        got = D.masked_distribution_loss(
            lambda a, b: ft(a, b, reduce=False), yht, yt, lengths)
        want = JD.masked_distribution_loss(
            lambda a, b, reduce=False: fj(a, b, reduce), y_hat, y, lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4 if kind.endswith("cdf") else 1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("head", ["gaussian", "mol", "categorical"])
def test_compute_wavenet_loss_matches_jax(head):
    kw = {"gaussian": {}, "mol": dict(out_channels=30),
          "categorical": dict(input_type="mulaw-quantize", out_channels=256,
                              quantize_channels=256)}[head]
    jcfg = tiny_wn_config(**kw)
    rng = np.random.default_rng(2)
    y_hat = rng.normal(size=(2, 10, jcfg.wavenet.out_channels)).astype(
        np.float32)
    y = (rng.integers(0, 256, (2, 10)).astype(np.int32)
         if head == "categorical"
         else rng.uniform(-1, 1, (2, 10)).astype(np.float32))
    lengths = np.asarray([10, 7], np.int32)
    want = jax_wavenet_loss(type("O", (), dict(y_hat=y_hat))(), y, lengths,
                            jcfg)["loss"]
    got = compute_wavenet_loss(torch.as_tensor(y_hat), torch.as_tensor(y),
                               lengths, port_cfg(jcfg))["loss"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


# ---------------------------------------------------- forward and gradients


@pytest.mark.parametrize("weight_norm", [False, True],
                         ids=["plain", "weight-norm"])
def test_train_forward_and_gradients_match_jax(weight_norm):
    """The train forward's y_hat and loss, and every parameter's gradient,
    against jax.value_and_grad of the flax model (f32, dropout 0)."""
    jcfg = tiny_wn_config(weight_normalization=weight_norm)
    batch = make_batch(jcfg)
    params = jax_params(jcfg, batch)
    jmodel = JaxWaveNet(config=jcfg)

    def jloss(p):
        out = jmodel.apply({"params": p}, batch["x"], batch["c"], train=True,
                           rngs={"dropout": jax.random.PRNGKey(3)})
        return jax_wavenet_loss(out, batch["y"], batch["input_lengths"],
                                jcfg)["loss"], out.y_hat

    (lj, yj), gj = jax.value_and_grad(jloss, has_aux=True)(params)
    cfg = port_cfg(jcfg)
    model = convert.wavenet_from_flax(cfg, params, "cpu", trainable=True)
    y_hat, _ = model.train_forward(torch.as_tensor(batch["x"]),
                                   torch.as_tensor(batch["c"]), train=True,
                                   seed=0)
    loss = compute_wavenet_loss(y_hat, torch.as_tensor(batch["y"]),
                                batch["input_lengths"], cfg)["loss"]
    loss.backward()
    np.testing.assert_allclose(y_hat.detach().numpy(), np.asarray(yj),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    want = flat(jax.tree_util.tree_map(np.asarray, gj))
    got = port_grads(model)
    assert set(got) == set(want)
    floor = 1e-4 * max(np.abs(v).max() for v in want.values())
    for path in want:
        assert_scaled(got[path], want[path], 1e-4, floor, path)


@pytest.mark.parametrize("clips", ["default", "tight"])
def test_train_steps_match_jax_trainer(clips):
    """3 steps of WaveNetTrainer.train_step (loss, grad_norm, Adam with the
    norm and value clips, EMA with its warm-up decay) against the JAX
    trainer's, from the same weights; "tight" makes both clips bind."""
    over = {} if clips == "default" else dict(
        wavenet_gradient_max_norm=0.05, wavenet_gradient_max_value=2e-3)
    jcfg = tiny_wn_config()
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, **over))
    batch = make_batch(jcfg)
    jt = JaxTrainer(jcfg)
    js = jt.init_state(jax.random.PRNGKey(0), batch)
    cfg = port_cfg(jcfg)
    tt = WaveNetTrainer(cfg, device="cpu")
    model = convert.wavenet_from_flax(
        cfg, jax.tree_util.tree_map(np.asarray, js.params), "cpu",
        trainable=True)
    ts = tt.init_state(model=model)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        js, mj = jt.train_step(js, batch, jax.random.PRNGKey(i))
        ts, mt = tt.train_step(ts, batch, gen)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
    if clips == "tight":
        assert float(mj["grad_norm"]) > 0.05
    assert ts.step == int(js.step) == 3 and ts.opt.count == 3
    for tree, mod in ((js.params, ts.model), (js.ema_params, ts.ema)):
        want = flat(jax.tree_util.tree_map(np.asarray, tree))
        got = flat(convert.wavenet_to_flax(mod))
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=0,
                                       atol=PARAM_ATOL, err_msg=path)
    moved = flat(convert.wavenet_to_flax(ts.model))
    init = flat(jax.tree_util.tree_map(np.asarray, jt.init_state(
        jax.random.PRNGKey(0), batch).params))
    assert max(np.abs(moved[p] - init[p]).max() for p in init) > 1e-3


@pytest.mark.parametrize("schedule", ["exponential", "noam"])
def test_wavenet_lr_schedule_matches_jax(schedule):
    from tacotron2_tpu.train.optim import wavenet_lr_schedule as jax_sched
    from tacotron2_tpu_torch.train.optim import wavenet_lr_schedule
    jcfg = tiny_wn_config()
    jcfg = jcfg.replace(train=dataclasses.replace(
        jcfg.train, wavenet_lr_schedule=schedule, wavenet_decay_steps=300))
    fj, ft = jax_sched(jcfg), wavenet_lr_schedule(port_cfg(jcfg))
    for step in (0, 1, 7, 299, 4000, 12345):
        np.testing.assert_allclose(ft(step), float(fj(step)), rtol=1e-6)


def test_data_dependent_init_matches_jax():
    """Weight norm's data-dependent init (sequential, execution order) on
    the same init weights and batch: every g and bias."""
    from tacotron2_tpu.models.wavenet.model import \
        data_dependent_init as jax_ddi
    from tacotron2_tpu_torch.models.wavenet.model import data_dependent_init
    jcfg = tiny_wn_config(weight_normalization=True)
    batch = make_batch(jcfg, b=2, t_mel=8)
    params = jax_params(jcfg, batch)
    want = flat(jax.tree_util.tree_map(np.asarray, jax_ddi(
        JaxWaveNet(config=jcfg), params, batch["x"], batch["c"])))
    cfg = port_cfg(jcfg)
    model = convert.wavenet_from_flax(cfg, params, "cpu", trainable=True)
    data_dependent_init(model, torch.as_tensor(batch["x"]),
                        torch.as_tensor(batch["c"]))
    got = flat(convert.wavenet_to_flax(model))
    moved = 0
    for path in want:
        if path.endswith("/g") or (path.endswith("/bias")
                                   and "upsample" not in path):
            np.testing.assert_allclose(got[path], want[path], rtol=1e-4,
                                       atol=1e-6, err_msg=path)
            moved += not np.allclose(want[path], flat(params)[path])
    assert moved >= 10


def test_bf16_stack_loss_close_to_jax():
    """compute_dtype=bfloat16 on the layer loop (the CPU route): the eval
    loss within 2e-2 of the JAX model's bf16 loss on the same weights,
    parameters and y_hat f32, and 3 steps lower the loss."""
    jcfg = tiny_wn_config(compute_dtype="bfloat16")
    batch = make_batch(jcfg)
    params = jax_params(jcfg, batch)
    out = JaxWaveNet(config=jcfg).apply({"params": params}, batch["x"],
                                        batch["c"], train=False)
    want = float(jax_wavenet_loss(out, batch["y"], batch["input_lengths"],
                                  jcfg)["loss"])
    cfg = port_cfg(jcfg)
    trainer = WaveNetTrainer(cfg, device="cpu")
    state = trainer.init_state(model=convert.wavenet_from_flax(
        cfg, params, "cpu", trainable=True))
    y_hat, terms = trainer.eval_step(state, batch)
    assert y_hat.dtype == torch.float32
    np.testing.assert_allclose(float(terms["loss"]), want, rtol=2e-2)
    gen = torch.Generator().manual_seed(0)
    losses = [float(trainer.train_step(state, batch, gen)[1]["loss"])
              for _ in range(3)]
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_paper_preset_mol_train_step():
    """The paper preset (22.05 kHz, 10-mixture MoL head) trains: its loss
    falls over 3 steps from init_wavenet."""
    from tacotron2_tpu_torch.config import get_config
    cfg = get_config("paper")
    assert cfg.audio.sample_rate == 22050 and cfg.wavenet.out_channels == 30
    cfg = cfg.replace(wavenet=dataclasses.replace(
        cfg.wavenet, layers=4, stacks=2, residual_channels=8,
        gate_channels=16, skip_out_channels=8, upsample_scales=(2, 2)))
    batch = make_batch(cfg)
    trainer = WaveNetTrainer(cfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0), batch)
    gen = torch.Generator().manual_seed(1)
    losses = [float(trainer.train_step(state, batch, gen)[1]["loss"])
              for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_trainer_refuses_global_conditioning():
    """The trainer takes global conditioning: from a batch that carries
    speaker ids "g" it builds the gin_channels=4 model with its speaker
    table and gin convs, and its steps are finite and move the table
    (tests/test_torch_wavenet_variants.py holds them against JAX)."""
    cfg = port_cfg(tiny_wn_config(gin_channels=4, use_speaker_embedding=True,
                                  n_speakers=3))
    batch = dict(make_batch(cfg), g=np.asarray([1, 2], np.int32))
    trainer = WaveNetTrainer(cfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0), batch)
    assert state.model.gc_embedding.shape == (3, 4)
    table = state.model.gc_embedding.detach().clone()
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        state, metrics = trainer.train_step(state, batch, gen)
        assert np.isfinite(float(metrics["loss"]))
    moved = (state.model.gc_embedding - table).abs().amax(1)
    assert moved[1] > 0 and moved[2] > 0 and moved[0] == 0


# ------------------------------------------- feeder, checkpoints, the loop


def wn_corpus(root, n=20, mels=10, hop=4, seed=0):
    """(audio, mel) pairs under ds/audio and ds/mels with the hop
    alignment, and their train.txt (tests/test_wavenet_train.py's)."""
    os.makedirs(os.path.join(root, "ds", "audio"), exist_ok=True)
    os.makedirs(os.path.join(root, "ds", "mels"), exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        frames = int(rng.integers(20, 60))
        T = frames * hop
        t = np.arange(T) / 16000
        x = (0.4 * np.sin(2 * np.pi * (200 + 20 * i) * t)).astype(np.float32)
        c = rng.uniform(-4, 4, (frames, mels)).astype(np.float32)
        np.save(os.path.join(root, "ds", "audio", f"audio-{i}.npy"), x)
        np.save(os.path.join(root, "ds", "mels", f"mel-{i}.npy"), c)
        rows.append(f"ds|audio-{i}.npy|mel-{i}.npy|linear-{i}.npy|s.npy|{T}|"
                    f"{frames}|text|0|0|b{i}.wav|F")
    path = os.path.join(root, "train.txt")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def loop_cfg(jcfg):
    return jcfg.replace(
        train=dataclasses.replace(jcfg.train, wavenet_batch_size=2,
                                  wavenet_test_size=None,
                                  wavenet_test_batches=2, max_time_steps=96),
        audio=dataclasses.replace(jcfg.audio, hop_size=4, num_mels=10))


def test_feeder_batches_match_jax(tmp_path):
    """The split, three train batches and the test batches of one seed,
    against the JAX WaveNetFeeder's."""
    from tacotron2_tpu.data.wavenet_feeder import WaveNetFeeder as JaxFeeder
    from tacotron2_tpu_torch.data.wavenet_feeder import WaveNetFeeder
    path = wn_corpus(str(tmp_path))
    jcfg = loop_cfg(tiny_wn_config())
    fj = JaxFeeder(jcfg, path, gta=False, batches_per_group=2, seed=5)
    ft = WaveNetFeeder(port_cfg(jcfg), path, gta=False, batches_per_group=2,
                       seed=5)
    assert ft.train_meta == fj.train_meta and ft.test_meta == fj.test_meta
    gj, gt = fj.train_batches(), ft.train_batches()
    pairs = [(next(gj), next(gt)) for _ in range(3)]
    pairs += list(zip(fj.test_batches(), ft.test_batches()))
    assert len(pairs) == 5
    for bj, bt in pairs:
        assert set(bt) == set(bj)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


def test_checkpoint_round_trip_feeds_the_synthesizer(tmp_path):
    """Two steps, a checkpoint, a restore into a fresh state (weights, EMA,
    moments, count, step), the file read by flax's own msgpack reader, and
    `convert.load_wavenet` handing its EMA weights to WaveNetSynthesizer
    as `cli synthesize --wavenet-checkpoint` does."""
    import flax.serialization as fser
    from tacotron2_tpu_torch.synth.wavenet_synth import WaveNetSynthesizer
    from tacotron2_tpu_torch.train.checkpoint import CheckpointManager
    cfg = port_cfg(tiny_wn_config())
    batch = make_batch(cfg)
    trainer = WaveNetTrainer(cfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0), batch)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        state, _ = trainer.train_step(state, batch, gen)
    mgr = CheckpointManager(str(tmp_path / "wave_pretrained"))
    path = mgr.save(2, state)
    back = mgr.restore(trainer.init_state(torch.Generator().manual_seed(9),
                                          batch))
    assert back.step == 2 and back.opt.count == 2
    for a, b in zip(list(state.model.parameters())
                    + list(state.ema.parameters()) + state.opt.mu
                    + state.opt.nu,
                    list(back.model.parameters())
                    + list(back.ema.parameters()) + back.opt.mu
                    + back.opt.nu):
        assert torch.equal(a, b)
    tree = fser.msgpack_restore(open(path, "rb").read())
    assert int(tree["step"]) == 2 and set(tree) == {
        "params", "ema_params", "opt_state", "step"}
    ema = convert.load_wavenet(path)
    for p, v in flat(convert.wavenet_to_flax(state.ema)).items():
        np.testing.assert_array_equal(flat(ema)[p], v)
    mels = [np.random.default_rng(0).uniform(-4, 4, (5, 10)).astype(
        np.float32)]
    wavs = [WaveNetSynthesizer(cfg, t, device="cpu", seed=1).synthesize(mels)
            for t in (ema, convert.wavenet_to_flax(state.ema))]
    assert len(wavs[0][0]) == 5 * HOP and np.isfinite(wavs[0][0]).all()
    np.testing.assert_array_equal(wavs[0][0], wavs[1][0])


def test_wavenet_train_loop(tmp_path):
    """wavenet_train for 4 steps: checkpoints at 2 and 4, the curve, the
    held-out loss and an eval wav at the eval steps."""
    from tacotron2_tpu_torch.train.wavenet_train import wavenet_train
    path = wn_corpus(str(tmp_path / "data"))
    cfg = port_cfg(loop_cfg(tiny_wn_config()))
    log_dir = str(tmp_path / "logs")
    ckpt_dir, state = wavenet_train(cfg, path, log_dir, train_steps=4,
                                    gta=False, device="cpu",
                                    checkpoint_interval=2, eval_interval=2)
    assert state.step == 4
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt-2.msgpack", "ckpt-4.msgpack"]
    recs = [json.loads(x) for x in open(os.path.join(
        log_dir, "wavenet_curve.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert "eval_loss" in recs[1] and "eval_loss" in recs[3]
    names = sorted(os.listdir(os.path.join(log_dir, "wave_eval")))
    assert [n for n in names if n.endswith(".wav")] == [
        "step-2-pred.wav", "step-4-pred.wav"]
    # the wave and mel-reconstruction plots (matplotlib imports here)
    assert [n for n in names if n.endswith(".png")] == sorted(
        f"step-{s}-{k}.png" for s in (2, 4)
        for k in ("mel-comparison", "waveplot"))
    _, again = wavenet_train(cfg, path, log_dir, train_steps=5, gta=False,
                             device="cpu", restore=True, eval_interval=0)
    assert again.step == 5


def test_cli_train_wavenet_then_synthesize(tmp_path, monkeypatch):
    """`cli train --model WaveNet --no-gta --device cpu` for 3 steps; its
    checkpoint read by `cli synthesize --model WaveNet
    --wavenet-checkpoint` on one row: a finite wav of frames x hop
    samples."""
    path = wn_corpus(str(tmp_path / "data"))
    cfg = port_cfg(loop_cfg(tiny_wn_config()))
    monkeypatch.setattr(cli, "get_config", lambda *a, **k: cfg)
    ckpt_dir = cli.main(["train", "--model", "WaveNet", "--input-path", path,
                         "--no-gta", "--base-dir", str(tmp_path),
                         "--train-steps", "3", "--device", "cpu",
                         "--eval-interval", "0"])
    assert ckpt_dir.endswith(os.path.join("logs-WaveNet", "wave_pretrained"))
    assert os.listdir(ckpt_dir) == ["ckpt-3.msgpack"]
    mel = str(tmp_path / "data" / "ds" / "mels" / "mel-0.npy")
    with open(tmp_path / "map.txt", "w") as f:
        f.write(f"a.npy|{mel}|{mel}|0|text\n")
    out = cli.main(["synthesize", "--model", "WaveNet", "--wavenet-checkpoint",
                    os.path.join(ckpt_dir, "ckpt-3.msgpack"), "--mels-map",
                    str(tmp_path / "map.txt"), "--output-dir",
                    str(tmp_path / "out"), "--device", "cpu"])
    frames = len(np.load(mel))
    with wave.open(out[0]) as w:
        assert w.getnframes() == frames * HOP


def test_cli_train_tacotron2_sequencer(tmp_path, monkeypatch):
    """`cli train --model Tacotron-2 --device cpu`, 2 steps a stage on a
    tiny corpus with audio: Tacotron training, GTA synthesis of the
    train.txt, WaveNet training on its map.txt; state_log marks each stage
    and a rerun resumes past them."""
    from test_torch_train_step import feeder_cfgs, tiny_corpus
    path = tiny_corpus(str(tmp_path / "data"))
    root = os.path.dirname(path)
    for line in open(path):
        ds, audio, _, _, _, n, *_ = line.split("|")
        os.makedirs(os.path.join(root, ds, "audio"), exist_ok=True)
        np.save(os.path.join(root, ds, "audio", audio),
                np.random.default_rng(0).uniform(-0.5, 0.5, int(n)).astype(
                    np.float32))
    _, tcfg = feeder_cfgs()
    tcfg = tcfg.replace(
        tacotron=dataclasses.replace(tcfg.tacotron, max_iters=6),
        wavenet=dataclasses.replace(
            tcfg.wavenet, layers=4, stacks=2, residual_channels=8,
            gate_channels=16, skip_out_channels=8, cin_channels=20,
            upsample_scales=(2, 2), dropout=0.0),
        audio=dataclasses.replace(tcfg.audio, hop_size=4),
        train=dataclasses.replace(tcfg.train, wavenet_batch_size=2))
    assert tcfg.audio.effective_hop == 4
    monkeypatch.setattr(cli, "get_config", lambda *a, **k: tcfg)
    argv = ["train", "--model", "Tacotron-2", "--input-path", path,
            "--base-dir", str(tmp_path), "--train-steps", "2",
            "--batch-size", "2", "--device", "cpu", "--eval-interval", "0"]
    ckpt_dir = cli.main(argv)
    assert open(tmp_path / "state_log").read() == "1 1 1"
    log_dir = tmp_path / "logs-Tacotron-2"
    assert os.listdir(log_dir / "taco_pretrained") == ["ckpt-2.msgpack"]
    assert os.listdir(ckpt_dir) == ["ckpt-2.msgpack"]
    gta_map = tmp_path / "tacotron_output" / "gta" / "map.txt"
    assert len(open(gta_map).read().splitlines()) == 24
    assert cli.main(argv) == ckpt_dir           # every stage done: resumes
    assert len(open(log_dir / "wavenet_curve.jsonl").readlines()) == 2


# ------------------------------------------------- the r5 checkpoint's loss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5 = os.path.join(ROOT, "artifacts", "e2e_demo_r5")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_r5_ema_loss_matches_jax(dtype):
    """The r5 EMA checkpoint's eval loss at full width (20 layers, R 128,
    G 256) on the fixed crops chip_smoke.py's phase 19 uses, f32 and with
    the r5 config's bf16 stack: the port against the JAX model (f32 1e-4;
    bf16, where the port's op-by-op rounding stands in for XLA's fusions,
    within chip_smoke's R5_EMA_BF16_RTOL, while bf16 and f32 differ by
    ~5%), and the JAX value against the constant that phase holds the card
    to."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from tacotron2_tpu.config import Config
    wn_params = convert.load_wavenet(os.path.join(R5, "wn_ckpt.msgpack"))
    batch = chip_smoke.r5_parity_batch(os.path.join(R5, "corpus"))
    jcfg = Config()
    jcfg = jcfg.replace(
        audio=dataclasses.replace(jcfg.audio, trim_silence=False),
        wavenet=dataclasses.replace(jcfg.wavenet, compute_dtype=dtype))
    out = JaxWaveNet(config=jcfg).apply({"params": wn_params}, batch["x"],
                                        batch["c"], train=False)
    want = float(jax_wavenet_loss(out, batch["y"], batch["input_lengths"],
                                  jcfg)["loss"])
    cfg = port_cfg(jcfg)
    trainer = WaveNetTrainer(cfg, device="cpu")
    model = convert.wavenet_from_flax(cfg, wn_params, "cpu", trainable=True)
    _, terms = trainer.eval_step(trainer.init_state(model=model), batch)
    if dtype == "float32":
        const, rtol = chip_smoke.R5_EMA_LOSS_JAX, chip_smoke.R5_EMA_RTOL
    else:
        const, rtol = (chip_smoke.R5_EMA_LOSS_JAX_BF16,
                       chip_smoke.R5_EMA_BF16_RTOL)
    np.testing.assert_allclose(float(terms["loss"]), want, rtol=rtol)
    np.testing.assert_allclose(want, const, rtol=1e-5)
