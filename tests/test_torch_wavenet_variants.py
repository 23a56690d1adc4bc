"""The WaveNet variants against the JAX package's, on the CPU: the 1D, 2D,
Resize and NearestNeighbor upsamples, the unconditioned model
(cin_channels -1), global conditioning with and without the speaker table,
kernel_size 2 and 4, the plain sampler at those variants, the trainer's
step and speaker-embedding export, and the refusals where JAX fails
(vocoding without local conditioning; the serving program at kernel_size
2).

Inputs are numpy arrays from seeds at tests/test_wavenet.py's tiny
configuration (R 8, G 16, S 8, cin 10; 2 layers for the model cases, 4
for the sampler's), f32 and dropout 0; the weights are the port's
`init_wavenet` draw, handed to the JAX model as a flax tree through
`convert` (the JAX side is jitted: eager flax costs ~5x). Tolerances, each an f32 computation in another
order: the upsample output 1e-5; y_hat 1e-5 relative (atol 1e-6); the
loss 1e-5 relative; each weight gradient 1e-5 of its own largest value
(floored at 1e-4 of the largest of any: a weight-normed 1-row kernel's v
has a gradient of rounding noise); the nn_init kernels bit for bit
(deterministic in both); the sampler's teacher-forced y_hat 1e-5; one
trainer step's parameters within 1e-5 (1% of one Adam step's move);
the speaker export byte for byte on the same weights.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_wavenet_train import assert_scaled, flat, port_cfg  # noqa
from test_wavenet import tiny_wn_config  # noqa: E402

from tacotron2_tpu.models.wavenet.model import WaveNet as JaxWaveNet
from tacotron2_tpu.models.wavenet.model import \
    compute_wavenet_loss as jax_wavenet_loss
from tacotron2_tpu.models.wavenet.modules import UpsampleNetwork
from tacotron2_tpu.models.wavenet.sampler import \
    incremental_sample as jax_incremental_sample
from tacotron2_tpu.synth.wavenet_synth import \
    WaveNetSynthesizer as JaxSynthesizer
from tacotron2_tpu.train.wavenet_step import WaveNetTrainer as JaxTrainer
from tacotron2_tpu.train.wavenet_step import WaveNetTrainState
from tacotron2_tpu.train.wavenet_train import \
    _export_speaker_embeddings as jax_export
from tacotron2_tpu_torch import cli, convert
from tacotron2_tpu_torch.models.wavenet.model import (compute_wavenet_loss,
                                                      data_dependent_init)
from tacotron2_tpu_torch.models.wavenet.sampler import (
    extract_sampler_params, incremental_sample)
from tacotron2_tpu_torch.synth.wavenet_synth import WaveNetSynthesizer
from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer
from tacotron2_tpu_torch.train.wavenet_train import \
    _export_speaker_embeddings

RNGS = dict(params=jax.random.PRNGKey(0), dropout=jax.random.PRNGKey(1))
GIN = 6
CASES = {
    "1D-2x3": dict(upsample_type="1D", upsample_scales=(2, 3),
                   upsample_activation="LeakyRelu"),
    "1D-4x4": dict(upsample_type="1D", upsample_scales=(4, 4)),
    "2D-2x3": dict(upsample_type="2D", upsample_scales=(2, 3),
                   upsample_activation="LeakyRelu"),
    "2D-4x4": dict(upsample_type="2D", upsample_scales=(4, 4)),
    "Resize-2x3": dict(upsample_type="Resize", upsample_scales=(2, 3),
                       upsample_activation="LeakyRelu"),
    "Resize-4x4": dict(upsample_type="Resize", upsample_scales=(4, 4)),
    "NearestNeighbor-2x3": dict(upsample_type="NearestNeighbor",
                                upsample_scales=(2, 3)),
    "NearestNeighbor-4x4": dict(upsample_type="NearestNeighbor",
                                upsample_scales=(4, 4)),
    "unconditioned": dict(cin_channels=-1),
    "gin-embedding": dict(gin_channels=GIN, use_speaker_embedding=True,
                          n_speakers=3),
    "gin-features-wn": dict(gin_channels=GIN, use_speaker_embedding=False,
                            weight_normalization=True),
    "kernel_size-2": dict(kernel_size=2),
    "kernel_size-4": dict(kernel_size=4),
}


def make_batch(jcfg, seed=0, b=2, frames=5):
    """x, y, c, input_lengths and, for a gin model, g: speaker ids [B]
    with the table, else features [B, gin]."""
    wn = jcfg.wavenet
    rng = np.random.default_rng(seed)
    T = frames * int(np.prod(wn.upsample_scales))
    x = rng.uniform(-0.5, 0.5, (b, T, 1)).astype(np.float32)
    out = dict(x=x, y=x[..., 0].copy(),
               c=rng.uniform(0, 1, (b, frames, 10)).astype(np.float32),
               input_lengths=np.asarray([T, T - 3][:b], np.int32))
    if wn.gin_channels > 0:
        out["g"] = (np.asarray([2, 0][:b], np.int32)
                    if wn.use_speaker_embedding else
                    rng.normal(size=(b, wn.gin_channels)).astype(np.float32))
    return out


def jax_params(jcfg, batch, seed=0):
    """Weights for both packages: the port's `init_wavenet` draw as a flax
    tree, its paths and shapes held to the flax init's (`jax.eval_shape`:
    a compiled flax init costs seconds a config)."""
    tree = convert.wavenet_to_flax(convert.init_wavenet(
        port_cfg(jcfg), torch.Generator().manual_seed(seed), "cpu",
        global_conditioning="g" in batch))
    m = JaxWaveNet(config=jcfg)
    shapes = jax.eval_shape(
        lambda x, c, g: m.init(RNGS, x, c, g, train=False),
        batch["x"], batch["c"], batch.get("g"))["params"]
    assert {k: v.shape for k, v in flat(tree).items()} == \
        {k: tuple(v.shape) for k, v in flat(shapes).items()}
    return tree


def tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_variant_matches_jax(case):
    """The train forward's y_hat and loss and every weight gradient
    against jax.value_and_grad of the flax model on the same weights; the
    upsample output against `WaveNet.upsample`; `init_wavenet`'s nn_init
    kernels against flax's init of the upsample network bit for bit; the
    flax tree round trip."""
    jcfg = tiny_wn_config(layers=2, stacks=1, **CASES[case])
    batch = make_batch(jcfg)
    params = jax_params(jcfg, batch)
    jmodel = JaxWaveNet(config=jcfg)
    g = batch.get("g")

    def jloss(p):
        out = jmodel.apply({"params": p}, batch["x"], batch["c"], g,
                           train=True, rngs={"dropout": RNGS["dropout"]})
        return jax_wavenet_loss(out, batch["y"], batch["input_lengths"],
                                jcfg)["loss"], out.y_hat

    (lj, yj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    cfg = port_cfg(jcfg)
    model = convert.wavenet_from_flax(cfg, params, "cpu", trainable=True)
    b = tensors(batch)
    y_hat, c_up = model.train_forward(b["x"], b["c"], b.get("g"),
                                      train=True, seed=0)
    loss = compute_wavenet_loss(y_hat, b["y"], batch["input_lengths"],
                                cfg)["loss"]
    loss.backward()
    np.testing.assert_allclose(y_hat.detach().numpy(), np.asarray(yj),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    want = flat(jax.tree_util.tree_map(np.asarray, gj))
    got = {path: convert.wavenet_flax_array(
        path, p.grad if p.grad is not None else torch.zeros_like(p))
        for path, p in convert.wavenet_named_parameters(model)}
    assert set(got) == set(want)
    floor = 1e-4 * max(np.abs(v).max() for v in want.values())
    for path in want:
        assert_scaled(got[path], want[path], 1e-5, floor, path)
    back = flat(convert.wavenet_to_flax(model))
    assert set(back) == set(flat(params))
    for path, v in flat(params).items():
        np.testing.assert_array_equal(back[path], v, err_msg=path)
    if cfg.wavenet.cin_channels <= 0:
        assert c_up is None and "upsample_network" not in params
        return
    want_up = jax.jit(lambda p, c: jmodel.apply(
        {"params": p}, c, method=JaxWaveNet.upsample))(params, batch["c"])
    np.testing.assert_allclose(c_up.detach().numpy(), np.asarray(want_up),
                               rtol=0, atol=1e-5)
    wn = jcfg.wavenet
    net = UpsampleNetwork(
        upsample_type=wn.upsample_type, scales=tuple(wn.upsample_scales),
        freq_kernel=wn.freq_axis_kernel_size, cin_channels=wn.cin_channels,
        activation=wn.upsample_activation, leaky_alpha=wn.leaky_alpha,
        nn_init=wn.nn_init, nn_scaler=wn.nn_scaler)
    flax_up = flat(jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda c: net.init(RNGS["params"], c))(batch["c"]).get("params",
                                                              {})))
    kernels = [p for p in flax_up if p.endswith("kernel")]
    assert len(kernels) == (0 if wn.upsample_type == "NearestNeighbor"
                            else len(wn.upsample_scales))
    for path in kernels:
        np.testing.assert_array_equal(
            flat(params)[f"upsample_network/{path}"], flax_up[path],
            err_msg=path)


@pytest.mark.parametrize("case", ["gin-embedding", "gin-features-wn"])
def test_global_conditioning_trainer_step_and_export(case, tmp_path):
    """One `WaveNetTrainer` step on a batch with "g" against the JAX
    trainer's from the same weights (loss, grad_norm, parameters, EMA);
    the speaker-embedding export identical to JAX's on the same weights
    (the features model has no table: both write nothing); a fresh
    `init_state` gets the speaker input only from a batch that carries
    "g", as flax's init does."""
    jcfg = tiny_wn_config(layers=2, stacks=1, **CASES[case])
    batch = make_batch(jcfg, seed=1)
    params = jax_params(jcfg, batch)
    jt = JaxTrainer(jcfg)
    js = WaveNetTrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                           params=params, ema_params=params,
                           opt_state=jt.tx.init(params))
    cfg = port_cfg(jcfg)
    tt = WaveNetTrainer(cfg, device="cpu")
    ts = tt.init_state(model=convert.wavenet_from_flax(cfg, params, "cpu",
                                                       trainable=True))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jax_export(jcfg, js, str(jdir))
    _export_speaker_embeddings(cfg, ts, str(tdir))
    names = ("embeddings.tsv", "metadata.tsv")
    if cfg.wavenet.use_speaker_embedding:
        for n in names:
            assert (tdir / "speaker_embeddings" / n).read_bytes() == \
                (jdir / "speaker_embeddings" / n).read_bytes()
        rows = (tdir / "speaker_embeddings" / names[0]).read_text()
        assert len(rows.splitlines()) == 3
    else:
        assert not jdir.exists() and not tdir.exists()
    js, mj = jax.jit(jt.train_step)(js, batch, jax.random.PRNGKey(0))
    ts, mt = tt.train_step(ts, batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-4)
    for tree, mod in ((js.params, ts.model), (js.ema_params, ts.ema)):
        want = flat(jax.tree_util.tree_map(np.asarray, tree))
        got = flat(convert.wavenet_to_flax(mod))
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=0,
                                       atol=1e-5, err_msg=path)
    fresh = tt.init_state(torch.Generator().manual_seed(0), batch)
    assert fresh.model.global_conditioning
    assert (fresh.model.gc_embedding is not None) == \
        cfg.wavenet.use_speaker_embedding
    bare = {k: v for k, v in batch.items() if k != "g"}
    cfg_plain = dataclasses.replace(cfg.wavenet, weight_normalization=False)
    plain = WaveNetTrainer(cfg.replace(wavenet=cfg_plain), device="cpu")
    assert not plain.init_state(torch.Generator().manual_seed(0),
                                bare).model.global_conditioning


def test_data_dependent_init_with_global_conditioning():
    """Weight norm's data-dependent init of a model whose blocks take the
    speaker features: the gin_conv is initialised in execution order with
    the rest, so afterwards every weight-normed conv's output on the batch
    has per-channel mean 0 and standard deviation 1, the property the JAX
    package's own test holds its init to (tests/test_wavenet_train.py:
    test_data_dependent_init_normalizes_preactivations; the path without a
    speaker is held against JAX's `data_dependent_init` in
    tests/test_torch_wavenet_train.py)."""
    from tacotron2_tpu_torch.models.wavenet.modules import _WeightNormed
    jcfg = tiny_wn_config(layers=2, stacks=1, **CASES["gin-features-wn"])
    batch = make_batch(jcfg, seed=2)
    cfg = port_cfg(jcfg)
    model = convert.wavenet_from_flax(cfg, jax_params(jcfg, batch), "cpu",
                                      trainable=True)
    gin_g = model.residual_blocks[0].gin_conv.g.detach().clone()
    b = tensors(batch)
    data_dependent_init(model, b["x"], b["c"], b["g"])
    assert not torch.equal(model.residual_blocks[0].gin_conv.g, gin_g)
    convs = [m for m in model.modules() if isinstance(m, _WeightNormed)]
    for m in convs:
        m.capture = True
    with torch.no_grad():
        model.train_forward(b["x"], b["c"], b["g"], train=False)
    for m in convs:
        out = m.wn_out.reshape(-1, m.wn_out.shape[-1]).double()
        np.testing.assert_allclose(out.mean(0).numpy(), 0.0, atol=1e-4)
        np.testing.assert_allclose(out.std(0, unbiased=False).numpy(), 1.0,
                                   atol=1e-3)
    assert len(convs) == 2 * 5 + 3


SAMPLER_CASES = {"kernel_size-2": dict(kernel_size=2),
                 "kernel_size-4": dict(kernel_size=4),
                 "gin": dict(gin_channels=GIN),
                 "unconditioned": dict(cin_channels=-1)}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_plain_sampler_matches_jax(case):
    """The plain sampler teacher-forced on a waveform (the PRNG-free
    oracle: each step's input is the given sample, so no draw enters
    y_hat) against JAX `incremental_sample`: rings of (kw-1)·d + 1 at
    kernel_size 2 and 4, the speaker's g_vec, and zero-width conditioning
    [B, T, 0] for the unconditioned model."""
    jcfg = tiny_wn_config(**SAMPLER_CASES[case])
    wn = jcfg.wavenet
    batch = make_batch(jcfg, seed=3)
    params = jax_params(jcfg, batch)
    rng = np.random.default_rng(4)
    B, T = batch["x"].shape[:2]
    width = max(wn.cin_channels, 0)
    c_up = rng.uniform(0, 1, (B, T, width)).astype(np.float32)
    g_vec = batch.get("g")
    x = batch["x"]
    tf = np.concatenate([x[:, 1:], np.zeros((B, 1, 1), np.float32)], 1)
    _, want = jax.jit(lambda p, c, g: jax_incremental_sample(
        p, jcfg, c, jax.random.PRNGKey(0), g_vec=g, initial_input=x[:, 0],
        test_inputs=tf))(params, c_up, g_vec)
    cfg = port_cfg(jcfg)
    sp = extract_sampler_params(params, cfg, "cpu")
    assert (sp.layers[0].gin_w is not None) == (case == "gin")
    assert (sp.layers[0].cin_w is None) == (case == "unconditioned")
    _, got = incremental_sample(
        sp, cfg, torch.as_tensor(c_up), torch.zeros(B, T),
        torch.as_tensor(x[:, 0]), torch.as_tensor(tf),
        g_vec=None if g_vec is None else torch.as_tensor(g_vec),
        return_y_hat=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    if case == "gin":         # the speaker moves y_hat: g_vec was used
        _, bare = incremental_sample(
            sp, cfg, torch.as_tensor(c_up), torch.zeros(B, T),
            torch.as_tensor(x[:, 0]), torch.as_tensor(tf),
            return_y_hat=True)
        assert np.abs(bare.numpy() - got.numpy()).max() > 1e-3


def test_unconditioned_vocoder_refused_where_jax_fails(tmp_path,
                                                       monkeypatch):
    """cin_channels -1 has no upsample network: the JAX synthesizer and
    the JAX model's `upsample` (what the JAX program calls, pipeline.py:
    221-224) fail with an AttributeError; the port's WaveNetSynthesizer,
    TextToWavProgram and `cli synthesize --model WaveNet` raise
    ValueError there."""
    from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
    from torch_port_helpers import inputs, torch_cfg
    jcfg = tiny_wn_config(cin_channels=-1)
    batch = make_batch(jcfg)
    params = jax_params(jcfg, batch)
    mel = np.random.default_rng(5).uniform(-4, 4, (6, 10)).astype(
        np.float32)
    with pytest.raises(AttributeError, match="upsample_network"):
        JaxSynthesizer(jcfg, params).synthesize([mel])
    with pytest.raises(AttributeError, match="upsample_network"):
        JaxWaveNet(config=jcfg).apply({"params": params}, mel[None],
                                      method=JaxWaveNet.upsample)
    cfg = port_cfg(jcfg)
    synth = WaveNetSynthesizer(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="cin_channels"):
        synth.synthesize([mel])
    np.save(tmp_path / "m.npy", mel)
    (tmp_path / "map.txt").write_text(f"{tmp_path / 'm.npy'}|t\n")
    monkeypatch.setattr(cli, "get_config", lambda preset, hp: cfg)
    monkeypatch.setattr(convert, "load_wavenet", lambda p: params)
    with pytest.raises(ValueError, match="cin_channels"):
        cli.main(["synthesize", "--model", "WaveNet", "--device", "cpu",
                  "--mels-map", str(tmp_path / "map.txt"),
                  "--wavenet-checkpoint", "w", "--output-dir",
                  str(tmp_path / "o")])
    tcfg = torch_cfg()
    tcfg = tcfg.replace(wavenet=dataclasses.replace(tcfg.wavenet,
                                                    cin_channels=-1))
    taco = convert.init_tacotron(tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    tparams, stats = convert.tacotron_to_flax(taco)
    wparams = convert.wavenet_to_flax(convert.init_wavenet(
        tcfg, torch.Generator().manual_seed(1), "cpu"))
    ids, lengths, refs = inputs()
    prog = TextToWavProgram(tcfg, tparams, stats, wparams, batch=1, steps=2,
                            t_in=ids.shape[1], t_ref=refs.shape[1],
                            device="cpu")
    with pytest.raises(ValueError, match="cin_channels"):
        prog(torch.as_tensor(ids[:1]), torch.as_tensor(lengths[:1]),
             torch.as_tensor(refs[:1]), torch.as_tensor(refs[:1]))


def test_program_refuses_kernel_size_where_jax_asserts():
    """The serving program at kernel_size 2: the JAX program's sampler
    kernel asserts kernel_size 3 when it is built (ops/wavenet_kernel.py:
    219); the port's TextToWavProgram raises ValueError there (the
    per-stage WaveNetSynthesizer samples it, as JAX's scan does)."""
    from tacotron2_tpu.ops.wavenet_kernel import build_sampler_kernel
    from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
    from torch_port_helpers import torch_cfg
    jcfg = tiny_wn_config(kernel_size=2)
    with pytest.raises(AssertionError, match="kernel_size=3"):
        build_sampler_kernel(jcfg, 2, 16, chunk=16, interpret=True)
    tcfg = torch_cfg()
    tcfg = tcfg.replace(wavenet=dataclasses.replace(tcfg.wavenet,
                                                    kernel_size=2))
    with pytest.raises(ValueError, match="kernel_size"):
        TextToWavProgram(tcfg, {}, {}, {}, batch=1, steps=2, t_in=8,
                         device="cpu")


def test_kernel_weights_drop_the_speaker_and_zero_absent_conditioning():
    """The sampler kernel's packed operands (`wavenet_kernel.pack_weights`,
    built here on the CPU): a gin model's equal the same model's without
    its gin convs, as the TPU kernel's `_stack_weights` drops them (JAX
    ops/wavenet_kernel.py:591-626); a model without local conditioning
    (cin_channels 0) packs what zero cin weights pack, as
    `_stack_weights` fills them."""
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    widths = dict(residual_channels=16, gate_channels=32,
                  skip_out_channels=16)
    for kw, strip in ((dict(gin_channels=GIN), "gin"),
                      (dict(cin_channels=0), "cin")):
        jcfg = tiny_wn_config(**widths, **kw)
        params = jax_params(jcfg, make_batch(jcfg))
        cfg = port_cfg(jcfg)
        other = {k: dict(v) for k, v in params.items()}
        for i in range(cfg.wavenet.layers):
            blk = other[f"residual_block_{i}"]
            if strip == "gin":
                del blk["gin_conv"]
            else:
                blk["cin_conv"] = {"Dense_0": {
                    "kernel": np.zeros((0, 32), np.float32),
                    "bias": np.zeros(32, np.float32)}}
        for wd in (torch.float32, torch.bfloat16):
            a, b = (wk.pack_weights(extract_sampler_params(p, cfg, "cpu"),
                                    cfg, weight_dtype=wd)
                    for p in (params, other))
            assert torch.equal(a.slices, b.slices), (strip, wd)
            assert a.slices.shape[1] == cfg.wavenet.layers
