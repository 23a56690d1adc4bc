"""The port's WaveNet synthesis stage against the JAX package's, on the CPU:
`WaveNetSynthesizer` (synthesize, synthesize_debug), `run_synthesis`,
`cli synthesize --model WaveNet | Tacotron-2`, and the serving program's
other heads and its bf16 sampler rule.

The JAX synthesizer runs as it does on a CPU (the XLA scan sampler with
jax.random noise), so the comparisons use heads whose draw does not depend
on the noise: the Gaussian and mixture heads with their noise suppressed
(tests/test_pallas_kernels.py:20,64: every draw is the mean) and the
categorical head with its logits sharpened ×30000 (every draw is the
argmax). Tolerances: wavs atol 2e-4 (samples; f32 both sides, other sum
order over 4 layers and the fed-back samples, as tests/test_pallas_
kernels.py:94), categorical classes exact (so the inverted wavs agree to
f32 rounding, atol 1e-6); `synthesize_debug` 1e-4 (one teacher-forced
forward); the serving program's samples atol 2e-3 / rtol 1e-2
(tests/test_pipeline_program.py's chain bound, as tests/test_torch_
pipeline.py).
"""

import dataclasses
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.wavenet.model import WaveNet as FlaxWaveNet
from tacotron2_tpu.synth.pipeline import TextToWavProgram as JaxProgram
from tacotron2_tpu.synth.wavenet_synth import \
    WaveNetSynthesizer as JaxSynthesizer
from tacotron2_tpu_torch import cli
from tacotron2_tpu_torch.ops import wavenet_kernel as wk
from tacotron2_tpu_torch.ops.mulaw import inv_mulaw_quantize, mulaw_quantize
from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
from tacotron2_tpu_torch.synth.wavenet_synth import (WaveNetSynthesizer,
                                                     run_synthesis)
from test_torch_wavenet import MELS, Q, head_cfg, head_setup
from torch_port_helpers import (B as PB, STEPS, T_IN, T_REF, flax_weights,
                                inputs, small_cfg, to_numpy, torch_cfg)
from tacotron2_tpu_torch.config import Config as TorchConfig

NOISE = {"gaussian": "suppressed", "mol": "suppressed",
         "categorical": "sharp"}


def _mels(n=3, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-4, 4, (f, MELS)).astype(np.float32)
            for f in (9, 12, 7)[:n]]


def _synths(kind, **kw):
    params, _, _ = head_setup(kind, NOISE[kind])
    js = JaxSynthesizer(head_cfg(kind), params, seed=0)
    ts = WaveNetSynthesizer(head_cfg(kind, TorchConfig), params,
                            device="cpu", **kw)
    return js, ts


@pytest.mark.parametrize("kind", ["gaussian", "mol", "categorical"])
def test_synthesize_matches_jax(kind):
    js, ts = _synths(kind, keep_intermediates=True)
    mels = _mels()
    want = js.synthesize(mels)
    got = ts.synthesize(mels)
    assert [len(w) for w in got] == [len(m) * 4 for m in mels]
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape
        if kind == "categorical":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            assert np.abs(b).max() > 1e-3
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4)
    # the noise is drawn per call from a counter that starts at `seed`
    n1 = ts.intermediates["noise"].clone()
    ts.synthesize(mels)
    assert ts._seed_counter == 2
    assert not torch.equal(n1, ts.intermediates["noise"])
    assert n1.shape[0] == (2 if kind == "mol" else 1)


def test_synthesize_inverts_mulaw():
    """mulaw input: the sampler's companded samples are expanded again."""
    params, _, _ = head_setup("gaussian", "suppressed")
    cfg = head_cfg("gaussian", TorchConfig, input_type="mulaw",
                   quantize_channels=256)
    js = JaxSynthesizer(head_cfg("gaussian", input_type="mulaw",
                                 quantize_channels=256), params)
    ts = WaveNetSynthesizer(cfg, params, device="cpu")
    for a, b in zip(ts.synthesize(_mels(2)), js.synthesize(_mels(2))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)


@pytest.mark.parametrize("kind", ["gaussian", "mol"])
def test_synthesize_debug_matches_jax(kind):
    js, ts = _synths(kind)
    params, _, _ = head_setup(kind, NOISE[kind])
    mels = _mels()
    rng = np.random.default_rng(2)
    wavs = [rng.uniform(-0.5, 0.5, len(m) * 4 + 3).astype(np.float32)
            for m in mels]
    want = js.synthesize_debug(wavs, mels)
    noise = None
    if kind == "mol":
        # the uniforms the JAX path draws from PRNGKey(0), handed over
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        shape = (len(mels), max(len(m) for m in mels) * 4)
        noise = (np.array(jax.random.uniform(k1, shape + (10,),
                                             minval=1e-5, maxval=1 - 1e-5)),
                 np.array(jax.random.uniform(k2, shape, minval=1e-5,
                                             maxval=1 - 1e-5)))
    got = ts.synthesize_debug(wavs, mels, noise=noise)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    if kind == "mol":             # its own uniforms: a draw, within range
        own = ts.synthesize_debug(wavs, mels)
        assert all(np.abs(w).max() <= 1.0 for w in own)


def test_synthesize_debug_categorical_feeds_the_one_hot():
    """For mulaw-quantize the teacher-forced input is the one-hot of the
    quantized waveform; the prediction is the forward's argmax class,
    inverted (checked against flax `apply` on the same one-hot)."""
    params, c, _ = head_setup("categorical", "live")
    ts = WaveNetSynthesizer(head_cfg("categorical", TorchConfig), params,
                            device="cpu")
    mels = _mels(2)
    wavs = [np.sin(np.arange(len(m) * 4) / 3.0).astype(np.float32) * 0.5
            for m in mels]
    got = ts.synthesize_debug(wavs, mels)
    c_prep, _ = ts._prepare_mels(mels)
    T = c_prep.shape[1] * 4
    x = np.zeros((2, T), np.float32)
    for i, w in enumerate(wavs):
        x[i, :len(w)] = w
    oh = np.eye(Q, dtype=np.float32)[np.asarray(
        mulaw_quantize(x, Q - 1), np.int64)]
    out = FlaxWaveNet(config=head_cfg("categorical")).apply(
        {"params": params}, jnp.asarray(oh), jnp.asarray(c_prep),
        train=False)
    want = inv_mulaw_quantize(np.asarray(out.y_hat).argmax(-1), Q - 1)
    for i, (g, m) in enumerate(zip(got, mels)):
        np.testing.assert_allclose(g, want[i, :len(m) * 4], rtol=0,
                                   atol=1e-6)


def test_run_synthesis_writes_wavs_and_pads_the_last_batch(tmp_path):
    _, ts = _synths("gaussian")
    mels = _mels()
    rows = []
    for i, m in enumerate(mels):
        p = tmp_path / f"mel-{i}.npy"
        np.save(p, m)
        # eval rows name the mel in column 0, GTA rows (>= 4 columns) in 2
        rows.append(f"{p}|text {i}" if i != 1 else
                    f"audio.npy|x|{p}|10|11|text 1")
    (tmp_path / "map.txt").write_text("\n".join(rows) + "\n")
    calls = []
    orig = ts.synthesize
    ts.synthesize = lambda ms: calls.append(len(ms)) or orig(ms)
    paths = run_synthesis(ts, str(tmp_path / "map.txt"),
                          str(tmp_path / "out"), batch_size=2)
    assert calls == [2, 2]                 # the last batch filled to 2
    assert [os.path.basename(p) for p in paths] == \
        [f"wavenet-mel-{i}.wav" for i in range(3)]
    want = orig(mels)
    for p, m, w in zip(paths, mels, want):
        with wave.open(p, "rb") as f:
            n = f.getnframes()
            pcm = np.frombuffer(f.readframes(n), "<i2").astype(np.float32)
        assert n == len(m) * 4
        # save_wav peak-normalises to int16
        np.testing.assert_allclose(pcm / 32767, w / np.abs(w).max(),
                                   atol=2e-4)
    assert len(run_synthesis(ts, str(tmp_path / "map.txt"),
                             str(tmp_path / "lim"), limit=1)) == 1


# ------------------------------------------------------------------- CLI

def _cli_cfg(cls):
    cfg = small_cfg(cls)
    return cfg.replace(
        audio=dataclasses.replace(cfg.audio, n_fft=256, win_size=200,
                                  griffin_lim_iters=3),
        tacotron=dataclasses.replace(cfg.tacotron, early_stop_block=4,
                                     fused_block_steps=4, max_iters=STEPS))


@pytest.fixture
def cli_weights(monkeypatch):
    tparams, stats, wparams = flax_weights()
    monkeypatch.setattr(cli, "get_config",
                        lambda preset, hp: _cli_cfg(TorchConfig))
    import tacotron2_tpu_torch.convert as conv
    monkeypatch.setattr(conv, "load_checkpoints",
                        lambda a, b=None: (tparams, stats, None))
    monkeypatch.setattr(conv, "load_wavenet", lambda p: wparams)
    return tparams, stats, wparams


def test_cli_synthesize_tacotron2(tmp_path, cli_weights):
    """--model Tacotron-2 (the default): eval mels and map.txt, then one
    WaveNet wav per text, frames · hop samples each."""
    ref = tmp_path / "ref.npy"
    np.save(ref, inputs()[2][0])
    texts = tmp_path / "texts.txt"
    texts.write_text("hello there.\na b c d e.\nok.\n", encoding="utf-8")
    out = tmp_path / "out"
    paths = cli.main([
        "synthesize", "--checkpoint", "x", "--wavenet-checkpoint", "y",
        "--device", "cpu", "--output-dir", str(out), "--ref-mel-emt",
        str(ref), "--text-list", str(texts)])
    rows = (out / "eval" / "map.txt").read_text().splitlines()
    assert len(rows) == 3 and len(paths) == 3
    hop = small_cfg().audio.effective_hop
    for i, p in enumerate(paths):
        assert p == str(out / "wavenet" / "wavs" / f"wavenet-mel-eval-{i}.wav")
        mel = np.load(rows[i].split("|")[0])
        with wave.open(p, "rb") as f:
            assert f.getnframes() == mel.shape[0] * hop
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        assert np.abs(pcm).max() == 32767     # peak-normalised speech


def test_cli_synthesize_wavenet(tmp_path, cli_weights):
    """--model WaveNet vocodes an existing map (--mels-map, --limit) and
    needs --wavenet-checkpoint; --model Tacotron still needs --checkpoint;
    with --mode gta the default map is <output-dir>/gta/map.txt, whose
    rows name the GTA mel in column 2 (JAX cli.py:290-291)."""
    _, _, wparams = cli_weights
    for i in range(3):
        np.save(tmp_path / f"m{i}.npy", _mels(3, seed=i)[i][:, :20])
    (tmp_path / "map.txt").write_text("".join(
        f"{tmp_path / f'm{i}.npy'}|t{i}\n" for i in range(3)))
    base = ["synthesize", "--model", "WaveNet", "--device", "cpu",
            "--mels-map", str(tmp_path / "map.txt"), "--output-dir",
            str(tmp_path / "o")]
    paths = cli.main(base + ["--wavenet-checkpoint", "y", "--limit", "2"])
    assert [os.path.basename(p) for p in paths] == ["wavenet-m0.wav",
                                                    "wavenet-m1.wav"]
    for bad, msg in ((base, "wavenet-checkpoint"),
                     (["synthesize", "--model", "Tacotron"], "--checkpoint"),
                     (base + ["--mode", "gta"], "wavenet-checkpoint")):
        with pytest.raises(SystemExit, match=msg):
            cli.main(bad)
    gta = tmp_path / "o2" / "gta"
    gta.mkdir(parents=True)
    (gta / "map.txt").write_text(
        f"a.npy|gt.npy|{tmp_path / 'm2.npy'}|12|t2\n")
    paths = cli.main(base[:5] + ["--output-dir", str(tmp_path / "o2"),
                                 "--mode", "gta", "--wavenet-checkpoint",
                                 "y"])
    assert [os.path.basename(p) for p in paths] == ["wavenet-m2.wav"]


# ------------------------------------------------------- serving program


def _mol_tree():
    """Flax WaveNet weights of the helpers' small config with the MoL head,
    its noise suppressed as _setup_mol does."""
    cfg = small_cfg()
    cfg = cfg.replace(wavenet=dataclasses.replace(cfg.wavenet,
                                                  out_channels=30))
    frames = STEPS * cfg.tacotron.outputs_per_step
    params = to_numpy(FlaxWaveNet(config=cfg).init(
        dict(params=jax.random.PRNGKey(4), dropout=jax.random.PRNGKey(5)),
        jnp.zeros((1, frames * 4, 1)), jnp.zeros((1, frames, 20)),
        train=False)["params"])
    fc2 = params["final_convolution_2"]["Dense_0"]
    fc2["kernel"], fc2["bias"] = fc2["kernel"].copy(), fc2["bias"].copy()
    fc2["bias"][0], fc2["bias"][1:10], fc2["bias"][20:30] = 100, -100, -30
    fc2["kernel"][:, 0:10] = fc2["kernel"][:, 20:30] = 0.0
    return params


def test_program_serves_the_mol_head_like_jax():
    tparams, stats, _ = flax_weights()
    wparams = _mol_tree()
    mol = lambda cfg: cfg.replace(wavenet=dataclasses.replace(
        cfg.wavenet, out_channels=30))
    jp = JaxProgram(mol(small_cfg()), tparams, stats, wparams, batch=PB,
                    steps=STEPS, t_in=T_IN, t_ref=T_REF, taco_chunk=2,
                    upsample_chunk=2, interpret=True)
    tp = TextToWavProgram(mol(torch_cfg()), tparams, stats, wparams,
                          batch=PB, steps=STEPS, t_in=T_IN, t_ref=T_REF,
                          device="cpu", keep_intermediates=True)
    ids, lengths, refs = inputs()
    want = np.asarray(jp(ids, lengths, refs, refs)[0])
    got = tp(ids, lengths, refs, refs)[0].numpy()
    assert tp.intermediates["noise"].shape == (2, PB, tp.t_audio)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-2)


def test_program_sampler_dtype_rule():
    """sampler_bf16=None: f32 on the CPU (bf16 on a CUDA device, the JAX
    program's rule); True: bf16 cache and weights, each within the JAX
    package's drift bound of the f32 program; the config's
    sampler_*_dtype="bfloat16" forces bf16 for that operand alone."""
    tparams, stats, wparams = flax_weights()
    ids, lengths, refs = inputs()
    mk = lambda cfg=torch_cfg(), **kw: TextToWavProgram(
        cfg, tparams, stats, wparams, batch=PB, steps=STEPS, t_in=T_IN,
        t_ref=T_REF, device="cpu", keep_intermediates=True, **kw)
    f32, bf = mk(), mk(sampler_bf16=True)
    assert (f32.cache_dtype, f32.weight_dtype) == (torch.float32,) * 2
    assert (bf.cache_dtype, bf.weight_dtype) == (torch.bfloat16,) * 2
    cfg = torch_cfg()
    forced = mk(cfg.replace(wavenet=dataclasses.replace(
        cfg.wavenet, sampler_cache_dtype="bfloat16")), sampler_bf16=False)
    assert (forced.cache_dtype, forced.weight_dtype) == \
        (torch.bfloat16, torch.float32)
    s32 = f32(ids, lengths, refs, refs)[0]
    sbf = bf(ids, lengths, refs, refs)[0]
    err = float((s32 - sbf).abs().max())
    assert 0 < err < 0.1, err
    im = bf.intermediates
    plain = wk.sample_plain(bf.sampler_params, bf.cfg, im["c_up"],
                            im["noise"], cache_dtype=torch.bfloat16,
                            weight_dtype=torch.bfloat16)
    assert torch.equal(plain, sbf)
