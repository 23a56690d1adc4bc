"""The port's long tail against the JAX package, on the CPU: the reference's
in-graph (TF-semantics) Griffin-Lim, the bf16 Griffin-Lim mode, WER and
the blind A/B tools, the native data-IO runtime, `cli live` and the
reference_depth question of the emt_attn decode.

- `griffin_lim_tf` and `inv_*_tfgl` meet tests/test_reference_parity.py's
  gates against the TF-made golden fixture (iters 0 and 2: 2e-4 and 2e-3
  of the peak; 60: 5% of the peak, also through the mel inversion), both
  presets, and match JAX's jitted functions at 2 iterations within 1e-3 of
  the peak (f32 DFT products in another sum order).
- bf16: the plain version's `gl_compute_dtype="bfloat16"` against JAX's
  bf16 path on tests/test_audio.py's chirp. Where each rounds differs (JAX
  rounds every XLA op's output, the port only the operands and keeps f32
  sums), so the bound is on spectral consistency, the mean |STFT| distance
  to the source: the port's within BF16_DRIFT (2%) of JAX's bf16 value,
  and under JAX's own bound against its f32 path (10% + 1e-4,
  tests/test_audio.py:221); waveform correlation with JAX's bf16 output
  above 0.999 (0.99997 seen). The same bounds hold the FFT route's bf16
  plain version (`griffin_lim_fft_plain`).
- WER and A/B: tests/test_eval_tools.py's cases through both packages.
- The native runtime (built with g++, skipped only where no C++ compiler
  exists) against np.load and the JAX binding's numpy path: every dtype,
  the parallel batch, μ-law, the WAV round trip; the feeders load through
  it.
- `cli live --pipeline` on a stdin of two lines writes the wavs that `cli
  serve` writes from the same stdin; `cli live` without --pipeline the
  wav `cli synthesize --sentence` writes.
- reference_depth 64, emt_attn simple with ref_spk: the port's decode
  equals the flax scan; JAX's kernel extraction takes reference_depth rows
  of LSTM1 for the 128-wide ref_spk and so fails on this tree (a fault of
  the reference, ROADMAP.md).
"""

import csv
import dataclasses
import io as stdio
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.config import AudioConfig as JaxAudioConfig
from tacotron2_tpu.config import get_config as jax_get_config
from tacotron2_tpu.eval import human_eval as jax_ab
from tacotron2_tpu.eval import wer as jax_wer
from tacotron2_tpu.ops import griffin_lim as jgl
from tacotron2_tpu.ops import stft as jstft
from tacotron2_tpu_torch import cli
from tacotron2_tpu_torch.config import AudioConfig
from tacotron2_tpu_torch.config import get_config
from tacotron2_tpu_torch.eval import human_eval, wer
from tacotron2_tpu_torch.native import build as native_build
from tacotron2_tpu_torch.native import io as nat
from tacotron2_tpu_torch.ops import griffin_lim as gl
from tacotron2_tpu_torch.ops import griffin_lim_kernel as glk
from tacotron2_tpu_torch.ops import stft as tst

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "golden_dsp.npz")
PRESETS = ["default", "paper"]
BF16_DRIFT = 0.02


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURES)


# ------------------------------------------------- TF-semantics Griffin-Lim

@pytest.mark.parametrize("preset", PRESETS)
def test_tf_griffin_lim_meets_the_golden_gates(golden, preset):
    """tests/test_reference_parity.py:103-142's gates, and JAX's jitted
    `griffin_lim_tf` at 2 iterations."""
    cfg = get_config(preset).audio
    pw = golden[f"{preset}/gl_input_pow"]
    S = torch.from_numpy(pw)
    args = (cfg.n_fft, cfg.effective_hop, cfg.win_size)
    for iters, atol in ((0, 2e-4), (2, 2e-3)):
        ref = golden[f"{preset}/gl_tf_iters{iters}"]
        ours = gl.griffin_lim_tf(S, *args, iters).numpy()
        assert ours.shape == ref.shape
        scale = max(1e-3, np.abs(ref).max())
        assert np.abs(ours - ref).max() < atol * scale, iters
        if iters == 2:
            want = np.asarray(jgl.griffin_lim_tf(jnp.asarray(pw), *args, 2))
            assert np.abs(ours - want).max() < 1e-3 * scale
    ref = golden[f"{preset}/gl_tf_iters60"]
    ours = gl.griffin_lim_tf(S, *args, 60).numpy()
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 0.05
    ours = gl.inv_mel_spectrogram_tfgl(
        torch.from_numpy(golden[f"{preset}/mel"]), cfg).numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 0.05


def test_tf_stft_and_linear_inversion_match_jax(golden):
    """`stft_tf`, `frame_uncentered` and `inv_linear_spectrogram_tfgl` (2
    iterations) against JAX's."""
    from tacotron2_tpu_torch.ops import stft as st
    cfg = get_config("default").audio
    wav = golden["default/wav"][:6000]
    args = (cfg.n_fft, cfg.effective_hop, cfg.win_size)
    re, im = st.stft_tf(torch.from_numpy(wav), *args)
    jre, jim = jstft.stft_tf(jnp.asarray(wav), *args)
    scale = float(np.abs(np.asarray(jre)).max())
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_array_equal(
        st.frame_uncentered(torch.from_numpy(wav[:1001]), 400, 100).numpy(),
        np.asarray(jstft.frame_uncentered(jnp.asarray(wav[:1001]), 400,
                                          100)))
    lin = golden["default/linear"][:40]
    c2 = dataclasses.replace(cfg, griffin_lim_iters=2)
    jc2 = dataclasses.replace(jax_get_config("default").audio,
                              griffin_lim_iters=2)
    got = gl.inv_linear_spectrogram_tfgl(torch.from_numpy(lin), c2).numpy()
    want = np.asarray(jgl.inv_linear_spectrogram_tfgl(jnp.asarray(lin),
                                                      jc2))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-3 * np.abs(want).max()


# --------------------------------------------------------- bf16 Griffin-Lim

def _chirp(sr, dur=0.3):
    t = np.linspace(0, dur, int(sr * dur), endpoint=False)
    return (0.5 * np.sin(2 * np.pi * (200 + 400 * t) * t)).astype(np.float32)


def test_bf16_griffin_lim_stays_within_its_drift_of_jax():
    """The bf16 mode's plain version against JAX's bf16 path (and both f32
    paths) on tests/test_audio.py's chirp, n_fft 512, 8 iterations."""
    over = dict(n_fft=512, win_size=400, hop_size=128, griffin_lim_iters=8,
                preemphasize=False, trim_silence=False)
    jc = dataclasses.replace(JaxAudioConfig(), **over)
    tc = dataclasses.replace(AudioConfig(), **over)
    y = _chirp(jc.sample_rate)
    mel = np.asarray(jstft.mel_spectrogram(jnp.asarray(y), jc))

    def consistency(w):
        mag = np.asarray(jstft.stft_mag(jnp.asarray(w), 512, 128, 400))
        tgt = np.asarray(jstft.stft_mag(jnp.asarray(y[:w.shape[-1]]), 512,
                                        128, 400))
        return float(np.mean(np.abs(mag - tgt)))

    j32 = np.asarray(jgl.inv_mel_spectrogram(mel, jc))
    j16 = np.asarray(jgl.inv_mel_spectrogram(
        mel, dataclasses.replace(jc, gl_compute_dtype="bfloat16")))
    p32 = gl.inv_mel_spectrogram(torch.from_numpy(mel.copy()), tc).numpy()
    p16 = gl.inv_mel_spectrogram(
        torch.from_numpy(mel.copy()),
        dataclasses.replace(tc, gl_compute_dtype="bfloat16")).numpy()
    assert p16.dtype == np.float32 and p16.shape == j16.shape
    c32, c16, cp16 = consistency(j32), consistency(j16), consistency(p16)
    assert abs(cp16 - c16) <= BF16_DRIFT * c16, (cp16, c16)
    assert cp16 < c32 * 1.1 + 1e-4, (cp16, c32)
    assert np.corrcoef(p16, j16)[0, 1] > 0.999
    assert np.abs(p16 - p32).max() > 1e-3      # the mode rounds
    # the FFT route's bf16 plain version (how the card runs n_fft 512)
    lin = tst.mel_to_linear(gl._magnitude(torch.from_numpy(mel.copy()), tc),
                            tc) ** tc.power
    pf16 = glk.griffin_lim_fft_plain(lin[None], lin[None],
                                     torch.zeros_like(lin[None]), 512, 128,
                                     400, 8, bf16=True)[0].numpy()
    cf16 = consistency(pf16)
    assert abs(cf16 - c16) <= BF16_DRIFT * c16, (cf16, c16)
    assert np.corrcoef(pf16, j16)[0, 1] > 0.999
    with pytest.raises(ValueError, match="gl_compute_dtype"):
        gl.griffin_lim(torch.ones(1, 3, 257), 512, 128, 400, 1,
                       compute_dtype="float16")


def test_bf16_plain_rounds_where_the_mode_says():
    """The bf16 plain version at 0 iterations is the synthesis of the
    bf16-rounded start against the bf16-rounded folded basis, summed in
    f32: equal to that product written out in float64."""
    n_fft, hop, win = 64, 16, 48
    rng = np.random.default_rng(0)
    S = torch.from_numpy(rng.uniform(0, 1, (1, 5, 33)).astype(np.float32))
    y = glk.griffin_lim_plain(S, S, torch.zeros_like(S), n_fft, hop, win, 0,
                              bf16=True)
    ops = glk.kernel_bases(n_fft, hop, win, "cpu")
    A = torch.cat([glk.bf16_round(S), torch.zeros_like(S)], -1).double()
    frames = A @ glk.bf16_round(ops.bsyn).double()
    from tacotron2_tpu_torch.ops import stft as st
    full = st.overlap_add(frames, n_fft, hop, ops.lpad) * \
        glk.overlap_add_norm(n_fft, hop, win, 5, "cpu").double()
    want = full[:, n_fft // 2: n_fft // 2 + hop * 4]
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- WER, A/B

def test_wer_matches_jax():
    """tests/test_eval_tools.py:14-33's cases, and the file join."""
    pairs = [("the cat sat", "the cat sat"), ("the cat sat", "the cat"),
             ("the cat sat", "the dog sat"), ("the cat", "the big cat"),
             ("Hello, World!", "hello world"), ("a b c d", "a x c"),
             ("", ""), ("", "extra words")]
    for r, h in pairs:
        assert wer.wer(r, h) == jax_wer.wer(r, h)
        assert wer.normalize_for_wer(r) == jax_wer.normalize_for_wer(r)
        rr, hh = r.split(), h.split()
        assert wer.edit_distance(rr, hh) == jax_wer.edit_distance(rr, hh)
    assert wer.edit_distance("a b c d".split(), "a x c".split()) == \
        (1, 1, 0, 2)
    assert wer.corpus_wer(pairs) == jax_wer.corpus_wer(pairs)


def test_wer_from_files_matches_jax(tmp_path):
    s, t = tmp_path / "s.txt", tmp_path / "t.txt"
    s.write_text("u1|the cat sat\nu2|a b c d\nu3|not transcribed\n")
    t.write_text("u2|a x c\nu1|the cat\nbad row\n")
    assert wer.wer_from_files(str(s), str(t)) == \
        jax_wer.wer_from_files(str(s), str(t))


def test_ab_test_matches_jax(tmp_path):
    """tests/test_eval_tools.py:62-86: the same seed gives the JAX
    package's answer key and copies, and the same scores."""
    new, bsl = tmp_path / "new", tmp_path / "bsl"
    new.mkdir()
    bsl.mkdir()
    for i in range(5):
        (new / f"utt{i}.wav").write_bytes(b"N" * 10)
        (bsl / f"utt{i}.wav").write_bytes(b"B" * 10)
    (new / "only_new.wav").write_bytes(b"N")
    keys = []
    for mod, out in ((human_eval, "port"), (jax_ab, "jax")):
        keys.append(mod.build_ab_test(str(new), str(bsl),
                                      str(tmp_path / out), seed=3))
    assert open(keys[0]).read() == open(keys[1]).read()
    for i in range(5):
        for j in range(2):
            assert (tmp_path / "port" / f"test_{i}_{j}.wav").read_bytes() \
                == (tmp_path / "jax" / f"test_{i}_{j}.wav").read_bytes()
    resp = tmp_path / "resp.csv"
    resp.write_text("index,choice\n" + "\n".join(
        f"{i},{1 + i % 2}" for i in range(5)))
    got = human_eval.score_ab_test(keys[0], str(resp))
    assert got == jax_ab.score_ab_test(keys[1], str(resp))
    rows = list(csv.DictReader(open(keys[0])))
    assert got["prefer_new"] == sum(
        r["test1" if i % 2 == 0 else "test2"] == "new"
        for i, r in enumerate(rows))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no matching"):
        human_eval.build_ab_test(str(tmp_path / "empty"), str(bsl),
                                 str(tmp_path / "x"))


# ---------------------------------------------------------- native runtime

needs_cxx = pytest.mark.skipif(native_build.cxx_path() is None,
                               reason="no host C++ compiler")


def test_host_library_path_covers_the_cpu(monkeypatch):
    """The host library is built with -march=native, so its path changes
    with the CPU (another CPU rebuilds it) and stays put on one."""
    here = native_build._lib_path("tacodata", host=True)
    assert native_build._lib_path("tacodata", host=True) == here
    monkeypatch.setattr(native_build, "_host_cpu", lambda: "another cpu")
    assert native_build._lib_path("tacodata", host=True) != here


def test_train_logs_the_mesh_it_does_not_use(tmp_path, monkeypatch):
    """`cli train` with model_parallelism > 1 puts every rank on 'data',
    as JAX's host loops do, and says so once in the log."""
    said = []
    monkeypatch.setattr(cli, "log", lambda msg, *a, **k: said.append(msg))
    monkeypatch.setattr(cli, "infolog_init", lambda *a, **k: None)
    monkeypatch.setattr(cli, "_train_tacotron", lambda cfg, args, d: d)
    args = cli.build_parser().parse_args(
        ["--hparams", "mesh.model_parallelism=2", "train", "--model",
         "Tacotron", "--input-path", "train.txt", "--base-dir",
         str(tmp_path), "--device", "cpu"])
    cli.cmd_train(args)
    assert sum("model_parallelism=2" in m for m in said) == 1, said
    said.clear()
    args.hparams = ""
    cli.cmd_train(args)
    assert not any("model_parallelism" in m for m in said), said


@needs_cxx
def test_native_runtime_matches_np_load_and_jax(tmp_path):
    """Built with g++ at first use: every dtype bit-equal to np.load's f32
    cast, the parallel batch, μ-law against the port's and JAX's numpy
    codecs, the WAV round trip against scipy, a missing file raises."""
    from tacotron2_tpu.ops import mulaw as jm
    from tacotron2_tpu_torch.data import audio
    assert nat.available()
    rng = np.random.default_rng(0)
    for arr in [rng.random((127, 80)).astype(np.float32),
                rng.random(33).astype(np.float16),
                (rng.random((5, 7, 3)) * 100).astype(np.int16),
                rng.random((4, 4))]:
        p = str(tmp_path / "t.npy")
        np.save(p, arr)
        got = nat.read_npy_f32(p)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, arr.astype(np.float32))
    paths = []
    for i in range(24):
        paths.append(str(tmp_path / f"b{i}.npy"))
        np.save(paths[-1], np.full((10, 3 + i), i, np.float32))
    outs = nat.read_npy_batch_f32(paths, num_threads=8)
    assert all(o.shape == (10, 3 + i) and np.all(o == i)
               for i, o in enumerate(outs))
    x = rng.uniform(-1, 1, 1000).astype(np.float32)
    np.testing.assert_allclose(nat.mulaw(x), np.asarray(jm.mulaw(x, 255)),
                               atol=1e-5)
    np.testing.assert_allclose(nat.inv_mulaw(nat.mulaw(x)), x, atol=1e-5)
    q = nat.mulaw_quantize(x, 255)
    assert np.abs(q - np.asarray(jm.mulaw_quantize(x, 255))).max() <= 1
    w = (np.sin(np.linspace(0, 100, 16000)) * 0.5).astype(np.float32)
    p = str(tmp_path / "w.wav")
    nat.write_wav_pcm16(p, w, 16000)
    back, sr = nat.read_wav_pcm16(p)
    assert sr == 16000 and len(back) == len(w)
    np.testing.assert_allclose(back, audio.load_wav(p, 16000), atol=1e-4)
    assert abs(np.abs(back).max() - 32767 / 32768) < 1e-3
    with pytest.raises(IOError):
        nat.read_npy_f32(str(tmp_path / "missing.npy"))


@needs_cxx
def test_feeders_load_through_the_native_runtime(tmp_path, monkeypatch):
    """The WaveNet feeder's group load and the Tacotron feeder's mels go
    through the runtime, and the batches equal the np.load path's."""
    from tacotron2_tpu_torch.config import Config
    from tacotron2_tpu_torch.data import feeder as tf
    from tacotron2_tpu_torch.data import wavenet_feeder as wf
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, wavenet_test_size=None, wavenet_test_batches=1,
        wavenet_batch_size=1, max_time_steps=2000))
    hop = cfg.audio.effective_hop
    rng = np.random.default_rng(1)
    rows = []
    for i in range(6):
        frames = 12 + i
        xp, cp = tmp_path / f"a{i}.npy", tmp_path / f"m{i}.npy"
        np.save(xp, rng.random(frames * hop).astype(np.float32))
        np.save(cp, rng.random((frames, 80)).astype(np.float32))
        rows.append(f"{xp}|{cp}|{cp}|<no_g>|{frames * hop}|{frames}")
    mp = tmp_path / "map.txt"
    mp.write_text("\n".join(rows) + "\n")
    calls = []
    batch = nat.read_npy_batch_f32
    monkeypatch.setattr(nat, "read_npy_batch_f32",
                        lambda p, **k: calls.append(len(p)) or batch(p, **k))
    f1 = wf.WaveNetFeeder(cfg, str(mp), gta=False, batches_per_group=2,
                          seed=7)
    b1 = next(iter(f1.train_batches(1)))
    assert calls == [4]
    f2 = wf.WaveNetFeeder(cfg, str(mp), gta=False, batches_per_group=2,
                          seed=7)
    monkeypatch.setattr(nat, "available", lambda: False)
    b2 = next(iter(f2.train_batches(1)))
    assert calls == [4]
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])
    monkeypatch.setattr(nat, "available", lambda: True)
    one = []
    read = nat.read_npy_f32
    monkeypatch.setattr(nat, "read_npy_f32",
                        lambda p: one.append(p) or read(p))
    feeder = tf.TacotronFeeder.__new__(tf.TacotronFeeder)
    feeder.data_folder = str(tmp_path)
    os.makedirs(tmp_path / "ds" / "mels")
    np.save(tmp_path / "ds" / "mels" / "m.npy", np.ones((3, 2), np.float32))
    got = feeder._load_mel(["ds", "", "m.npy"])
    assert len(one) == 1 and np.array_equal(got, np.ones((3, 2)))


# -------------------------------------------------------------------- live

def _cli_args(tmp_path, monkeypatch, extra):
    """The port-initialised weights (flax trees) behind the checkpoint
    loader, tests/test_torch_synth.py's small config."""
    from test_torch_synth import _cfg
    from torch_port_helpers import STEPS, T_IN, T_REF, torch_cfg

    from tacotron2_tpu_torch import convert
    cfg = _cfg(torch_cfg)
    tparams, stats = convert.tacotron_to_flax(convert.init_tacotron(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    tparams["decoder"]["cell"]["stop_projection"]["Dense_0"]["bias"][:] = \
        -30.0
    monkeypatch.setattr(cli, "get_config", lambda preset, hp: cfg)
    import tacotron2_tpu_torch.convert as conv
    monkeypatch.setattr(conv, "load_checkpoints",
                        lambda a, b=None: (tparams, stats, None))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    return ["--checkpoint", "x", "--device", "cpu", "--steps", str(STEPS),
            "--t-ref", str(T_REF), "--buckets", str(T_IN),
            "--serve-batch", "2", "--vocoder", "griffin_lim", *extra]


def _run(argv, stdin, monkeypatch):
    monkeypatch.setattr(sys, "stdin", stdio.StringIO(stdin))
    return cli.main(argv)


def test_live_pipeline_writes_what_serve_writes(tmp_path, monkeypatch):
    """Two stdin lines through `live --pipeline` and through `serve`:
    the same wavs bit for bit; without a player they are only saved."""
    lines = "hello there.\na b c d e.\n\nnot read.\n"
    base = _cli_args(tmp_path, monkeypatch, [])
    got = _run(["live", "--pipeline", "--output-dir", str(tmp_path / "l"),
                *base], lines, monkeypatch)
    _run(["serve", "--output-dir", str(tmp_path / "s"), *base], lines,
         monkeypatch)
    want = sorted((tmp_path / "s" / "serve").iterdir())
    assert [os.path.basename(p) for p in got] == [p.name for p in want] \
        == ["speech-00000.wav", "speech-00001.wav"]
    for g, w in zip(got, want):
        assert open(g, "rb").read() == w.read_bytes()


def test_live_eval_writes_what_synthesize_writes(tmp_path, monkeypatch):
    """`live` without --pipeline: each line through `cmd_synthesize` in
    eval mode, its newest wav that of `synthesize --sentence`."""
    base = _cli_args(tmp_path, monkeypatch, [])[:4]
    got = _run(["live", "--output-dir", str(tmp_path / "l"), *base],
               "hello there.\n", monkeypatch)
    cli.main(["synthesize", "--model", "Tacotron", "--output-dir",
              str(tmp_path / "s"), "--sentence", "hello there.", *base])
    assert len(got) == 1
    assert open(got[0], "rb").read() == \
        (tmp_path / "s" / "eval" / "wavs" / "wav-eval-0.wav").read_bytes()


# ------------------------------------------------- emt_attn reference_depth

def test_emt_attn_reference_depth_64():
    """emt_attn simple with ref_spk at reference_depth 64: the port's
    decode equals the flax scan (LSTM1 takes the 128-wide ref_spk, as the
    model feeds it); JAX's kernel extraction takes reference_depth rows for
    it and fails (tacotron2_tpu/ops/tacotron_decoder_kernel.py:114-116),
    a fault of the reference that this test shows."""
    from test_torch_emt_attn import (B2, K, M2, T2, TE, _decode_cfgs,
                                     _port_operands)
    from torch_port_helpers import to_numpy

    from tacotron2_tpu.models.tacotron.decoder import Decoder
    from tacotron2_tpu.ops.tacotron_decoder_kernel import (
        build_decoder_block_kernel, extract_decoder_params)
    from tacotron2_tpu_torch.models.tacotron import decoder as tdec
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    cfg, cfg_t = _decode_cfgs("simple", 64)
    rng = np.random.default_rng(5)
    f = lambda *s, sc=0.4: (rng.normal(size=s) * sc).astype(np.float32)
    memory = f(B2, T2, M2)
    keys = f(B2, T2, cfg.tacotron.attention_dim, sc=0.3)
    mask = np.arange(T2)[None, :] < np.asarray([T2, T2 - 5])[:, None]
    emt_memory, ref_spk = f(B2, TE, 2 * 64), f(B2, 128)
    dec = Decoder(config=cfg)
    run = jax.jit(lambda p: dec.apply(
        {"params": p}, B2, 2 * K, jnp.asarray(keys), jnp.asarray(memory),
        jnp.asarray(mask), emt_memory=jnp.asarray(emt_memory),
        ref_spk=jnp.asarray(ref_spk), method=Decoder.autoregressive,
        rngs=dict(dropout=jax.random.PRNGKey(7),
                  zoneout=jax.random.PRNGKey(8)))[:3])
    params = to_numpy(jax.jit(lambda: dec.init(
        dict(params=jax.random.PRNGKey(3), dropout=jax.random.PRNGKey(1),
             zoneout=jax.random.PRNGKey(2)),
        B2, 2 * K, jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask),
        emt_memory=jnp.asarray(emt_memory), ref_spk=jnp.asarray(ref_spk),
        method=Decoder.autoregressive))()["params"])
    P, U = cfg.tacotron.prenet_layers[-1], cfg.tacotron.decoder_lstm_units
    assert params["cell"]["lstm1"]["kernel"].shape[0] == \
        P + M2 + 2 * 64 + 128 + U
    f_j, s_j, a_j = run(params)
    dp, emt = _port_operands(cfg_t, params, False, emt_memory, ref_spk, None)
    drop = tdec.drop_masks(cfg_t, B2, 2 * K, device="cpu")
    f_t, s_t, a_t = dk.decode_plain(
        dp, cfg_t, torch.as_tensor(keys), torch.as_tensor(memory),
        torch.as_tensor(mask), drop, steps=2 * K, early_stop_block=K,
        emt=emt)
    np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=0, atol=3e-4)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=3e-5)
    np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=0, atol=1e-4)
    build_decoder_block_kernel(cfg, B2, T2, K, M2, weight_dtype=jnp.float32,
                               emt_T=TE, interpret=True)
    with pytest.raises(AssertionError):
        extract_decoder_params({"decoder": params}, cfg, emt_only=False)
