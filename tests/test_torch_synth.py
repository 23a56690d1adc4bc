"""The port's Tacotron eval synthesis and Griffin-Lim serving against the
JAX package's, on the CPU.

`TacotronSynthesizer` (tacotron2_tpu_torch/synth/tacotron_synth.py) runs
its kernels' plain versions on CPU tensors; the JAX synthesizer runs as it
does on a CPU (the scan decode in blocks of `early_stop_block` with the
host's early exit, which on the TPU are the fused kernels). Both get the
same flax weights (tests/torch_port_helpers.py, dropout 0) and texts. The
port takes its two TPU routes: padded text <= 256 through the whole-decode
chain, longer text through `fused_block_steps` blocks from explicit state.
Tolerances: mels atol 2e-4 / rtol 1e-3 (tests/test_pipeline_program.py's
chain bound), stop probabilities 2e-5 and alignments 1e-4 (f32 on both
sides, other sum order). Griffin-Lim waveforms after 3 iterations of noise-
like random mels agree to within 2e-5 of each waveform's peak, and a G-L
program's samples to waveform correlation > 0.999 (the JAX package's own
program test asks for 0.99: f32 reassociation moves phases of bins with
near-zero magnitude).
"""

import dataclasses
import os
import wave

import numpy as np
import pytest

from tacotron2_tpu.synth.pipeline import TextToWavProgram as JaxProgram
from tacotron2_tpu.synth.tacotron_synth import \
    TacotronSynthesizer as JaxSynthesizer
from tacotron2_tpu_torch import cli
from tacotron2_tpu_torch.ops import griffin_lim_kernel as glk
from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
from tacotron2_tpu_torch.synth.tacotron_synth import (TacotronSynthesizer,
                                                      gl_pad_value, run_eval)
from torch_port_helpers import (B, STEPS, T_IN, T_REF, flax_weights, inputs,
                                small_cfg, torch_cfg)

SHORT = ["hello there.", "a b c d e.", "ok."]
LONG = ["the quick brown fox jumps over the lazy dog, " * 7,
        "pack my box with five dozen liquor jugs. " * 6]
AUDIO = dict(n_fft=256, win_size=200, hop_size=16, griffin_lim_iters=3)
TACO = dict(early_stop_block=4, fused_block_steps=4, max_iters=STEPS)


def _cfg(cls_cfg):
    cfg = cls_cfg()
    return cfg.replace(
        audio=dataclasses.replace(cfg.audio, **AUDIO),
        tacotron=dataclasses.replace(cfg.tacotron, **TACO))


def _refs(n):
    refs = inputs()[2]
    return [refs[i % len(refs)] for i in range(n)]


@pytest.fixture(scope="module", params=[-30.0, 30.0],
                ids=["no-stop", "stop-at-once"])
def synths(request):
    tparams, stats, _ = flax_weights(request.param)
    js = JaxSynthesizer(_cfg(small_cfg), tparams, stats)
    ts = TacotronSynthesizer(_cfg(torch_cfg), tparams, stats, device="cpu",
                             keep_intermediates=True)
    return js, ts, request.param


@pytest.mark.parametrize("texts,route", [(SHORT, "fused"), (LONG, "block")],
                         ids=["short", "long"])
def test_synthesize_matches_jax(synths, texts, route):
    js, ts, pin = synths
    refs = _refs(len(texts))
    want = js.synthesize(texts, refs, refs)
    got = ts.synthesize(texts, refs, refs)
    assert ts.intermediates["route"] == route
    assert (ts.intermediates["memory"].shape[1] > 256) == (route == "block")
    assert got["lengths"] == want["lengths"]
    # On the CPU the JAX synthesizer returns the blocks it ran; the port,
    # like the JAX package's TPU kernel, returns every step, those after
    # the batch stopped reading stop 1.0.
    s_t, s_j = got["stop_tokens"], np.asarray(want["stop_tokens"])
    np.testing.assert_allclose(s_t[:, :s_j.shape[1]], s_j, rtol=0, atol=2e-5)
    assert np.all(s_t[:, s_j.shape[1]:] == 1.0)
    if pin > 0:
        assert got["lengths"] == [0] * len(texts)
        # one block ran; the whole-decode chain still returns every step
        assert s_j.shape[1] == 4 * 2
        assert s_t.shape[1] == (STEPS * 2 if route == "fused" else 4 * 2)
    for a, b in zip(got["mels"], want["mels"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-4)
    for a, b in zip(got["alignments"], want["alignments"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_mels_to_wavs_matches_jax(synths):
    js, ts, _ = synths
    rng = np.random.default_rng(1)
    mels = [rng.uniform(-4, 4, (f, 20)).astype(np.float32) for f in (9, 14)]
    want = js.mels_to_wavs(mels)
    got = ts.mels_to_wavs(mels)
    hop = AUDIO["hop_size"]
    assert [len(w) for w in got] == [hop * 8, hop * 13]
    close = lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=2e-5 * np.abs(b).max())
    for a, b in zip(got, want):
        close(a, b)
    close(ts.mel_to_wav(mels[0]), js.mel_to_wav(mels[0]))
    assert ts.mels_to_wavs([]) == []
    a = ts.cfg.audio
    assert gl_pad_value(a) == -a.max_abs_value
    assert gl_pad_value(dataclasses.replace(a, signal_normalization=False)) \
        == a.min_level_db - a.ref_level_db


def test_prepare_inputs_and_lengths_match_jax(synths):
    js, ts, _ = synths
    for texts in (SHORT, LONG):
        for x, y in zip(ts.prepare_inputs(texts), js.prepare_inputs(texts)):
            np.testing.assert_array_equal(x, y)
    refs = _refs(3)
    np.testing.assert_array_equal(ts._pad_refs(refs), js._pad_refs(refs))
    stops = np.asarray([[0.1, 0.6, 0.2], [0.1, 0.2, 0.3]])
    assert ts.get_output_lengths(stops) == js.get_output_lengths(stops) \
        == [1, 3]


def test_run_eval_writes_mels_map_and_wavs(tmp_path):
    tparams, stats, _ = flax_weights()
    ts = TacotronSynthesizer(_cfg(torch_cfg), tparams, stats, device="cpu")
    texts = SHORT[:2] + LONG[:1]
    refs = _refs(3)
    map_path = run_eval(ts, texts, refs, refs, str(tmp_path))
    rows = open(map_path, encoding="utf-8").read().splitlines()
    assert [r.split("|", 1)[1] for r in rows] == texts
    sr = ts.cfg.audio.sample_rate
    for i, row in enumerate(rows):
        mel = np.load(row.split("|")[0])
        assert mel.shape == (STEPS * 2, 20) and np.isfinite(mel).all()
        with wave.open(str(tmp_path / "eval" / "wavs" / f"wav-eval-{i}.wav"),
                       "rb") as f:
            n = f.getnframes()
            pcm = np.frombuffer(f.readframes(n), "<i2")
        # hop·(frames-1) samples of speech, then 0.5 s of silence
        assert n == AUDIO["hop_size"] * (STEPS * 2 - 1) + sr // 2
        assert np.all(pcm[-sr // 2:] == 0) and np.abs(pcm).max() == 32767


def test_cli_synthesize_eval(tmp_path, monkeypatch):
    tparams, stats, _ = flax_weights()
    monkeypatch.setattr(cli, "get_config", lambda preset, hp: _cfg(torch_cfg))
    import tacotron2_tpu_torch.convert as conv
    monkeypatch.setattr(conv, "load_checkpoints",
                        lambda a, b=None: (tparams, stats, None))
    ref = tmp_path / "ref.npy"
    np.save(ref, inputs()[2][0])
    texts = tmp_path / "texts.txt"
    texts.write_text("\n".join([SHORT[0], LONG[0]]) + "\n", encoding="utf-8")
    out = tmp_path / "out"
    base = ["synthesize", "--checkpoint", "x", "--device", "cpu",
            "--output-dir", str(out), "--ref-mel-emt", str(ref)]
    args = cli.build_parser().parse_args(
        base + ["--model", "Tacotron", "--mode", "eval", "--text-list",
                str(texts)])
    map_path = args.func(args)
    assert len(open(map_path).read().splitlines()) == 2
    for i in range(2):
        assert (out / "eval" / "mels" / f"mel-eval-{i}.npy").exists()
        assert (out / "eval" / "wavs" / f"wav-eval-{i}.wav").exists()
    # the metadata-driven modes need their train.txt; the WaveNet stage
    # needs its weights
    for extra, msg in ((["--model", "Tacotron", "--mode", "gta"],
                        "needs --input-path"),
                       (["--model", "WaveNet"], "wavenet-checkpoint")):
        args = cli.build_parser().parse_args(base + extra)
        with pytest.raises(SystemExit, match=msg):
            args.func(args)


@pytest.fixture(scope="module")
def gl_programs():
    tparams, stats, _ = flax_weights()
    jp = JaxProgram(_cfg(small_cfg), tparams, stats, None, batch=B,
                    steps=STEPS, t_in=T_IN, t_ref=T_REF, taco_chunk=2,
                    upsample_chunk=2, interpret=True, vocoder="griffin_lim")
    tp = TextToWavProgram(_cfg(torch_cfg), tparams, stats, None, batch=B,
                          steps=STEPS, t_in=T_IN, t_ref=T_REF, device="cpu",
                          vocoder="griffin_lim")
    return jp, tp


def test_griffin_lim_program_matches_jax_program(gl_programs):
    jp, tp = gl_programs
    ids, lengths, refs = inputs()
    before = glk.launches
    got = [x.numpy() for x in tp(ids, lengths, refs, refs)]
    want = [np.asarray(x) for x in jp(ids, lengths, refs, refs)]
    assert glk.launches == before          # CPU tensors: the plain version
    hop = AUDIO["hop_size"]
    assert got[0].shape == want[0].shape == (B, hop * (STEPS * 2 - 1))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got[3], want[3], atol=2e-5, rtol=0)
    np.testing.assert_array_equal(got[4], want[4])
    assert np.isfinite(got[0]).all()
    for b in range(B):
        assert np.corrcoef(got[0][b], want[0][b])[0, 1] > 0.999, b


def test_griffin_lim_program_serves_texts(gl_programs):
    jp, tp = gl_programs
    rl = _refs(3)
    want = jp.synthesize(SHORT, rl, rl)
    got = tp.synthesize(SHORT, rl, rl)
    assert tp.wavenet is None and tp.sampler_kernel is None
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.corrcoef(a, b)[0, 1] > 0.999


def test_cli_serve_griffin_lim(tmp_path, monkeypatch):
    tparams, stats, _ = flax_weights()
    monkeypatch.setattr(cli, "get_config", lambda preset, hp: _cfg(torch_cfg))
    import tacotron2_tpu_torch.convert as conv
    monkeypatch.setattr(conv, "load_checkpoints",
                        lambda a, b=None: (tparams, stats, None))
    args = cli.build_parser().parse_args([
        "serve", "--checkpoint", "x", "--vocoder", "griffin_lim",
        "--output-dir", str(tmp_path), "--serve-batch", "2",
        "--steps", str(STEPS), "--t-ref", str(T_REF), "--buckets",
        str(T_IN), "--device", "cpu", "--sentence", "hello there."])
    args.func(args)
    assert os.listdir(tmp_path / "serve") == ["speech-00000.wav"]
    args = cli.build_parser().parse_args([
        "serve", "--checkpoint", "x", "--device", "cpu", "--sentence", "x"])
    with pytest.raises(SystemExit, match="wavenet-checkpoint"):
        args.func(args)
