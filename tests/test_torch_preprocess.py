"""The port's preprocessing against the JAX package's, on the CPU: the
rest of `data/audio.py` (trimming, the mulaw silence bounds, the linear
spectrogram, the inverse STFT, Griffin-Lim and the inverse spectrograms,
the hop padding), `data/preprocess.py` (`create_metadata` in the
ljspeech, folders and vctk layouts, `build_from_path` with audio and
linear spectrograms, `wavenet_build_from_path` for every input type,
`vctk_accent_relabel`) and the four `cli` commands.

The corpus is four short synthetic wavs written with scipy (tones between
silences, one at 22.05 kHz so loading resamples it), laid out for each
manifest layout. Both packages run serially on the same files. Manifests
(metadata, train.txt, map.txt) are compared byte for byte, each npy
within 1e-6 (both are the same numpy computation), the audio functions
within 1e-6 of each other (Griffin-Lim from the same initial angles).
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
from scipy.io import wavfile

from tacotron2_tpu import cli as jax_cli
from tacotron2_tpu.config import Config as JaxConfig
from tacotron2_tpu.data import audio as jax_audio
from tacotron2_tpu.data import preprocess as jax_pre
from tacotron2_tpu_torch import cli
from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.data import audio
from tacotron2_tpu_torch.data import preprocess as pre

TONES = ((16000, 330.0, 0.30), (16000, 520.0, 0.25), (22050, 440.0, 0.35),
         (16000, 700.0, 0.20))
TEXTS = ("A tone.", "Another tone, higher.", "Resampled on load.",
         '"Quoted text."')


def _tone(sr, hz, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.5 * np.sin(2 * np.pi * hz * t) * np.hanning(len(t))
    x += 0.01 * rng.normal(size=len(t))
    gap = np.zeros(int(0.15 * sr))
    return (np.concatenate([gap, x, gap]) * 32767 * 0.6).astype(np.int16)


def _write(path, i):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sr, hz, sec = TONES[i]
    wavfile.write(path, sr, _tone(sr, hz, sec, i))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One tree holding the four wavs in the ljspeech (lj/), folders
    (folders/<speaker>/) and vctk (vctk/wav48/<pNNN>/) layouts."""
    root = tmp_path_factory.mktemp("corpus")
    lj = root / "lj"
    rows = []
    for i in range(4):
        _write(str(lj / "wavs" / f"LJ00{i}.wav"), i)
        rows.append(f"LJ00{i}|{TEXTS[i]}|{TEXTS[i].lower()}")
    (lj / "metadata.csv").write_text("\n".join(rows) + "\n",
                                     encoding="utf-8")
    for i in range(4):
        spk = "alice" if i < 2 else "bob"
        _write(str(root / "folders" / spk / f"u{i}.wav"), i)
        (root / "folders" / spk / f"u{i}.txt").write_text(
            TEXTS[i] + "\n", encoding="utf-8")
    vctk = root / "vctk"
    for i in range(4):
        spk = "p225" if i % 2 == 0 else "p226"
        _write(str(vctk / "wav48" / spk / f"{spk}_00{i}.wav"), i)
        os.makedirs(vctk / "txt" / spk, exist_ok=True)
        (vctk / "txt" / spk / f"{spk}_00{i}.txt").write_text(
            TEXTS[i] + "\n", encoding="utf-8")
    (vctk / "speaker-info.csv").write_text(
        "ID,AGE,GENDER,ACCENTS,REGION\n225,23,F,English,Surrey\n"
        "226,22,M,Scottish,Fife\n227,38,M,English,Cumbria\n",
        encoding="utf-8")
    return root


def _cfgs(**audio_kw):
    return tuple(cls().replace(audio=dataclasses.replace(
        cls().audio, griffin_lim_iters=3, **audio_kw))
        for cls in (JaxConfig, Config))


def _same_tree(a, b):
    """Every file under a and b: manifests byte for byte, npy within
    1e-6 (same dtype and shape)."""
    fa = sorted(os.path.relpath(os.path.join(d, f), a)
                for d, _, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(d, f), b)
                for d, _, fs in os.walk(b) for f in fs)
    assert fa == fb and fa
    for rel in fa:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype and x.shape == y.shape, rel
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-6,
                                       err_msg=rel)
        else:
            assert open(pa, "rb").read() == open(pb, "rb").read(), rel


def test_audio_functions_match_jax(corpus):
    jcfg, cfg = _cfgs()
    wav = audio.load_wav(str(corpus / "lj" / "wavs" / "LJ002.wav"), 16000)
    np.testing.assert_array_equal(
        wav, jax_audio.load_wav(str(corpus / "lj" / "wavs" / "LJ002.wav"),
                                16000))
    trimmed = audio.trim_silence(wav, cfg.audio)
    assert 0 < len(trimmed) < len(wav)
    np.testing.assert_array_equal(trimmed,
                                  jax_audio.trim_silence(wav, jcfg.audio))
    q = np.clip(np.rint(127 + 60 * np.sin(np.arange(400) / 9.0)
                        * (np.arange(400) > 50)), 0, 255).astype(np.int16)
    assert audio.start_and_end_indices(q, 2) == \
        jax_audio.start_and_end_indices(q, 2)
    assert audio.start_and_end_indices(np.full(9, 127), 2) == (0, 9)
    for sides in (1, 2):
        a = dataclasses.replace(cfg.audio, wavenet_pad_sides=sides)
        ja = dataclasses.replace(jcfg.audio, wavenet_pad_sides=sides)
        for n in (0, 199, 200, 4321):
            assert audio.pad_lr(np.zeros(n), a) == \
                jax_audio.pad_lr(np.zeros(n), ja)
    lin = audio.linear_spectrogram(trimmed, cfg.audio)
    np.testing.assert_allclose(
        lin, jax_audio.linear_spectrogram(trimmed, jcfg.audio), atol=1e-6)
    spec = audio._stft_np(trimmed, cfg.audio)
    np.testing.assert_allclose(audio._istft_np(spec, cfg.audio),
                               jax_audio._istft_np(spec, jcfg.audio),
                               atol=1e-6)
    np.testing.assert_allclose(audio._db_to_amp(lin), jax_audio._db_to_amp(
        lin), rtol=1e-6)
    for sym in (True, False):
        a = dataclasses.replace(cfg.audio, symmetric_mels=sym)
        np.testing.assert_allclose(
            audio._denormalize(lin, a),
            jax_audio._denormalize(lin, dataclasses.replace(
                jcfg.audio, symmetric_mels=sym)), atol=1e-6)
    angles = np.random.default_rng(0).random(spec.shape)
    np.testing.assert_allclose(
        audio._griffin_lim_np(np.abs(spec), cfg.audio, init_angles=angles),
        jax_audio._griffin_lim_np(np.abs(spec), jcfg.audio,
                                  init_angles=angles), atol=1e-6)
    mel = audio.mel_spectrogram(trimmed, cfg.audio)
    for fn, x in (("inv_linear_spectrogram", lin),
                  ("inv_mel_spectrogram", mel)):
        got = getattr(audio, fn)(x, cfg.audio)
        want = getattr(jax_audio, fn)(x, jcfg.audio)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=fn)
    out = corpus / "saved.wav"
    audio.save_wavenet_wav(trimmed, str(out), 16000)
    back = audio.load_wav(str(out), 16000)
    assert len(back) == len(trimmed) and np.abs(back).max() > 0.99


@pytest.mark.parametrize("layout", ["ljspeech", "folders", "vctk"])
def test_create_metadata_and_preprocess_match_jax(corpus, tmp_path, layout):
    """create_metadata, then build_from_path with the audio and linear
    spectrograms and write_metadata (and for vctk vctk_accent_relabel),
    by both packages: the same files."""
    in_dir = corpus / {"ljspeech": "lj", "folders": "folders",
                       "vctk": "vctk"}[layout]
    jcfg, cfg = _cfgs()
    outs = {}
    for name, mod, c in (("jax", jax_pre, jcfg), ("port", pre, cfg)):
        out = tmp_path / name
        os.makedirs(out)
        meta = mod.create_metadata(str(in_dir), str(out / "metadata.txt"),
                                   layout=layout, emt_label=2, sex="F")
        rows = mod.build_from_path(c, meta, str(in_dir), str(out), layout,
                                   serial=True, write_audio=True,
                                   write_linear=True)
        train = mod.write_metadata(rows, str(out), c)
        if layout == "vctk":
            mod.vctk_accent_relabel(train, str(in_dir / "speaker-info.csv"),
                                    str(out / "train_accent.txt"))
        outs[name] = out
    _same_tree(str(outs["jax"]), str(outs["port"]))
    rows = (outs["port"] / "train.txt").read_text().splitlines()
    assert len(rows) == 4 and all(len(r.split("|")) == 12 for r in rows)
    if layout == "vctk":
        accents = [r.split("|")[8] for r in
                   (outs["port"] / "train_accent.txt").read_text()
                   .splitlines()]
        assert sorted(set(accents)) == ["0", "1"]


@pytest.mark.parametrize("input_type", ["raw", "mulaw", "mulaw-quantize"])
def test_wavenet_preprocess_matches_jax(corpus, tmp_path, input_type):
    """wavenet_build_from_path and write_wavenet_metadata on the
    ljspeech wav folder: the audio and mel npy of each input type and the
    map.txt. Its rows hold absolute paths, so each package writes into
    the same directory in turn."""
    jcfg, cfg = _cfgs()
    jcfg, cfg = (c.replace(wavenet=dataclasses.replace(
        c.wavenet, input_type=input_type, quantize_channels=256))
        for c in (jcfg, cfg))
    out = tmp_path / "out"
    for name, mod, c in (("jax", jax_pre, jcfg), ("port", pre, cfg)):
        rows = mod.wavenet_build_from_path(c, str(corpus / "lj" / "wavs"),
                                           str(out), serial=True)
        mod.write_wavenet_metadata(rows, str(out), c)
        shutil.move(str(out), str(tmp_path / name))
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    rows = (tmp_path / "port" / "map.txt").read_text().splitlines()
    assert len(rows) == 4
    a = np.load(rows[0].split("|")[0].replace(str(out), str(tmp_path /
                                                            "port")))
    assert a.dtype == (np.int16 if input_type == "mulaw-quantize"
                       else np.float32)


def test_cli_preprocessing_commands_match_jax(corpus, tmp_path):
    """The four commands, each run once through either package's `cli`:
    create-metadata -> preprocess --write-audio, vctk-accent-relabel, and
    wavenet-preprocess (the port's in a pool of two spawned workers):
    the same files."""
    vctk = corpus / "vctk"
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = tmp_path / name
        meta = str(out / "metadata_vctk.txt")
        os.makedirs(out)
        main(["create-metadata", "--in-dir", str(vctk), "--out-path", meta,
              "--layout", "vctk"])
        main(["preprocess", "--dataset", "vctk", "--in-dir", str(vctk),
              "--out-dir", str(out), "--metadata", meta, "--serial",
              "--write-audio"])
        main(["vctk-accent-relabel", "--train-path", str(out / "train.txt"),
              "--speaker-info", str(vctk / "speaker-info.csv"),
              "--out-path", str(out / "train_accent.txt")])
        wn_out = tmp_path / "wn"
        main(["wavenet-preprocess", "--in-dir", str(corpus / "lj" / "wavs"),
              "--out-dir", str(wn_out)]
             + (["--serial"] if name == "jax" else ["--n-jobs", "2"]))
        shutil.move(str(wn_out), str(out / "wn"))
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
