"""The port's GTA synthesis, `embed` and style-mode drivers against the JAX
package's, on the CPU.

Both synthesizers get the same flax weights (tests/torch_port_helpers.py,
dropout 0) and the same texts, references and targets. The JAX GTA pass
runs as it does on a CPU: with `use_fused_train_decoder` on, the TPU
kernel `build_train_fwd(train_zoneout=False)` in interpret mode; off, the
flax scan. The port runs the plain teacher-forced decode either way (the
flag picks a TPU implementation, not a semantics). Tolerances are the
synthesizer's (tests/test_torch_synth.py): mels atol 2e-4 / rtol 1e-3,
alignments 1e-4; stop logits 2e-4 (f32 on both sides, another sum order;
logits of a few units); reference-encoder embeddings 1e-4. The drivers
run on the port's copy of tests/test_new_modes.py's `_fake_corpus`: their
numpy RNG must pick the same rows, so file names, map and meta rows match
exactly.
"""

import dataclasses
import os
import wave

import numpy as np
import pytest
import torch

from tacotron2_tpu.synth import tacotron_synth as jts
from tacotron2_tpu_torch import cli
from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
from tacotron2_tpu_torch.synth import tacotron_synth as tts
from test_torch_synth import _cfg
from torch_port_helpers import MELS, flax_weights, inputs, small_cfg, \
    torch_cfg

TEXTS = ["hello there.", "a b c d e.", "ok."]
TARGET_FRAMES = (37, 50, 23)


def _cfgs(fused: bool):
    over = dict(fused_train_dtype="float32", use_fused_train_decoder=fused)
    return [c.replace(tacotron=dataclasses.replace(c.tacotron, **over))
            for c in (_cfg(small_cfg), _cfg(torch_cfg))]


def _synths(fused=True, pin_stop=-30.0):
    tparams, stats, _ = flax_weights(pin_stop)
    cfg_j, cfg_t = _cfgs(fused)
    return (jts.TacotronSynthesizer(cfg_j, tparams, stats),
            tts.TacotronSynthesizer(cfg_t, tparams, stats, device="cpu",
                                    keep_intermediates=True))


def _mels(frames, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-4, 4, (f, MELS)).astype(np.float32) for f in frames]


def _refs(n):
    refs = inputs()[2]
    return [refs[i % len(refs)] for i in range(n)]


def _mels_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "scan"])
def test_gta_synthesize_matches_jax(fused):
    js, ts = _synths(fused, pin_stop=0.0)
    refs, targets = _refs(3), _mels(TARGET_FRAMES)
    want = js.synthesize(TEXTS, refs, refs, mel_targets=targets, gta=True)
    got = ts.synthesize(TEXTS, refs, refs, mel_targets=targets, gta=True)
    im = ts.intermediates
    assert im["route"] == "teacher_forced"
    # targets padded with -max_abs_value to a multiple of 64 frames; every
    # coin is 1; the lengths are the targets'
    assert im["teacher"].shape == (32, 3, MELS) and bool(im["coins"].all())
    assert float(im["teacher"][-1, 2].max()) == -ts.cfg.audio.max_abs_value
    assert got["lengths"] == want["lengths"] == list(TARGET_FRAMES)
    _mels_close(got["mels"], want["mels"])
    for g, w in zip(got["alignments"], want["alignments"]):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)
    s_t, s_j = got["stop_tokens"], np.asarray(want["stop_tokens"])
    assert s_t.shape == s_j.shape == (3, 64)
    np.testing.assert_allclose(s_t, s_j, atol=2e-4, rtol=0)
    assert s_t.min() < 0 < s_t.max()          # logits, not probabilities
    # a wrong teacher (shifted by one frame) moves the mels far beyond that
    bad = [np.roll(t, 1, 0) for t in targets]
    moved = ts.synthesize(TEXTS, refs, refs, mel_targets=bad, gta=True)
    assert max(np.abs(a - b).max() for a, b in
               zip(moved["mels"], got["mels"])) > 1e-2


def test_gta_needs_targets():
    _, ts = _synths()
    with pytest.raises(ValueError):
        ts.synthesize(TEXTS[:1], _refs(1), _refs(1), gta=True)


def test_embed_matches_jax():
    js, ts = _synths()
    mels = _mels((16, 21), seed=3)
    want = js.embed(["a b", "c d"], mels)
    got = ts.embed(["a b", "c d"], mels)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == np.asarray(v).shape == (2, 128), k
        np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-4,
                                   rtol=0, err_msg=k)
    assert not np.allclose(got["emb_emt"][0], got["emb_emt"][1])


def _fake_corpus(root, cfg, n=4, frames=24):
    """tests/test_new_modes.py's preprocessed-corpus layout:
    <root>/emt4/mels/mel-<i>.npy and train.txt rows."""
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "emt4", "mels"), exist_ok=True)
    rows = []
    hop = cfg.audio.effective_hop
    for i in range(n):
        mel = rng.uniform(-4, 4, (frames, cfg.audio.num_mels)).astype(
            np.float32)
        np.save(os.path.join(root, "emt4", "mels", f"mel-{i}.npy"), mel)
        rows.append(f"emt4|audio-{i}.npy|mel-{i}.npy|linear-{i}.npy|s.npy|"
                    f"{frames * hop}|{frames}|hello world {i}|{i % 2}|0|"
                    f"utt{i}.wav|F")
    path = os.path.join(root, "train.txt")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def _rel(text, root):
    return text.replace(str(root), "<out>")


def _same_files(out_t, out_j, sub, load=True):
    """The same file names under both outputs' `sub`; .npy mels close."""
    names = sorted(os.listdir(os.path.join(out_t, sub)))
    assert names == sorted(os.listdir(os.path.join(out_j, sub))) and names
    if load:
        _mels_close([np.load(os.path.join(out_t, sub, n)) for n in names
                     if n.endswith(".npy")],
                    [np.load(os.path.join(out_j, sub, n)) for n in names
                     if n.endswith(".npy")])
    return names


def test_run_gta_synthesis_matches_jax(tmp_path):
    js, ts = _synths()
    train_txt = _fake_corpus(str(tmp_path / "data"), ts.cfg, n=5)
    out_t, out_j = tmp_path / "t", tmp_path / "j"
    map_t = tts.run_gta_synthesis(ts, train_txt, str(out_t), batch_size=2)
    map_j = jts.run_gta_synthesis(js, train_txt, str(out_j), batch_size=2)
    rows_t = open(map_t).read().splitlines()
    rows_j = open(map_j).read().splitlines()
    assert [_rel(r, out_t) for r in rows_t] == [_rel(r, out_j)
                                                for r in rows_j]
    assert len(rows_t) == 5
    hop = ts.cfg.audio.effective_hop
    for i, row in enumerate(rows_t):
        audio, gt, gta, steps, text = row.split("|")
        assert audio == str(tmp_path / "data" / "emt4" / "audio"
                            / f"audio-{i}.npy")
        assert gta == str(out_t / "gta" / "mels" / f"gta-mel-{i}.npy")
        assert np.load(gta).shape == np.load(gt).shape == (24, MELS)
        assert steps == str(24 * hop) and text == f"hello world {i}"
    _same_files(str(out_t / "gta"), str(out_j / "gta"), "mels")
    limited = tts.run_gta_synthesis(ts, train_txt, str(tmp_path / "l"),
                                    limit=2)
    assert len(open(limited).read().splitlines()) == 2


def test_run_style_transfer_matches_jax(tmp_path):
    js, ts = _synths()
    _fake_corpus(str(tmp_path), ts.cfg)
    hop = ts.cfg.audio.effective_hop
    meta = tmp_path / "synth_meta.txt"
    meta.write_text(
        "# style transfer rows\n"
        f"emt4|a.npy|mel-0.npy|l|s|{24 * hop}|24|one two|0|0|u0.wav|F|"
        "emt4/mel-1.npy|e1|same\n"
        f"emt4|a.npy|mel-2.npy|l|s|{24 * hop}|24|three four|1|0|u1.wav|F|"
        "same|e0|emt4/mel-3.npy\n")
    for flip in (False, True):
        out_t, out_j = tmp_path / f"t{flip}", tmp_path / f"j{flip}"
        map_t = tts.run_style_transfer(ts, str(meta), str(tmp_path),
                                       str(out_t), flip_spk_emt=flip)
        map_j = jts.run_style_transfer(js, str(meta), str(tmp_path),
                                       str(out_j), flip_spk_emt=flip)
        rows_t = open(map_t).read().splitlines()
        assert [_rel(r, out_t) for r in rows_t] == [
            _rel(r, out_j) for r in open(map_j).read().splitlines()]
        assert [r.split("|", 1)[1] for r in rows_t] == ["one two|0|0",
                                                        "three four|1|0"]
        nat_t, nat_j = str(out_t / "natural"), str(out_j / "natural")
        assert _same_files(nat_t, nat_j, "mels") == ["mel-u0_e1.npy",
                                                     "mel-u1_e0.npy"]
        assert _same_files(nat_t, nat_j, "wavs", load=False) == [
            "wav-u0_e1.wav", "wav-u1_e0.wav"]


@pytest.mark.parametrize("paired", [False, True])
def test_run_synthesis_random_matches_jax(tmp_path, paired):
    js, ts = _synths()
    train_txt = _fake_corpus(str(tmp_path), ts.cfg, n=6)
    out_t, out_j = tmp_path / "t", tmp_path / "j"
    d_t = tts.run_synthesis_random(ts, train_txt, str(tmp_path), str(out_t),
                                   n_per_emotion=2, paired=paired)
    d_j = jts.run_synthesis_random(js, train_txt, str(tmp_path), str(out_j),
                                   n_per_emotion=2, paired=paired)
    csv_t = open(os.path.join(d_t, "meta.csv")).read()
    assert csv_t == open(os.path.join(d_j, "meta.csv")).read()
    assert len(csv_t.splitlines()) == 1 + (2 if paired else 4)
    names = _same_files(d_t, d_j, ".")
    assert sum(n.startswith("wav-") for n in names) == (2 if paired else 4)


def test_run_synthesis_multiple_matches_jax(tmp_path):
    js, ts = _synths()
    train_txt = _fake_corpus(str(tmp_path), ts.cfg, n=6)
    kw = dict(n_spk_per_accent=1, n_text_per_spk=2, min_frames=0, seed=1)
    d_t = tts.run_synthesis_multiple(ts, train_txt, str(tmp_path),
                                     str(tmp_path / "t"), **kw)
    d_j = jts.run_synthesis_multiple(js, train_txt, str(tmp_path),
                                     str(tmp_path / "j"), **kw)
    # 2 accents x 1 speaker x 2 texts x 2 references
    assert len(_same_files(d_t, d_j, "mels")) == 8
    assert len(_same_files(d_t, d_j, "wavs", load=False)) == 8


def test_run_style_embs_matches_jax(tmp_path):
    js, ts = _synths()
    train_txt = _fake_corpus(str(tmp_path), ts.cfg, n=6)
    d_t = tts.run_style_embs(ts, train_txt, str(tmp_path),
                             str(tmp_path / "t"), n_spk=1, n_per_spk=4)
    d_j = jts.run_style_embs(js, train_txt, str(tmp_path),
                             str(tmp_path / "j"), n_spk=1, n_per_spk=4)
    assert sorted(os.listdir(d_t)) == sorted(os.listdir(d_j)) == [
        "emb_emt.tsv", "emb_spk.tsv", "meta.tsv"]
    meta = open(os.path.join(d_t, "meta.tsv")).read()
    assert meta == open(os.path.join(d_j, "meta.tsv")).read()
    assert len(meta.splitlines()) == 1 + 8
    for name in ("emb_emt.tsv", "emb_spk.tsv"):
        e_t = np.loadtxt(os.path.join(d_t, name), delimiter="\t")
        e_j = np.loadtxt(os.path.join(d_j, name), delimiter="\t")
        assert e_t.shape == e_j.shape == (8, 128)
        # written with 6 decimals
        np.testing.assert_allclose(e_t, e_j, atol=1e-4 + 1e-6, rtol=0)


@pytest.fixture
def cli_setup(tmp_path, monkeypatch):
    """The CLI on a fake corpus with the helpers' weights; the config's
    train dtype is bf16 (the default) while the decode's is f32, so GTA
    extracts its own weights."""
    tparams, stats, wparams = flax_weights()
    cfg = _cfg(torch_cfg)
    assert tk.train_weight_dtype(cfg) == torch.bfloat16
    monkeypatch.setattr(cli, "get_config", lambda preset, hp: cfg)
    import tacotron2_tpu_torch.convert as conv
    monkeypatch.setattr(conv, "load_checkpoints",
                        lambda a, b=None: (tparams, stats, None))
    monkeypatch.setattr(conv, "load_wavenet", lambda p: wparams)
    train_txt = _fake_corpus(str(tmp_path / "data"), cfg, n=3)
    base = ["synthesize", "--checkpoint", "x", "--device", "cpu",
            "--input-path", train_txt, "--output-dir", str(tmp_path / "out")]
    return cfg, base, tmp_path / "out"


def test_cli_synthesize_gta_tacotron(cli_setup):
    cfg, base, out = cli_setup
    map_path = cli.main(base + ["--model", "Tacotron", "--mode", "gta",
                                "--limit", "2"])
    assert map_path == str(out / "gta" / "map.txt")
    rows = open(map_path).read().splitlines()
    assert len(rows) == 2
    for i, row in enumerate(rows):
        mel = np.load(row.split("|")[2])
        assert mel.shape == (24, MELS) and np.isfinite(mel).all()
        assert row.endswith(f"|hello world {i}")


def test_cli_synthesize_gta_tacotron2(cli_setup):
    """--model Tacotron-2 --mode gta: GTA mels, then WaveNet vocodes
    <output-dir>/gta/map.txt, column 2 of each row."""
    cfg, base, out = cli_setup
    paths = cli.main(base + ["--mode", "gta", "--wavenet-checkpoint", "y"])
    rows = open(out / "gta" / "map.txt").read().splitlines()
    assert len(rows) == len(paths) == 3
    # samples a frame: the vocoder's upsampling (this small config's audio
    # hop is Griffin-Lim's)
    per_frame = int(np.prod(cfg.wavenet.upsample_scales))
    for i, p in enumerate(paths):
        assert p == str(out / "wavenet" / "wavs" / f"wavenet-gta-mel-{i}.wav")
        with wave.open(p, "rb") as f:
            assert f.getnframes() == 24 * per_frame


def test_cli_synthesize_export_modes_stop_before_wavenet(cli_setup):
    """style_embs, synthesis_random and synthesis_multiple return their
    directory without vocoding, so --model Tacotron-2 needs no WaveNet
    weights for them."""
    cfg, base, out = cli_setup
    for mode, sub in (("style_embs", "embeddings"),
                      ("synthesis_random", "random"),
                      ("synthesis_multiple", "multiple")):
        got = cli.main(base + ["--mode", mode, "--n-spk", "1",
                               "--n-per-spk", "2"])
        assert os.path.basename(got) == sub and os.listdir(got), mode
    assert not (out / "wavenet").exists()
