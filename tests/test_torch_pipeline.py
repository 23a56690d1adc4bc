"""The port's TextToWavProgram against the JAX package's, end to end.

Both programs get the same flax weights and the same numpy inputs. The
JAX program runs as tests/test_pipeline_program.py runs it (Pallas kernels
in interpret mode, f32); the port runs on the CPU, i.e. through its
kernels' plain versions. Dropout is 0, the stop projection is pinned off
(bias -30) and the sampler's log-scale pinned to -30, so both chains are
deterministic up to ~1e-6 of injected noise. Tolerances are those of
tests/test_pipeline_program.py's chain-vs-per-stage check (mel atol 2e-4 /
rtol 1e-3, samples atol 2e-3 / rtol 1e-2): f32 on both sides, different
summation order through the decode and 4 sampler layers.
"""

import glob
import os

import numpy as np
import pytest

from tacotron2_tpu.synth.pipeline import TextToWavProgram as JaxProgram
from tacotron2_tpu_torch import cli
from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
from torch_port_helpers import (B, MELS, STEPS, T_IN, T_REF, flax_weights,
                                inputs, small_cfg, torch_cfg)


def _programs(pin_stop=-30.0, **kw):
    # The JAX program decodes in chunks of 2 rows, as its TPU kernel's
    # batch limit asks; the port decodes the whole batch at once. Dropout
    # is 0, so the chunking does not change the outputs.
    tparams, stats, wparams = flax_weights(pin_stop)
    jp = JaxProgram(small_cfg(), tparams, stats, wparams, batch=B,
                    steps=STEPS, t_in=T_IN, t_ref=T_REF, taco_chunk=2,
                    upsample_chunk=2, interpret=True)
    tp = TextToWavProgram(torch_cfg(), tparams, stats, wparams, batch=B,
                          steps=STEPS, t_in=T_IN, t_ref=T_REF, device="cpu",
                          **kw)
    return jp, tp


@pytest.fixture(scope="module")
def outputs():
    jp, tp = _programs()
    ids, lengths, refs = inputs()
    want = [np.asarray(x) for x in jp(ids, lengths, refs, refs)]
    got = [x.numpy() for x in tp(ids, lengths, refs, refs)]
    return got, want, tp


@pytest.mark.parametrize("i,name", [(0, "samples"), (1, "wav_lengths"),
                                    (2, "mel"), (3, "stops"),
                                    (4, "mel_lengths")])
def test_program_matches_jax_program(outputs, i, name):
    got, want, _ = outputs
    assert got[i].shape == want[i].shape, name
    if name in ("wav_lengths", "mel_lengths"):
        np.testing.assert_array_equal(got[i], want[i])
    elif name == "mel":
        np.testing.assert_allclose(got[i], want[i], atol=2e-4, rtol=1e-3)
    elif name == "stops":
        np.testing.assert_allclose(got[i], want[i], atol=2e-5, rtol=0)
    else:
        assert np.abs(want[i]).max() > 1e-3
        np.testing.assert_allclose(got[i], want[i], atol=2e-3, rtol=1e-2)


def test_program_shapes_and_finiteness(outputs):
    got, _, _ = outputs
    samples, wav_len, mel, stops, mel_len = got
    hop = small_cfg().audio.effective_hop
    frames = STEPS * small_cfg().tacotron.outputs_per_step
    assert samples.shape == (B, frames * hop)
    assert mel.shape == (B, frames, MELS) and stops.shape == (B, frames)
    assert np.isfinite(samples).all() and np.isfinite(mel).all()


def test_early_stop_masks_tail():
    """Stop bias +30: every stream stops at frame 0, mel_len clamps to r,
    the mel tail reads the silence pad — the same as the JAX program."""
    jp, tp = _programs(pin_stop=30.0)
    ids, lengths, refs = inputs()
    r = small_cfg().tacotron.outputs_per_step
    s, wl, mel, stops, ml = (x.numpy() for x in tp(ids, lengths, refs, refs))
    assert (ml == r).all()
    assert (wl == r * small_cfg().audio.effective_hop).all()
    np.testing.assert_allclose(mel[:, r:], -small_cfg().audio.max_abs_value,
                               atol=1e-6)
    want = [np.asarray(x) for x in jp(ids, lengths, refs, refs)]
    np.testing.assert_array_equal(ml, want[4])
    np.testing.assert_allclose(mel, want[2], atol=2e-4, rtol=1e-3)


def test_synthesize_pads_short_and_chunks_long(outputs):
    _, _, tp = outputs
    _, _, refs = inputs()
    ref_list = [refs[i % B] for i in range(B + 2)]
    texts = ["hello there.", "a b c d e.", "ok.", "another one."]
    full = tp.synthesize(texts, ref_list[:B], ref_list[:B])
    assert len(full) == B and all(w.ndim == 1 and len(w) for w in full)
    short = tp.synthesize(texts[:2], ref_list[:2], ref_list[:2])
    for a, b in zip(short, full[:2]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)
    long = tp.synthesize((texts * 2)[:B + 2], ref_list, ref_list)
    assert len(long) == B + 2 and all(np.isfinite(w).all() for w in long)
    for a, b in zip(long[:B], full):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)


def test_synthesize_matches_jax_wrapper():
    jp, tp = _programs()
    _, _, refs = inputs()
    texts = ["hello there.", "a b c d e.", "ok."]
    rl = [refs[i] for i in range(3)]
    want = jp.synthesize(texts, rl, rl)
    got = tp.synthesize(texts, rl, rl)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=1e-2)


def test_intermediates_are_kept():
    _, tp = _programs(keep_intermediates=True)
    ids, lengths, refs = inputs()
    tp(ids, lengths, refs, refs)
    im = tp.intermediates
    assert set(im) == {"keys", "memory", "mask", "drop", "c_up", "noise"}
    # the Gaussian head's one plane of standard normals
    assert im["keys"].shape[0] == B and \
        im["noise"].shape == (1, B, tp.t_audio)


def test_cli_serve_writes_wavs(tmp_path, monkeypatch):
    tparams, stats, wparams = flax_weights()
    monkeypatch.setattr(cli, "get_config", lambda preset, hp: torch_cfg())
    import tacotron2_tpu_torch.convert as conv
    monkeypatch.setattr(conv, "load_checkpoints",
                        lambda a, b: (tparams, stats, wparams))
    ref = tmp_path / "ref.npy"
    np.save(ref, inputs()[2][0])
    args = cli.build_parser().parse_args([
        "serve", "--checkpoint", "x", "--wavenet-checkpoint", "y",
        "--output-dir", str(tmp_path), "--serve-batch", "2",
        "--steps", str(STEPS), "--t-ref", str(T_REF),
        "--buckets", f"{T_IN},{2 * T_IN}", "--device", "cpu",
        "--ref-mel-emt", str(ref), "--sentence", "hello there."])
    args.func(args)
    assert len(glob.glob(os.path.join(str(tmp_path), "serve", "*.wav"))) == 1
    run, out_dir = cli.make_serve_fn(args)
    run(["hi."])
    run(["a longer line, second bucket."])
    assert len(glob.glob(os.path.join(out_dir, "*.wav"))) == 3


def test_inv_mulaw_matches_jax():
    from tacotron2_tpu.ops.mulaw import inv_mulaw as jax_inv_mulaw
    from tacotron2_tpu_torch.synth.pipeline import inv_mulaw
    y = np.linspace(-1, 1, 101).astype(np.float32)
    for mu in (255, 2 ** 16 - 1):
        np.testing.assert_allclose(inv_mulaw(y, mu), jax_inv_mulaw(y, mu),
                                   rtol=1e-6, atol=1e-7)
