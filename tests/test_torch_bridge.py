"""Weight bridge (tacotron2_tpu_torch/convert.py) against the JAX package.

Randomly initialised flax Tacotron / WaveNet weights go through the
bridge; the port's memory pass (encoder, reference encoders, GST, keys),
postnet pass and SubPixel upsample must reproduce the flax modules'
outputs on the same numpy inputs. Both sides compute in float32; the
tolerance (atol 1e-4 on O(1) activations) covers the different summation
order of the convolutions and the 24-step LSTM recurrences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.tacotron.model import Tacotron
from tacotron2_tpu.models.wavenet.model import WaveNet
from tacotron2_tpu_torch import convert
from torch_port_helpers import (B, MELS, flax_weights, inputs, small_cfg,
                                torch_cfg)

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    tparams, stats, wparams = flax_weights()
    taco = convert.tacotron_from_flax(torch_cfg(), tparams, stats,
                                      device="cpu")
    wn = convert.wavenet_from_flax(torch_cfg(), wparams, device="cpu")
    return tparams, stats, wparams, taco, wn


def _jax_memory(tparams, stats):
    ids, lengths, refs = inputs()
    return Tacotron(config=small_cfg()).apply(
        {"params": tparams, "batch_stats": stats}, jnp.asarray(ids),
        jnp.asarray(lengths), refs, refs,
        method=Tacotron.synthesis_memory_ext)


def _torch_memory(taco):
    ids, lengths, refs = inputs()
    r = torch.as_tensor(refs)
    return taco.synthesis_memory_ext(torch.as_tensor(ids),
                                     torch.as_tensor(lengths), r, r)


@pytest.mark.parametrize("part", ["encoder", "style", "keys", "mask"])
def test_memory_pass_matches_flax(models, part):
    tparams, stats, _, taco, _ = models
    keys_j, mem_j, mask_j, _, _ = _jax_memory(tparams, stats)
    keys_t, mem_t, mask_t, _, _ = _torch_memory(taco)
    enc = 2 * small_cfg().tacotron.encoder_lstm_units
    got, want = {
        "encoder": (mem_t[..., :enc], mem_j[..., :enc]),
        "style": (mem_t[..., enc:], mem_j[..., enc:]),
        "keys": (keys_t, keys_j),
        "mask": (mask_t, mask_j),
    }[part]
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if part == "mask":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(want).max() > 1e-3      # not a trivially-zero pass
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_encoder_zeroes_padding(models):
    *_, taco, _ = models
    _, mem_t, _, _, _ = _torch_memory(taco)
    _, lengths, _ = inputs()
    enc = 2 * small_cfg().tacotron.encoder_lstm_units
    for b in range(B):
        assert torch.all(mem_t[b, lengths[b]:, :enc] == 0)


def test_postnet_pass_matches_flax(models):
    tparams, stats, _, taco, _ = models
    frames = np.random.default_rng(3).normal(
        0, 2, (B, 12, MELS)).astype(np.float32)
    dec_j, mel_j = Tacotron(config=small_cfg()).apply(
        {"params": tparams, "batch_stats": stats}, jnp.asarray(frames),
        method=Tacotron.postnet_pass)
    dec_t, mel_t = taco.postnet_pass(torch.as_tensor(frames))
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), atol=1e-6)
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), rtol=0,
                               atol=ATOL)


def test_upsample_matches_flax(models):
    _, _, wparams, _, wn = models
    mel = np.random.default_rng(4).uniform(0, 1, (2, 7, MELS)).astype(
        np.float32)
    want = WaveNet(config=small_cfg()).apply(
        {"params": wparams}, jnp.asarray(mel), method=WaveNet.upsample)
    got = wn.upsample(torch.as_tensor(mel))
    hop = small_cfg().audio.effective_hop
    assert tuple(got.shape) == (2, 7 * hop, MELS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_lstm_forget_bias_is_folded(models):
    tparams, _, _, taco, _ = models
    U = small_cfg().tacotron.encoder_lstm_units
    want = np.asarray(tparams["encoder_lstm"]["fw"]["bias"]).copy()
    want[2 * U:3 * U] += 1.0
    np.testing.assert_array_equal(taco.encoder_lstm.fw.bias.numpy(), want)
