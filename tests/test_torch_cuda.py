"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these need an NVIDIA GPU (sm_90a) and nvcc, and skip
elsewhere. Run them on the GPU machine with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Small configuration, random numpy weights in the flax tree layout (no JAX
needed: the GPU machine has none), injected random numbers (prenet dropout
on, live sampler noise), so both sides see the same inputs. The plain
versions run on the same card with TF32 off. Tolerances: the
decode kernel and its plain version both upcast the bf16 weights and sum
in f32, differing in summation order only (frames atol 1e-3 over 8
steps); the sampler is f32 throughout (atol 1e-4 over 64 fed-back samples).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tacotron2_tpu_torch.models.tacotron.decoder import drop_masks
from tacotron2_tpu_torch.models.wavenet.sampler import extract_sampler_params
from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.ops import wavenet_kernel as wk

MELS, P, U, A, F, KW, M, R = 20, 16, 32, 16, 8, 7, 48, 2


def torch_cfg():
    cfg = Config()
    return cfg.replace(
        tacotron=dataclasses.replace(
            cfg.tacotron, attention_dim=A, attention_filters=F,
            attention_kernel=KW, prenet_layers=(P, P), decoder_lstm_units=U,
            outputs_per_step=R, dropout_rate=0.0,
            fused_decoder_dtype="float32"),
        audio=dataclasses.replace(cfg.audio, num_mels=MELS, hop_size=4),
        wavenet=dataclasses.replace(
            cfg.wavenet, layers=4, stacks=2, upsample_scales=(2, 2),
            cin_channels=MELS))


def _w(rng, *shape):
    return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)


def decoder_tree(seed=0):
    rng = np.random.default_rng(seed)
    d = lambda i, o: {"kernel": _w(rng, i, o), "bias": _w(rng, o)}
    cell = {
        "prenet": {"Dense_0": d(MELS, P), "Dense_1": d(P, P)},
        "lstm1": d(P + M + U, 4 * U), "lstm2": d(2 * U, 4 * U),
        "attention": {
            "query_layer": {"kernel": _w(rng, U, A)},
            "location_features_convolution": {
                "kernel": _w(rng, KW, 1, F), "bias": _w(rng, F)},
            "location_features_layer": {"kernel": _w(rng, F, A)},
            "attention_variable_projection": _w(rng, A, 1),
            "attention_bias": _w(rng, A)},
        "frame_projection": {"Dense_0": d(U + M, R * MELS)},
        "stop_projection": {"Dense_0": d(U + M, R)}}
    return {"decoder": {"cell": cell}}


def sampler_tree(cfg, seed=1):
    rng = np.random.default_rng(seed)
    wn = cfg.wavenet
    Rc, G, S = wn.residual_channels, wn.gate_channels, wn.skip_out_channels
    d = lambda i, o: {"Dense_0": {"kernel": _w(rng, i, o),
                                  "bias": _w(rng, o)}}
    tree = {f"residual_block_{i}": {
        "causal_conv": {"Conv_0": {"kernel": _w(rng, 3, Rc, G) / 2,
                                   "bias": _w(rng, G)}},
        "cin_conv": d(MELS, G), "skip_conv": d(G // 2, S),
        "out_conv": d(G // 2, Rc)} for i in range(wn.layers)}
    tree.update(input_convolution=d(1, Rc), final_convolution_1=d(S, S),
                final_convolution_2=d(S, 2))
    head = tree["final_convolution_2"]["Dense_0"]     # keep samples off
    head["kernel"] *= 0.1                              # the ±1 clip
    head["bias"][:] = (0.0, -3.0)
    return tree

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) for the port's kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_decoder_kernel_matches_plain(dev):
    tparams = decoder_tree()
    cfg = torch_cfg()
    cfg = cfg.replace(tacotron=dataclasses.replace(
        cfg.tacotron, dropout_rate=0.5, fused_decoder_dtype="bfloat16"))
    B, T, steps = 3, 24, 8
    rng = np.random.default_rng(0)
    memory = torch.as_tensor(rng.normal(size=(B, T, M)), dtype=torch.float32,
                             device=dev)
    keys = torch.as_tensor(rng.normal(size=(B, T, 16)) * 0.3,
                           dtype=torch.float32, device=dev)
    mask = torch.arange(T, device=dev)[None] < torch.as_tensor(
        [T, 17, 9], device=dev)[:, None]
    dp = dk.extract_decoder_params(tparams, cfg, device=dev)
    drop = drop_masks(cfg, B, steps, torch.Generator(dev).manual_seed(1), dev)
    before = dk.launches
    f_k, s_k = dk.decode(dp, cfg, keys, memory, mask, drop, steps=steps,
                         early_stop_block=4,
                         kernel_weights=dk.pack_weights(dp))
    assert dk.launches == before + 1
    f_p, s_p = dk.decode_plain(dp, cfg, keys, memory, mask, drop,
                               steps=steps, early_stop_block=4)
    torch.cuda.synchronize()
    np.testing.assert_allclose(f_k.cpu(), f_p.cpu(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(s_k.cpu(), s_p.cpu(), atol=1e-4, rtol=0)


def test_sampler_kernel_matches_plain(dev):
    cfg = torch_cfg()
    wparams = sampler_tree(cfg)
    B, T = 2, 64
    sp = extract_sampler_params(wparams, cfg, device=dev)
    g = torch.Generator(dev).manual_seed(2)
    c_up = torch.rand(B, T, MELS, generator=g, device=dev)
    z = torch.randn(B, T, generator=g, device=dev)
    before = wk.launches
    y_k = wk.sample(sp, cfg, c_up, z,
                    kernel_weights=wk.pack_weights(sp, cfg))
    assert wk.launches == before + 1
    y_p = wk.sample_plain(sp, cfg, c_up, z)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y_k.cpu(), y_p.cpu(), atol=1e-4, rtol=0)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(dev):
    cfg = torch_cfg()                      # f32 decode weights
    tparams, wparams = decoder_tree(), sampler_tree(cfg)
    dp = dk.extract_decoder_params(tparams, cfg, device=dev)
    args = (torch.zeros(1, 4, A, device=dev), torch.zeros(1, 4, M, device=dev),
            torch.ones(1, 4, device=dev), torch.ones(1, 2, 2, P, device=dev))
    for kw in (dk.pack_weights(dp), None):     # f32 weights; none packed
        with pytest.raises(ValueError):
            dk.decode(dp, cfg, *args, steps=2, kernel_weights=kw)
    sp = extract_sampler_params(wparams, cfg, device=dev)
    c_up, z = torch.zeros(1, 8, MELS, device=dev), torch.zeros(1, 8, device=dev)
    with pytest.raises(ValueError):
        wk.sample(sp, cfg, c_up.double(), z,
                  kernel_weights=wk.pack_weights(sp, cfg))
    with pytest.raises(ValueError):
        wk.sample(sp, cfg, c_up, z)
