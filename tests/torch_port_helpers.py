"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py).

A small configuration (a few layers, narrow widths) and randomly
initialised flax weights, made from fixed seeds and handed to both
packages as numpy arrays: the JAX package runs as its own tests run it
(Pallas kernels in interpret mode, or the scan references), the port runs
its plain versions on the CPU.
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from tacotron2_tpu.config import Config
from tacotron2_tpu.models.tacotron.model import Tacotron
from tacotron2_tpu.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.config import Config as TorchConfig

B, T_IN, T_REF, STEPS = 4, 24, 16, 6
MELS = 20


def small_cfg(cls=Config):
    """The small configuration of tests/test_pipeline_program.py, built
    from either package's own Config class."""
    cfg = cls()
    return cfg.replace(
        tacotron=dataclasses.replace(
            cfg.tacotron, embedding_dim=32, enc_conv_num_layers=2,
            enc_conv_channels=32, enc_conv_kernel_size=3,
            encoder_lstm_units=16, attention_dim=16, attention_filters=8,
            attention_kernel=7, prenet_layers=(16, 16),
            decoder_lstm_units=32, postnet_num_layers=2, postnet_channels=32,
            postnet_kernel_size=3, outputs_per_step=2, dropout_rate=0.0,
            fused_decoder_dtype="float32"),
        gst=dataclasses.replace(
            cfg.gst, num_gst=4, num_heads=2, style_embed_depth=8,
            style_att_dim=8, reference_filters=(4, 4), reference_depth=8,
            n_emt=4, n_spk=3),
        audio=dataclasses.replace(cfg.audio, num_mels=MELS, hop_size=4),
        wavenet=dataclasses.replace(
            cfg.wavenet, layers=4, stacks=2, residual_channels=128,
            gate_channels=256, skip_out_channels=128, upsample_scales=(2, 2),
            cin_channels=MELS, sampler_chunk=16),
    )


def to_numpy(tree):
    """flax / jax tree -> nested dict of float32 numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@lru_cache(maxsize=None)
def inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 60, (B, T_IN)).astype(np.int32)
    lengths = np.asarray([T_IN, T_IN - 3, T_IN - 7, 12], np.int32)
    refs = rng.uniform(-4, 4, (B, T_REF, MELS)).astype(np.float32)
    return ids, lengths, refs


@lru_cache(maxsize=None)
def flax_weights(pin_stop: float = -30.0, pin_noise: bool = True):
    """(taco params, batch_stats, wavenet params) as numpy trees.

    The stop projection's bias is pinned (-30: no stream stops; random-init
    stop probs sit at the 0.5 threshold) and the sampler's log-scale channel
    pinned to -30 so sampling noise is suppressed (sample = mean), as in
    tests/test_pipeline_program.py. BatchNorm statistics are drawn away
    from their (0, 1) init so the bridge's handling of them shows."""
    cfg = small_cfg()
    ids, lengths, refs = inputs()
    taco = Tacotron(config=cfg)
    tvars = taco.init(
        dict(params=jax.random.PRNGKey(0), dropout=jax.random.PRNGKey(1),
             zoneout=jax.random.PRNGKey(2),
             teacher_forcing=jax.random.PRNGKey(3)),
        jnp.asarray(ids), jnp.asarray(lengths), ref_mel_emt=refs,
        ref_mel_spk=refs, synthesis=True, max_steps=STEPS, train=False)
    tparams = to_numpy(tvars["params"])
    stats = to_numpy(tvars.get("batch_stats", {}))
    rng = np.random.default_rng(7)

    def jitter(t):
        for k, v in t.items():
            if isinstance(v, dict):
                jitter(v)
            elif k == "mean":
                t[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
            elif k == "var":
                t[k] = (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
    jitter(stats)
    sp = tparams["decoder"]["cell"]["stop_projection"]["Dense_0"]
    sp["bias"] = np.full_like(sp["bias"], pin_stop)

    wn = WaveNet(config=cfg)
    hop = cfg.audio.effective_hop
    frames = STEPS * cfg.tacotron.outputs_per_step
    wvars = wn.init(
        dict(params=jax.random.PRNGKey(4), dropout=jax.random.PRNGKey(5)),
        jnp.zeros((1, frames * hop, 1)), jnp.zeros((1, frames, MELS)),
        train=False)
    wparams = to_numpy(wvars["params"])
    if pin_noise:
        fc2 = wparams["final_convolution_2"]["Dense_0"]
        fc2["bias"] = fc2["bias"].copy()
        fc2["bias"][1] = -30.0
        fc2["kernel"] = fc2["kernel"].copy()
        fc2["kernel"][:, 1] = 0.0
    return tparams, stats, wparams


def torch_cfg():
    return small_cfg(TorchConfig)


def mma_a_positions(ks):
    """(row, col) of each value lane l holds of a 16 × ks A operand of
    mma.sync, in register order (PTX ISA, "Matrix Fragments for mma.m16n8k16
    with floating point type" (bf16, ks 16) and "... mma.m16n8k8" (.tf32,
    ks 8)): groupID = l >> 2, threadID_in_group = l % 4; bf16 registers
    a0..a7 at rows (g, g, g+8, g+8, g, g, g+8, g+8) and columns (2t, 2t+1,
    2t, 2t+1, 2t+8, 2t+9, 2t+8, 2t+9); tf32 a0..a3 at rows (g, g+8, g,
    g+8), columns (t, t, t+4, t+4)."""
    out = []
    for lane in range(32):
        g, t = lane >> 2, lane % 4
        if ks == 16:
            rows = (g, g, g + 8, g + 8, g, g, g + 8, g + 8)
            cols = (2 * t, 2 * t + 1, 2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9,
                    2 * t + 8, 2 * t + 9)
        else:
            rows, cols = (g, g + 8, g, g + 8), (t, t, t + 4, t + 4)
        out.append(list(zip(rows, cols)))
    return out


def unpack_sampler_slices(slices, lay, dtype):
    """The sampler kernel's packed operands (`ops/wavenet_kernel.py:
    stack_weights`), bytes [cs, L, slice], read back as the kernel's warps
    read them: the gate product's A tiles over the x_t rows [cs, L, 16·mtg,
    R] and over the older taps' and c_t rows [cs, L, 16·mtg, 2R + c16], the
    skip|out product's [cs, L, 16·mts, G/2] (in `dtype`, as f32), then the
    biases [cs, L, 16·mtg] and [cs, L, 16·mts]."""
    import torch
    cs, L, _ = slices.shape
    E = 8 if lay.ks == 16 else 4
    pos = mma_a_positions(lay.ks)

    def tiles(raw, mt, kt):
        v = raw.contiguous().view(dtype).float().reshape(cs, L, mt, kt, 32, E)
        w = torch.zeros(cs, L, mt, 16, kt, lay.ks)
        for lane in range(32):
            for e, (m, k) in enumerate(pos[lane]):
                w[:, :, :, m, :, k] = v[..., lane, e]
        return w.reshape(cs, L, 16 * mt, kt * lay.ks)

    o1 = lay.tiles_x
    o2 = o1 + lay.tiles_o
    o3 = o2 + lay.tiles_s
    wx = tiles(slices[..., :o1], lay.mtg, lay.ktx)
    wo = tiles(slices[..., o1:o2], lay.mtg, lay.kto)
    ws = tiles(slices[..., o2:o3], lay.mts, lay.kts)
    bias = slices[..., o3:].contiguous().view(torch.float32)
    return wx, wo, ws, bias[..., :16 * lay.mtg], bias[..., 16 * lay.mtg:]


def gate_units(z, gc):
    """[..., 16·mtg] gate rows (m-tile mt: a of units 8mt .. 8mt+7, then
    their b) -> (a [..., gc], b [..., gc])."""
    z = z.reshape(*z.shape[:-1], -1, 2, 8)
    return (z[..., 0, :].flatten(-2)[..., :gc],
            z[..., 1, :].flatten(-2)[..., :gc])
