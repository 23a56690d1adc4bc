"""Weight bridge: flax param trees (numpy leaves) -> the port's modules.

Takes what the JAX package trains and checkpoints — the Tacotron
`params` and `batch_stats` trees and the WaveNet (EMA) params, as read by
`utils/flax_msgpack.py` or handed over as arrays in tests — and fills:

- `Tacotron` (models/tacotron/model.py): embedding, encoder convs (flax
  [k, in, out] -> torch [out, in, k]) with BatchNorm statistics, the
  BiLSTM (TF gate order kept; the forget bias of 1.0 that the JAX
  `lstm_step` adds each step is folded into the f-gate bias here), both
  reference encoders (conv2d [kh, kw, in, out] -> [out, in, kh, kw]), GST
  tokens and attention, the attention memory layer, postnet and its
  projection;
- `WaveNet` (models/wavenet/model.py): the SubPixel upsample convs and
  the teacher-forced conv stack;
- the decoder and sampler parameter tuples through
  `ops/tacotron_decoder_kernel.extract_decoder_params` and
  `models/wavenet/sampler.extract_sampler_params` (weight norm
  materialised there).

Dense kernels keep flax's [in, out] layout (the port computes x @ kernel).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .config import Config
from .models.tacotron.model import Tacotron
from .models.wavenet.model import WaveNet
from .models.wavenet.modules import conv1x1_params, effective_kernel
from .utils import flax_msgpack


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _set(param: torch.Tensor, value) -> None:
    value = torch.from_numpy(np.array(value, np.float32))
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(value.shape)} "
                         f"where the config wants {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def _conv1d_block(block, p: Mapping, stats: Mapping) -> None:
    _set(block.weight, _np(p["Conv_0"]["kernel"]).transpose(2, 1, 0))
    _set(block.conv_bias, p["Conv_0"]["bias"])
    _bn(block.bn, p["BatchNorm_0"], stats["BatchNorm_0"])


def _bn(bn, p: Mapping, stats: Mapping) -> None:
    _set(bn.scale, p["scale"])
    _set(bn.bias, p["bias"])
    _set(bn.mean, stats["mean"])
    _set(bn.var, stats["var"])


def _dense(dense, p: Mapping) -> None:
    _set(dense.kernel, p["kernel"])
    if dense.bias is not None:
        _set(dense.bias, p["bias"])


def _lstm(cell, p: Mapping) -> None:
    U = cell.units
    bias = _np(p["bias"]).copy()
    bias[2 * U:3 * U] += 1.0            # folded forget bias (TF LSTMCell)
    _set(cell.kernel, p["kernel"])
    _set(cell.bias, bias)


def _refnet(ref, p: Mapping, stats: Mapping) -> None:
    for i in range(len(ref.convs)):
        _set(ref.convs[i], _np(p[f"conv2d_{i}"]["kernel"]).transpose(3, 2, 0, 1))
        _set(ref.conv_biases[i], p[f"conv2d_{i}"]["bias"])
        _bn(ref.bns[i], p[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"])
    g = p["GRU_0"]["GRUCell_0"]
    for name in ("gates_kernel", "gates_bias", "candidate_kernel",
                 "candidate_bias"):
        _set(getattr(ref.gru, name), g[name])
    _dense(ref.dense, p["Dense_0"])


def _style_attention(attn, p: Mapping) -> None:
    _dense(attn.q_proj, p["q_proj"])
    _dense(attn.k_proj, p["k_proj"])
    _set(attn.attention_v, p["attention_v"])
    _set(attn.attention_g, p["attention_g"])
    _set(attn.attention_b, p["attention_b"])


def tacotron_from_flax(cfg: Config, params: Mapping, batch_stats: Mapping,
                       device="cuda") -> Tacotron:
    """Build the port's Tacotron (eval) from flax `params`/`batch_stats`."""
    m = Tacotron(cfg)
    _set(m.embedding, params["inputs_embedding"]["embedding"])
    for i, block in enumerate(m.encoder_conv.layers):
        _conv1d_block(block, params["encoder_conv"][f"ConvBlock_{i}"],
                      batch_stats["encoder_conv"][f"ConvBlock_{i}"])
    _lstm(m.encoder_lstm.fw, params["encoder_lstm"]["fw"])
    _lstm(m.encoder_lstm.bw, params["encoder_lstm"]["bw"])
    for side in ("emt", "spk"):
        _refnet(getattr(m, f"refnet_{side}"), params[f"refnet_{side}"],
                batch_stats[f"refnet_{side}"])
        _set(getattr(m, f"style_tokens_{side}"), params[f"style_tokens_{side}"])
        _style_attention(getattr(m, f"gst_attn_{side}"),
                         params[f"gst_attn_{side}"])
    _set(m.memory_layer.kernel,
         params["decoder"]["cell"]["attention"]["memory_layer"]["kernel"])
    for i, block in enumerate(m.postnet.layers):
        _conv1d_block(block, params["postnet"][f"ConvBlock_{i}"],
                      batch_stats["postnet"][f"ConvBlock_{i}"])
    _dense(m.postnet_projection, params["postnet_projection"]["Dense_0"])
    return m.to(device).eval()


def wavenet_from_flax(cfg: Config, params: Mapping, device="cuda") -> WaveNet:
    """Build the port's WaveNet from flax WaveNet params: the SubPixel
    upsample convs ([kh, kw, 1, scale] -> [scale, 1, kh, kw]) and the conv
    stack, weight norm materialised (`modules.effective_kernel`), causal
    convs [kw, R, G] -> torch's [G, R, kw], missing biases zero."""
    m = WaveNet(cfg)
    for i, layer in enumerate(m.upsample_network.layers):
        conv = params["upsample_network"][f"up_{i}"]["Conv_0"]
        _set(layer.weight, _np(conv["kernel"]).transpose(3, 2, 0, 1))
        _set(layer.bias, conv["bias"])

    def dense(w, b, p):
        k, bias = conv1x1_params(p)
        _set(w, k)
        _set(b, np.zeros(w.shape[1], np.float32) if bias is None else bias)

    dense(m.first_w, m.first_b, params["input_convolution"])
    for i, blk in enumerate(m.blocks):
        p = params[f"residual_block_{i}"]
        cc = p["causal_conv"]
        cc = cc["Conv_0"] if "Conv_0" in cc else cc
        _set(blk.conv_w, effective_kernel(cc).transpose(2, 1, 0))
        _set(blk.conv_b, cc["bias"] if "bias" in cc
             else np.zeros(blk.conv_b.shape, np.float32))
        dense(blk.cin_w, blk.cin_b, p["cin_conv"])
        dense(blk.skip_w, blk.skip_b, p["skip_conv"])
        dense(blk.out_w, blk.out_b, p["out_conv"])
    dense(m.final1_w, m.final1_b, params["final_convolution_1"])
    dense(m.final2_w, m.final2_b, params["final_convolution_2"])
    return m.to(device).eval()


def load_checkpoints(taco_path: str, wn_path: str | None = None) -> Any:
    """Read the JAX package's msgpack checkpoints: returns (taco params,
    taco batch_stats, wavenet params or None) as nested dicts of numpy
    arrays."""
    taco = flax_msgpack.load(taco_path)
    return taco["params"], taco.get("batch_stats", {}), \
        (flax_msgpack.load(wn_path) if wn_path else None)


def load_wavenet(path: str) -> Any:
    """Read a WaveNet (EMA) params msgpack checkpoint as a nested dict of
    numpy arrays."""
    return flax_msgpack.load(path)
