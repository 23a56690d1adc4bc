"""Weight bridge: flax param trees (numpy leaves) <-> the port's modules.

Takes what the JAX package trains and checkpoints — the Tacotron
`params` and `batch_stats` trees and the WaveNet (EMA) params, as read by
`utils/flax_msgpack.py` or handed over as arrays in tests — and fills:

- `Tacotron` (models/tacotron/model.py), by one table of flax paths
  (`flax_path`) that also runs the other way (`tacotron_to_flax`, for the
  port's checkpoints and the parity tests): embedding, encoder convs (flax
  [k, in, out] -> torch [out, in, k]) with BatchNorm statistics, the
  BiLSTM (TF gate order kept; the forget bias of 1.0 that the JAX
  `lstm_step` adds each step is folded into the f-gate bias here), the
  reference encoders (conv2d [kh, kw, in, out] -> [out, in, kh, kw]; the
  emt_attn variant's BiGRU or 8 GRU heads; AdaIN's `reference_encoder`),
  GST tokens and attention, the
  decoder (flax layout as it is, with the emt attention's W1/W2/V or
  q_proj/k_proj/attention_* and attn_emt_out), postnet and its
  projection, the CBHG head of `predict_linear` (`post_cbhg`: bank and
  projection convs, highway layers, BiGRU; `cbhg_linear_specs_
  projection`), the style classifier heads and the training heads (the
  adversarial `style_disc_*_adv`, nat-GAN's `nat_gan_enc` and
  `nat_gan_disc*`, the frozen `pretrained_ref_enc_*` encoders and their
  `_dense` heads); `init_tacotron` draws a fresh one from the flax
  initialisers' distributions;
- `WaveNet` (models/wavenet/model.py), both ways (`wavenet_from_flax`,
  `wavenet_to_flax`): the upsample layers of every `upsample_type` (none
  without local conditioning), the speaker table `gc_embedding` and the
  blocks' `gin_conv` where the tree has them, and the conv stack,
  weight-normed convs as their `v`, `g` and `bias`; `init_wavenet` draws
  a fresh one;
- the decoder and sampler parameter tuples through
  `ops/tacotron_decoder_kernel.extract_decoder_params` and
  `models/wavenet/sampler.extract_sampler_params` (weight norm
  materialised there).

Dense kernels keep flax's [in, out] layout (the port computes x @ kernel).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from .config import Config
from .models.tacotron.model import Tacotron
from .models.wavenet.model import WaveNet
from .models.wavenet.modules import effective_kernel
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


# The port's Tacotron parameter and buffer names -> their flax paths, by
# rule (the flax trees as models/tacotron/model.py's JAX Tacotron builds
# them). Conv kernels change layout on the way (`_LAYOUT`); the encoder
# LSTM biases carry the folded forget bias (`_lstm_offset`).
# the reference encoders: the model's two (or AdaIN's one), the frozen
# pretrained classifiers' and nat-GAN's; a style discriminator's
# (`disc/model.py`)
_REF = (r"(refnet_\w+?|pretrained_ref_enc(?:_emt|_spk)?|nat_gan_enc|emt_disc"
        r"|reference_encoder)")
_RULES = [
    (r"embedding", "inputs_embedding/embedding"),
    (r"(encoder_conv|postnet|post_cbhg)\.layers\.(\d+)\.weight",
     r"\1/ConvBlock_\2/Conv_0/kernel"),
    (r"(encoder_conv|postnet|post_cbhg)\.layers\.(\d+)\.conv_bias",
     r"\1/ConvBlock_\2/Conv_0/bias"),
    (r"(encoder_conv|postnet|post_cbhg)\.layers\.(\d+)\.bn\.(\w+)",
     r"\1/ConvBlock_\2/BatchNorm_0/\3"),
    (r"post_cbhg\.dense\.(\w+)", r"post_cbhg/Dense_0/\1"),
    (r"post_cbhg\.highways\.(\d+)\.(H|T)\.(\w+)",
     lambda m: f"post_cbhg/highway_{int(m.group(1)) + 1}/{m.group(2)}/"
               f"{m.group(3)}"),
    (r"post_cbhg\.bigru\.(fw|bw)\.(\w+)",
     r"post_cbhg/BiGRU_0/\1/GRUCell_0/\2"),
    (r"encoder_lstm\.(fw|bw)\.(kernel|bias)", r"encoder_lstm/\1/\2"),
    (_REF + r"\.convs\.(\d+)", r"\1/conv2d_\2/kernel"),
    (_REF + r"\.conv_biases\.(\d+)", r"\1/conv2d_\2/bias"),
    (_REF + r"\.bns\.(\d+)\.(\w+)", r"\1/BatchNorm_\2/\3"),
    (_REF + r"\.gru\.(\w+)", r"\1/GRU_0/GRUCell_0/\2"),
    (_REF + r"\.dense\.(\w+)", r"\1/Dense_0/\2"),
    (_REF + r"\.bigru\.(fw|bw)\.(\w+)", r"\1/BiGRU_0/\2/GRUCell_0/\3"),
    (_REF + r"\.grus\.(\d+)\.(\w+)", r"\1/gru_\2/GRUCell_0/\3"),
    (_REF + r"\.denses\.(\d+)\.(\w+)", r"\1/dense_\2/\3"),
    (r"(gst_attn_\w+?)\.(q_proj|k_proj)\.(\w+)", r"\1/\2/\3"),
    (r"(gst_attn_\w+?)\.(attention_\w)", r"\1/\2"),
    (r"(style_tokens_\w+)", r"\1"),
    (r"decoder\.(.+)", lambda m: "decoder/cell/" + m.group(1).replace(".", "/")),
    (r"(postnet_projection|cbhg_linear_specs_projection|style_disc_\w+?"
     r"|nat_gan_disc\w*?)\.(kernel|bias)", r"\1/Dense_0/\2"),
    (r"(pretrained_ref_enc(?:_emt|_spk)?_dense|emt_disc_logit)\."
     r"(kernel|bias)", r"\1/\2"),
    (r"(w|b)", r"\1"),     # a GE2E discriminator's scale and bias
]
# flax layout of a torch conv weight: [out, in, k] -> [k, in, out];
# [out, in, kh, kw] -> [kh, kw, in, out]
_LAYOUT = {3: (2, 1, 0), 4: (2, 3, 1, 0)}


def flax_path(name: str) -> str:
    """The flax path ("encoder_conv/ConvBlock_0/Conv_0/kernel") of one of
    the port Tacotron's parameter or buffer names; BatchNorm's mean and
    var buffers lie in the batch_stats tree."""
    for pat, rep in _RULES:
        m = re.fullmatch(pat, name)
        if m:
            return m.expand(rep) if isinstance(rep, str) else rep(m)
    raise KeyError(f"no flax path for the port's {name!r}")


def _is_conv(name: str) -> bool:
    return name.endswith(".weight") or ".convs." in name


def _lstm_offset(name: str, shape) -> np.ndarray | None:
    """+1 on the f block of an encoder LSTM bias (TF LSTMCell's forget
    bias, added each step by the JAX `lstm_step`, folded here)."""
    if not re.fullmatch(r"encoder_lstm\.(fw|bw)\.bias", name):
        return None
    U = shape[0] // 4
    off = np.zeros(shape, np.float32)
    off[2 * U:3 * U] = 1.0
    return off


def to_flax_array(name: str, x: torch.Tensor, *, offset: bool = True
                  ) -> np.ndarray:
    """A port tensor in its flax layout (numpy f32); `offset=False` for
    tensors that are not the parameter itself (its Adam moments)."""
    a = x.detach().float().cpu().numpy()
    if _is_conv(name):
        a = a.transpose(_LAYOUT[a.ndim])
    off = _lstm_offset(name, a.shape) if offset else None
    return np.array(a - off if off is not None else a, np.float32, order="C")


def from_flax_array(name: str, a, *, offset: bool = True) -> np.ndarray:
    """The inverse of `to_flax_array`."""
    a = _np(a)
    off = _lstm_offset(name, a.shape) if offset else None
    if off is not None:
        a = a + off
    if _is_conv(name):
        a = a.transpose(np.argsort(_LAYOUT[a.ndim]))
    return np.array(a, np.float32, order="C")


def flax_named_parameters(model: torch.nn.Module):
    """[(flax path, parameter)] of every trainable tensor, in the module's
    order."""
    return [(flax_path(n), p) for n, p in model.named_parameters()]


def tree_get(tree: Mapping, path: str):
    """The leaf of a nested dict at a "/"-joined path."""
    for key in path.split("/"):
        tree = tree[key]
    return tree


def tree_set(tree: dict, path: str, value) -> None:
    """Set the leaf at a "/"-joined path, making the dicts on the way."""
    *head, last = path.split("/")
    for key in head:
        tree = tree.setdefault(key, {})
    tree[last] = value


def tacotron_to_flax(model: Tacotron):
    """The port Tacotron's parameters and BatchNorm statistics -> (params,
    batch_stats), flax-named trees of numpy f32 arrays, as the JAX
    package's checkpoints hold them (the inverse of `tacotron_from_flax`)."""
    params, stats = {}, {}
    for name, p in model.named_parameters():
        tree_set(params, flax_path(name), to_flax_array(name, p))
    for name, b in model.named_buffers():
        tree_set(stats, flax_path(name), to_flax_array(name, b))
    return params, stats


def load_tacotron(model: Tacotron, params: Mapping,
                  batch_stats: Mapping) -> Tacotron:
    """Fill the port Tacotron from flax `params`/`batch_stats` trees."""
    for name, p in model.named_parameters():
        _set(p, from_flax_array(name, tree_get(params, flax_path(name))))
    for name, b in model.named_buffers():
        _set(b, _np(tree_get(batch_stats, flax_path(name))))
    return model


def disc_to_flax(model) -> tuple:
    """A style discriminator's (`disc/model.py`: DiscriminatorModel or
    EmtDisc) parameters and BatchNorm statistics -> (params, batch_stats),
    the flax trees of the JAX modules: {pretrained_ref_enc: ...,
    pretrained_ref_enc_dense | w, b} or {emt_disc: ..., emt_disc_logit}."""
    return tacotron_to_flax(model)


def load_disc(model, params: Mapping, batch_stats: Mapping):
    """Fill a style discriminator from its flax trees (`disc_to_flax`'s
    inverse)."""
    return load_tacotron(model, params, batch_stats)


def tacotron_from_flax(cfg: Config, params: Mapping, batch_stats: Mapping,
                       device="cuda", emt_only: bool = False,
                       pretrained_emb_disc_all: bool = False) -> Tacotron:
    """Build the port's Tacotron for inference (eval mode, parameters
    frozen) from flax `params`/`batch_stats`; `pretrained_emb_disc_all`
    for weights trained with it (its style path bypasses GST)."""
    m = load_tacotron(Tacotron(cfg, emt_only, pretrained_emb_disc_all=
                               pretrained_emb_disc_all), params, batch_stats)
    return m.to(device).eval().requires_grad_(False)


def _glorot(shape, g) -> torch.Tensor:
    """flax glorot_uniform: U(±sqrt(6 / (fan_in + fan_out))), fans over
    the receptive field of a conv kernel."""
    rf = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
    lim = (6.0 / (fan_in + fan_out)) ** 0.5
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * lim


def init_tacotron(cfg: Config, generator=None, device="cuda",
                  emt_only: bool = False, **flags) -> Tacotron:
    """A freshly initialised Tacotron, drawn from the distributions of the
    JAX package's flax initialisers (not their values): glorot-uniform
    kernels and embedding, zero biases, GRU gate biases 1, BatchNorm scale
    1, style tokens truncated-normal(0.5) within ±2σ, the GST scorer's v
    uniform ±sqrt(6/hd) and g sqrt(1/hd), the CBHG's highway T biases -1;
    BatchNorm statistics (0, 1), as the module starts them. `flags` are
    the model's training heads (`Tacotron`'s keywords)."""
    g = generator if generator is not None else torch.Generator()
    return init_params(Tacotron(cfg, emt_only, **flags), cfg, g).to(device)


def init_params(model: torch.nn.Module, cfg: Config, g) -> torch.nn.Module:
    """Draw every parameter of a module that `flax_path` names (a Tacotron
    or a style discriminator) from its flax initialiser's distribution
    with the generator `g`, in place; BatchNorm statistics stay as the
    module starts them. A GE2E discriminator's w and b start at 10 and -5
    (disc/model.py:40-41)."""
    params, stats = tacotron_to_flax(model)
    new = {}
    for name, _ in model.named_parameters():
        path = flax_path(name)
        shape = tree_get(params, path).shape
        leaf = path.split("/")[-1]
        if path in ("w", "b"):
            v = torch.full(shape, 10.0 if path == "w" else -5.0)
        elif leaf == "gates_bias" or (leaf == "scale" and "BatchNorm" in path):
            v = torch.ones(shape)
        elif re.fullmatch(r".*/highway_\d+/T/bias", path):
            v = torch.full(shape, -1.0)
        elif leaf in ("bias", "candidate_bias", "attention_b",
                      "attention_bias"):
            v = torch.zeros(shape)
        elif leaf.startswith("style_tokens"):
            v = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0,
                                            -2.0, 2.0, generator=g) * 0.5
        elif leaf == "attention_v":
            lim = (6.0 / shape[0]) ** 0.5
            v = (torch.rand(shape, generator=g) * 2.0 - 1.0) * lim
        elif leaf == "attention_g":
            hd = cfg.gst.style_att_dim // cfg.gst.num_heads
            v = torch.full(shape, (1.0 / hd) ** 0.5)
        else:
            v = _glorot(shape, g)
        tree_set(new, path, v.numpy())
    return load_tacotron(model, new, stats)


def _wavenet_convs(model: WaveNet):
    """(flax prefix, module, kind) of every conv of the port's WaveNet:
    kind "up" (an upsample layer, `modules._Up`), "conv" (causal) or
    "dense" (1×1); the blocks' cin_conv and gin_conv where the model has
    them."""
    if model.upsample_network is not None:
        for i, layer in enumerate(model.upsample_network.layers):
            yield f"upsample_network/up_{i}", layer, "up"
    yield "input_convolution", model.input_convolution, "dense"
    for i, blk in enumerate(model.residual_blocks):
        p = f"residual_block_{i}"
        yield f"{p}/causal_conv", blk.causal_conv, "conv"
        for name in ("cin_conv", "gin_conv", "skip_conv", "out_conv"):
            if getattr(blk, name) is not None:
                yield f"{p}/{name}", getattr(blk, name), "dense"
    for name in ("final_convolution_1", "final_convolution_2"):
        yield name, getattr(model, name), "dense"


def _wavenet_leaves(model: WaveNet):
    """(flax path, attribute, module, kind) of every WaveNet parameter, in
    the module's order: the speaker table `gc_embedding/embedding` where
    the model has one; plain convs nest under Conv_0 / Dense_0 (an
    upsample layer under its `leaves`), weight-normed ones hold v, g and
    bias directly (the JAX modules' trees)."""
    if model.gc_embedding is not None:
        yield "gc_embedding/embedding", "gc_embedding", model, "embed"
    for prefix, mod, kind in _wavenet_convs(model):
        if kind == "up":
            for leaf, attr in mod.leaves:
                yield f"{prefix}/{leaf}", attr, mod, kind
            continue
        if mod.is_weight_normed:
            names, inner = ("v", "g", "bias"), prefix
        else:
            names = ("kernel", "bias")
            inner = f"{prefix}/{'Conv_0' if kind == 'conv' else 'Dense_0'}"
        for n in names:
            if getattr(mod, n) is not None:
                yield f"{inner}/{n}", n, mod, kind


def _torch_layout_kernel(path: str) -> bool:
    """An upsample Conv_0 kernel, held in torch's conv2d layout."""
    return path.startswith("upsample_network") and \
        path.endswith("Conv_0/kernel")


def wavenet_flax_array(path: str, x: torch.Tensor) -> np.ndarray:
    """A WaveNet tensor (a parameter or its Adam moment) in its flax
    layout: the SubPixel and Resize kernels [out, in, kh, kw] -> [kh, kw,
    in, out]; the rest are held in it."""
    a = x.detach().float().cpu().numpy()
    if _torch_layout_kernel(path):
        a = a.transpose(2, 3, 1, 0)
    return np.array(a, np.float32, order="C")


def wavenet_port_array(path: str, a) -> np.ndarray:
    """The inverse of `wavenet_flax_array`."""
    a = _np(a)
    if _torch_layout_kernel(path):
        a = a.transpose(3, 2, 0, 1)
    return np.array(a, np.float32, order="C")


def wavenet_named_parameters(model: WaveNet):
    """[(flax path, parameter)] of every WaveNet parameter."""
    return [(path, getattr(mod, attr))
            for path, attr, mod, _ in _wavenet_leaves(model)]


def wavenet_to_flax(model: WaveNet) -> dict:
    """The port WaveNet's parameters -> a flax-named tree of numpy f32
    arrays, the layout `WaveNetSynthesizer`, `cli synthesize
    --wavenet-checkpoint` and the JAX package read."""
    tree = {}
    for path, p in wavenet_named_parameters(model):
        tree_set(tree, path, wavenet_flax_array(path, p))
    return tree


def load_wavenet_params(model: WaveNet, params: Mapping) -> WaveNet:
    """Fill the port WaveNet from flax WaveNet params. A plain module
    takes a weight-normed tree's materialised kernel
    (`modules.effective_kernel`); a bias the tree lacks is zero."""
    if model.gc_embedding is not None:
        _set(model.gc_embedding, tree_get(params, "gc_embedding/embedding"))
    for prefix, mod, kind in _wavenet_convs(model):
        sub = tree_get(params, prefix)
        if kind == "up":
            for leaf, attr in mod.leaves:
                path = f"{prefix}/{leaf}"
                _set(getattr(mod, attr),
                     wavenet_port_array(path, tree_get(params, path)))
            continue
        inner = sub.get("Conv_0", sub.get("Dense_0", sub))
        if mod.is_weight_normed:
            if "v" not in inner:
                raise ValueError(f"{prefix}: the config wants weight norm, "
                                 "the checkpoint holds a plain kernel")
            _set(mod.v, inner["v"])
            _set(mod.g, inner["g"])
        else:
            _set(mod.kernel, effective_kernel(inner))
        if mod.bias is not None:
            _set(mod.bias, inner["bias"] if "bias" in inner
                 else np.zeros(mod.bias.shape, np.float32))
    return model


def has_global_conditioning(params: Mapping) -> bool:
    """Whether a flax WaveNet tree holds the speaker input's weights (flax
    makes them only where its init saw `g`)."""
    return "gc_embedding" in params or \
        "gin_conv" in params.get("residual_block_0", {})


def wavenet_from_flax(cfg: Config, params: Mapping, device="cuda", *,
                      trainable: bool = False) -> WaveNet:
    """Build the port's WaveNet from flax WaveNet params (with the speaker
    input where the tree has its weights): for inference (eval mode,
    parameters frozen), or `trainable`."""
    m = load_wavenet_params(
        WaveNet(cfg, has_global_conditioning(params)), params).to(device)
    return m if trainable else m.eval().requires_grad_(False)


def init_wavenet(cfg: Config, generator=None, device="cuda", *,
                 global_conditioning: bool = True) -> WaveNet:
    """A freshly initialised WaveNet, drawn from the distributions of the
    JAX package's flax initialisers: glorot-uniform kernels (and v, with
    g = ‖v‖ · init_scale per output channel), zero biases, the speaker
    table normal with std 0.1, and the upsample layers' nn_init kernels
    (`wavenet.nn_init`, scaled by nn_scaler^(1/layers); flax's values bit
    for bit) or glorot. `global_conditioning=False` leaves out the speaker
    input (`WaveNet`)."""
    g = generator if generator is not None else torch.Generator()
    wn = cfg.wavenet
    model = WaveNet(cfg, global_conditioning)
    pow_scaler = (wn.nn_scaler ** (1.0 / len(wn.upsample_scales))
                  if wn.upsample_scales else 1.0)
    with torch.no_grad():
        if model.gc_embedding is not None:
            model.gc_embedding.copy_(torch.randn(
                model.gc_embedding.shape, generator=g) * 0.1)
        for _, mod, kind in _wavenet_convs(model):
            if kind == "up":
                if wn.nn_init:
                    mod.nn_init(pow_scaler)
                else:
                    mod.set_flax_kernel(
                        _glorot(mod.flax_kernel().shape, g).numpy())
                continue
            if mod.is_weight_normed:
                mod.v.copy_(_glorot(mod.v.shape, g))
                mod.g.copy_(torch.sqrt((mod.v ** 2).sum(
                    tuple(range(mod.v.dim() - 1)))) * wn.init_scale)
            else:
                mod.kernel.copy_(_glorot(mod.kernel.shape, g))
            if mod.bias is not None:
                mod.bias.zero_()
    return model.to(device)


def load_checkpoints(taco_path: str, wn_path: str | None = None) -> Any:
    """Read the JAX package's msgpack checkpoints: returns (taco params,
    taco batch_stats, wavenet params or None) as nested dicts of numpy
    arrays."""
    taco = flax_msgpack.load(taco_path)
    return taco["params"], taco.get("batch_stats", {}), \
        (flax_msgpack.load(wn_path) if wn_path else None)


def load_wavenet(path: str) -> Any:
    """Read WaveNet weights for synthesis from a msgpack file: an EMA
    params tree (as the JAX package writes wn_ckpt.msgpack), or a
    training checkpoint of `train/checkpoint.py`, whose `ema_params` it
    returns. Nested dicts of numpy arrays."""
    tree = flax_msgpack.load(path)
    return tree["ema_params"] if "ema_params" in tree else tree
