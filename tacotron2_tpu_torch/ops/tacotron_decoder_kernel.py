"""The autoregressive Tacotron decode as a CUDA block kernel.

Port of tacotron2_tpu/ops/tacotron_decoder_kernel.py: `extract_decoder_
params` (:94) flattens the flax decoder subtree (`extract_emt_params` its
emt_attn attention, `extract_prenet` a prenet of any shape for the plain
decode; the kernels take two prenet layers of one width);
`DecoderKernelState` / `init_decoder_state` (:239, :258) are the carried
state; `decode_block` is `build_decoder_block_kernel` (:321), K steps from
explicit state; `decode` is `build_decoder_kernel` (:842), the whole decode
with the batch-wide early stop, run as a chain of block launches. Both go
through `csrc/decoder_rows.cu` (one cluster for 8 rows, each weight tile
read once a step for all of them) for CUDA tensors, under emt_attn through
`csrc/decoder.cu`, and through the plain versions
(`models/tacotron/decoder.py:decode_block`, `autoregressive`) for CPU
tensors. The teacher-forced decode of `ops/tacotron_train_kernel.py` is
`decoder_rows.cu`'s teacher-forced mode, launched through `prepare_rows` /
`rows_launch` here. The kernels take their weights in their own per-CTA
layouts, which `pack_weights` builds once per set of weights (at load
time, not per call): `rows_stream` the stream of mma tiles of
`decoder_rows.cu`, the rest `decoder.cu`'s operands, which the backward
kernel (`tacotron_train_kernel.bwd_stream`) repacks. Each kernel's design
and its bound are in the note at the top of its source.

Under `gst.emt_attn` the decode also runs the emt attention of the TPU
block kernel (:508-553) — the `simple` and `multihead` scorers — and
LSTM1's feed of its context: `decode` and `decode_block` take the call's
`emt` operands (`models/tacotron/decoder.py:emt_operands`, the emt keys
with their constants folded, the score rows, the emt memory and ref_spk's
constant addend), `pack_weights` the emt weights, and the carried state
its context_emt. The `style_tokens` variant, which the JAX package decodes
with its XLA scan and no kernel, decodes through the plain version; the
kernel refuses it.

The TPU kernels' `context_mode` variants and their 128-wide tiles of the
location operands are TPU layout choices and have no counterpart: the
kernel works at any input length that fits shared memory. Kernel and plain
version take the decode weights in `tacotron.fused_decoder_dtype`, bf16
(the default) or f32, one type for every matmul weight. With bf16 weights
both round what the TPU kernels round (`models/tacotron/decoder.py:
Casts`): every product input, the memory, the location taps and the keys,
and on the block route v_a and, at the block kernel's default
`energy_mode` ("vmat" without emt_attn), the energies' tanh;
`decode_block` takes the `casts` to round (default the block kernel's,
`BLOCK` / `BLOCK_EMT`; `WHOLE` the whole decode's). With f32 weights nothing is
rounded and the products run on the FP32 cores. `tacotron.smoothing`
normalises sigmoids in place of the softmax, as both TPU kernels do.
Prenet dropout arrives as multipliers drawn by the caller
(`models/tacotron/decoder.py:drop_masks`). Alignments come out in f32 (the
TPU kernels store them in bf16).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..models.tacotron.attention import fold_location, identity
from ..models.tacotron.decoder import (BLOCK, BLOCK_EMT, TEACHER_FORCED,
                                      WHOLE, Casts, DecoderKernelState,
                                      DecoderParams, EmtOperands, EmtParams,
                                      autoregressive,
                                      emt_context_width, init_decoder_state,
                                      kernel_prenet, ref_rows, round_bf16)
from ..models.tacotron.decoder import decode_block as decode_block_plain

# kernel launches made by `decode` and `decode_block` (the counts a run
# reads to show that its main path went through the CUDA kernels):
# csrc/decoder_rows.cu, and csrc/decoder.cu under emt_attn (the
# teacher-forced launches count in ops/tacotron_train_kernel.py)
rows_launches = 0
launches = 0

_SMEM_LIMIT = 232448
# CTAs per row: `CS` in csrc/decoder.cu (checked at launch)
CLUSTER_SIZE = 8
_argtypes_set = False
_rows_argtypes_set = False
# rows of a cluster of csrc/decoder_rows.cu (`RB`, checked at launch)
ROWS = 8
# the weight streams of csrc/decoder_rows.cu and decoder_bwd.cu (common.cuh):
# a product's m-tiles go in groups of STREAM_NW (the compute warps, one
# each), STREAM_KC k-tiles a warp in each 32 KB chunk
STREAM_NW, STREAM_KC = 16, 4


def decode_weight_dtype(cfg: Config) -> torch.dtype:
    return (torch.bfloat16 if cfg.tacotron.fused_decoder_dtype == "bfloat16"
            else torch.float32)


def extract_decoder_params(params, cfg: Config, *, device="cuda",
                           weight_dtype=None,
                           emt_only: bool = False) -> DecoderParams:
    """Flax Tacotron params (numpy leaves) -> DecoderParams.

    Layout of models/tacotron/decoder.py: cell/{prenet, lstm1, lstm2,
    attention, frame_projection, stop_projection}. LSTM kernels are
    [(x_dim + U), 4U] with x = [prenet | context] (under emt_attn [prenet |
    context | context_emt (E) | ref_spk (R)], whose emt rows
    `extract_emt_params` takes); the forget bias of 1.0 is folded into the
    f-gate bias. Matmul weights are cast to `weight_dtype` (default: the
    config's decode dtype). Any prenet: the fields hold the kernels' two
    layers of one width, and are None for any other prenet, which
    `extract_prenet` gives the plain decode.
    """
    tc = cfg.tacotron
    wd = weight_dtype or decode_weight_dtype(cfg)
    U, P = tc.decoder_lstm_units, tc.prenet_layers[-1]
    r, mels = tc.outputs_per_step, cfg.audio.num_mels
    cell = params["decoder"]["cell"]
    f32 = lambda a: np.asarray(a, np.float32)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                            dtype=dtype)

    l1k, l2k = f32(cell["lstm1"]["kernel"]), f32(cell["lstm2"]["kernel"])
    l1b, l2b = f32(cell["lstm1"]["bias"]).copy(), f32(cell["lstm2"]["bias"]).copy()
    l1b[2 * U:3 * U] += 1.0
    l2b[2 * U:3 * U] += 1.0
    E, R = emt_context_width(cfg), ref_rows(cfg, emt_only)
    M = l1k.shape[0] - P - U - E - R
    assert l2k.shape[0] == 2 * U, l2k.shape
    att = cell["attention"]
    fp, sp = cell["frame_projection"]["Dense_0"], cell["stop_projection"]["Dense_0"]
    proj_w = np.concatenate([f32(fp["kernel"]), f32(sp["kernel"])], axis=1)
    proj_b = np.concatenate([f32(fp["bias"]), f32(sp["bias"])])
    assert proj_w.shape == (U + M, r * mels + r), proj_w.shape
    pre = dict.fromkeys(("pre_w0", "pre_b0", "pre_w1", "pre_b1"))
    if kernel_prenet(cfg):
        (pre["pre_w0"], pre["pre_b0"]), (pre["pre_w1"], pre["pre_b1"]) = \
            extract_prenet(params, cfg, device=device, weight_dtype=wd)
    return DecoderParams(
        **pre,
        l1_wp=t(l1k[:P], wd), l1_wc=t(l1k[P:P + M], wd),
        l1_wh=t(l1k[P + M + E + R:], wd),
        l1_b=t(l1b), l2_wx=t(l2k[:U], wd), l2_wh=t(l2k[U:], wd), l2_b=t(l2b),
        wq=t(att["query_layer"]["kernel"], wd),
        loc_k=t(f32(att["location_features_convolution"]["kernel"])[:, 0]),
        loc_b=t(att["location_features_convolution"]["bias"]),
        wloc=t(att["location_features_layer"]["kernel"]),
        v_a=t(f32(att["attention_variable_projection"])[:, 0]),
        b_a=t(att["attention_bias"]),
        proj_wo=t(proj_w[:U], wd), proj_wc=t(proj_w[U:], wd), proj_b=t(proj_b))


def extract_prenet(params, cfg: Config, *, device="cuda",
                   weight_dtype=None) -> tuple:
    """The prenet's layers as (kernel [in, out] in `weight_dtype`, default
    the decode dtype; bias [out] f32) pairs, for a prenet of any shape
    (the plain decode's `prenet`)."""
    wd = weight_dtype or decode_weight_dtype(cfg)
    pre = params["decoder"]["cell"]["prenet"]
    t = lambda a, dtype=torch.float32: torch.from_numpy(
        np.array(a, np.float32)).to(device=device, dtype=dtype)
    return tuple((t(pre[f"Dense_{i}"]["kernel"], wd),
                  t(pre[f"Dense_{i}"]["bias"]))
                 for i in range(len(cfg.tacotron.prenet_layers)))


def extract_emt_params(params, cfg: Config, *, device="cuda",
                       weight_dtype=None, emt_only: bool = False
                       ) -> EmtParams | None:
    """The emt_attn attention's weights (JAX `extract_decoder_params`'s emt
    fields, :121-147, and style_tokens'): LSTM1's context_emt rows
    `l1_we` and ref_spk rows `l1_wr`, and cell/attention_emt (W1, W2, V for
    style_tokens) with cell/attn_emt_out (multihead). The weights that the
    step loop multiplies (W2 or q_proj, attn_emt_out) are cast to
    `weight_dtype`, the rest, which `emt_operands` folds once per call,
    stay f32; so does `l1_we`, whose step-loop copy `emt_operands` and
    `pack_weights` cast to the decode dtype (multihead's ref_spk addend
    reads it in f32, as the TPU block kernel does, :758). None without
    emt_attn."""
    gst = cfg.gst
    if not gst.emt_attn:
        return None
    wd = weight_dtype or decode_weight_dtype(cfg)
    U, P = cfg.tacotron.decoder_lstm_units, cfg.tacotron.prenet_layers[-1]
    cell = params["decoder"]["cell"]
    f32 = lambda a: np.asarray(a, np.float32)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                            dtype=dtype)

    l1k = f32(cell["lstm1"]["kernel"])
    E, R = emt_context_width(cfg), ref_rows(cfg, emt_only)
    M = l1k.shape[0] - P - U - E - R
    ae = cell["attention_emt"]
    ep = dict(l1_we=t(l1k[P + M:P + M + E]),
              l1_wr=t(l1k[P + M + E:P + M + E + R]) if R else None)
    if gst.emt_attn_type == "simple":
        ep.update(emt_w1=t(ae["W1"]["kernel"]), emt_b1=t(ae["W1"]["bias"]),
                  emt_w2=t(ae["W2"]["kernel"], wd),
                  emt_b2=t(ae["W2"]["bias"]),
                  emt_v=t(f32(ae["V"]["kernel"])[:, 0]))
    else:
        if gst.style_att_type != "mlp_attention":
            raise ValueError("the port's multi-head emt attention is the "
                             "mlp scorer (style_att_type=mlp_attention)")
        ep.update(mh_q_w=t(ae["q_proj"]["kernel"], wd),
                  mh_q_b=t(ae["q_proj"]["bias"]),
                  mh_k_w=t(ae["k_proj"]["kernel"]),
                  mh_k_b=t(ae["k_proj"]["bias"]),
                  mh_v=t(ae["attention_v"]), mh_g=t(ae["attention_g"]),
                  mh_b=t(ae["attention_b"]))
        if gst.emt_attn_type == "multihead":
            out = cell["attn_emt_out"]
            ep.update(mh_out_w=t(out["kernel"], wd),
                      mh_out_b=t(out["bias"]))
    return EmtParams(**ep)


class KernelWeights(NamedTuple):
    """The decode kernel's weight operands, laid out for a cluster of `cs`
    CTAs (built once by `pack_weights`). "wd": the decode weight dtype,
    bf16 or f32; the rest f32."""

    pre_w0: torch.Tensor   # [mels, P] wd
    pre_b0: torch.Tensor   # [P]
    pre_w1: torch.Tensor   # [P, P] wd
    pre_b1: torch.Tensor   # [P]
    l1_w: torch.Tensor     # [cs, P+M+U, 4U/cs] wd, see split_gates
    l1_b: torch.Tensor     # [cs, 4U/cs]
    l2_w: torch.Tensor     # [cs, 2U, 4U/cs] wd
    l2_b: torch.Tensor     # [cs, 4U/cs]
    wq: torch.Tensor       # [U, A] wd
    wp: torch.Tensor       # [K, A] folded location taps
    b_eff: torch.Tensor    # [A] folded attention bias, added to the keys
    v_a: torch.Tensor      # [A]
    proj_w: torch.Tensor   # [U+M, fop] wd, columns padded to fop
    proj_b: torch.Tensor   # [fop]
    fop: int
    cs: int
    # emt_attn (E > 0): the query weight of the emt attention [U, A2] wd
    # (W2 or q_proj) and multihead's attn_emt_out [H*V, E] wd, [E]
    w2e: torch.Tensor = None
    emt_out_w: torch.Tensor = None
    emt_out_b: torch.Tensor = None
    E: int = 0
    # every decode without emt_attn: csrc/decoder_rows.cu's operands
    # (`pack_rows`), or None under emt_attn
    rows: "RowsWeights" = None


class RowsWeights(NamedTuple):
    """csrc/decoder_rows.cu's weight operands for a cluster of `cs` CTAs
    (built once by `pack_rows`): the stream of mma tiles in the decode
    weight dtype (`rows_stream`) and the f32 biases."""

    stream: torch.Tensor   # bytes: [cs, own] then the shared prenet chunks
    pre_b0: torch.Tensor   # [P]
    pre_b1: torch.Tensor   # [P]
    l1_b: torch.Tensor     # [cs, 4U/cs] (forget bias folded)
    l2_b: torch.Tensor     # [cs, 4U/cs]
    proj_b: torch.Tensor   # [r*mels + r]
    cs: int


def decode_plain(dp: DecoderParams, cfg: Config, keys, memory, mask, drop, *,
                 steps: int, early_stop_block: int = 0,
                 emit_alignments: bool = True,
                 emt: EmtOperands | None = None, prenet=None):
    """The kernel's plain PyTorch version (same contract as `decode`), on
    any device; `prenet` (`extract_prenet`) for a prenet other than the
    kernels'."""
    return autoregressive(dp, cfg, keys, memory, mask, steps, drop,
                          early_stop_block, emit_alignments, emt, prenet)


def decode(dp: DecoderParams, cfg: Config, keys, memory, mask, drop, *,
           steps: int, early_stop_block: int = 0,
           emit_alignments: bool = True,
           kernel_weights: KernelWeights | None = None,
           emt: EmtOperands | None = None):
    """Decode `steps` steps. keys [B, T, A], memory [B, T, M], mask [B, T],
    drop [B, steps, 2, P], and under emt_attn `emt` (the call's
    `emt_operands`). Returns (frames [B, steps*r, mels], stop_probs
    [B, steps*r], alignments [B, T, steps] or None). With
    `early_stop_block=K` every row decodes until the first K-step boundary
    at which all rows have fired; later steps read frames 0, stop 1.0,
    alignments 0 (the TPU kernel's rule). CPU tensors take the plain
    version with `dp`; CUDA tensors launch the kernel with `kernel_weights`
    (`pack_weights(dp, emt=...)`) or raise."""
    if memory.device.type == "cpu":
        return decode_plain(dp, cfg, keys, memory, mask, drop, steps=steps,
                            early_stop_block=early_stop_block,
                            emit_alignments=emit_alignments, emt=emt)
    if kernel_weights is None:
        raise ValueError("the decode kernel takes kernel_weights="
                         "pack_weights(dp), built once per set of weights")
    return _decode_cuda(kernel_weights, cfg, keys, memory, mask, drop, steps,
                        early_stop_block, emit_alignments, emt)


def decode_block(dp: DecoderParams, cfg: Config, keys, memory, mask,
                 state: DecoderKernelState, drop, *,
                 kernel_weights: KernelWeights | None = None,
                 emt: EmtOperands | None = None,
                 casts: Casts | None = None):
    """K = drop.shape[1] steps from `state`, with `emt` under emt_attn;
    `casts`: what bf16 rounds (default: `build_decoder_block_kernel` at its
    default energy_mode, `BLOCK` / `BLOCK_EMT`; `WHOLE` the whole
    decode's). Returns (frames [B, K*r, mels], stop_probs [B,
    K*r], alignments [B, T, K], new state). CPU tensors take
    `decode_block_plain`; CUDA tensors launch the kernel with
    `kernel_weights` or raise."""
    casts = casts or (BLOCK if emt is None else BLOCK_EMT)
    if memory.device.type == "cpu":
        return decode_block_plain(dp, cfg, keys, memory, mask, state, drop,
                                  emt, casts=casts)
    if kernel_weights is None:
        raise ValueError("the decode kernel takes kernel_weights="
                         "pack_weights(dp), built once per set of weights")
    return _decode_block_cuda(kernel_weights, cfg, keys, memory, mask, state,
                              drop, emt, casts)


def _lib():
    from ..native import build
    global _argtypes_set
    lib = build.load("decoder")
    if not _argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.taco_decoder_launch.argtypes = [vp, ci, vp, ci, ctypes.c_float,
                                            vp]
        lib.taco_decoder_launch.restype = ci
        lib.taco_decoder_smem_bytes.argtypes = [ci] * 13
        lib.taco_decoder_smem_bytes.restype = ctypes.c_size_t
        for fn in ("cluster_size", "n_ptr", "n_int"):
            getattr(lib, f"taco_decoder_{fn}").argtypes = []
            getattr(lib, f"taco_decoder_{fn}").restype = ci
        lib.taco_decoder_state_floats.argtypes = [ci] * 5
        lib.taco_decoder_state_floats.restype = ci
        _argtypes_set = True
    return lib


def split_gates(w, cs: int):
    """LSTM kernel [K, 4U] (or bias [4U]) in (i, j, f, o) order ->
    [cs, K, 4U/cs] (or [cs, 4U/cs]): slice c holds the i, j, f, o columns
    of units [c·U/cs, (c+1)·U/cs), the gate columns one CTA of the
    kernel's cluster computes."""
    lead = w.shape[:-1]
    U = w.shape[-1] // 4
    w = w.reshape(*lead, 4, cs, U // cs)
    w = w.movedim(-2, 0)                  # [cs, *lead, 4, U/cs]
    return w.reshape(cs, *lead, 4 * (U // cs)).contiguous()


def stream_tiles(w, ks: int):
    """w [cs, rows, K] -> [cs, bytes]: mma A fragments of 16 × ks tiles,
    m-tiles in groups of STREAM_NW (one a warp), STREAM_KC k-tiles a warp in
    each chunk, in the order common.cuh's `product` takes them (group,
    chunk, warp, k-tile, lane, fragment); rows and k zero-padded."""
    cs, rows, K = w.shape
    nw, kc = STREAM_NW, STREAM_KC
    ng = -(-(-(-rows // 16)) // nw)
    kp = -(-K // (ks * kc)) * ks * kc
    wp = w.new_zeros(cs, ng * nw * 16, kp)
    wp[:, :rows, :K] = w
    nck = kp // (ks * kc)
    if ks == 16:   # bf16 m16n8k16: lane (g, t) holds rows g, g+8 by k pairs
        t = wp.reshape(cs, ng, nw, 2, 8, nck, kc, 2, 4, 2)
        t = t.permute(0, 1, 5, 2, 6, 4, 8, 7, 3, 9)
    else:          # tf32 m16n8k8: lane (g, t) holds rows g, g+8, k t, t+4
        t = wp.reshape(cs, ng, nw, 2, 8, nck, kc, 2, 4)
        t = t.permute(0, 1, 5, 2, 6, 4, 8, 7, 3)
    return t.contiguous().reshape(cs, -1).view(torch.uint8)


def rows_cluster_size(U: int, M: int) -> int:
    """csrc/decoder_rows.cu's cluster: 16 CTAs (each SM streams half the
    weight bytes of 8) where the units and the context columns split 16
    ways, else 8 (its `supported` decides at launch)."""
    return 16 if U % 16 == 0 and M % 16 == 0 else 8


def rows_stream(dp: DecoderParams, cs: int):
    """csrc/decoder_rows.cu's weight stream, bytes: for each CTA c its own
    tiles (A = the transposed weights, k over the inputs) of its gate
    columns of [l1_wp; l1_wc; l1_wh] and of [l2_wx; l2_wh] (`split_gates`
    for cs CTAs, laid out unit by unit: (i, j, f, o) of each unit), of the
    query weight's rows of its units and of the projection's rows of its
    units and context columns; then, once for every CTA, pre_w0 and pre_w1
    (the kernel's products, in the order it takes them), in the weight
    dtype."""
    U, M = dp.l1_wh.shape[0], dp.l1_wc.shape[0]
    Uc, Mc = U // cs, M // cs
    ks = 16 if dp.l1_wp.dtype == torch.bfloat16 else 8

    def gates(w):
        g = split_gates(w, cs)                      # [cs, K, (gate, unit)]
        K = g.shape[1]
        g = g.reshape(cs, K, 4, Uc).transpose(2, 3).reshape(cs, K, 4 * Uc)
        return g.transpose(1, 2)
    proj = torch.cat([dp.proj_wo, dp.proj_wc], 0)
    proj = torch.cat([proj[:U].reshape(cs, Uc, -1),
                      proj[U:].reshape(cs, Mc, -1)], 1)
    own = [gates(torch.cat([dp.l1_wp, dp.l1_wc, dp.l1_wh], 0)),
           gates(torch.cat([dp.l2_wx, dp.l2_wh], 0)),
           dp.wq.reshape(cs, Uc, -1).transpose(1, 2), proj.transpose(1, 2)]
    shared = [stream_tiles(w.t()[None], ks)[0] for w in (dp.pre_w0,
                                                          dp.pre_w1)]
    return torch.cat([torch.cat([stream_tiles(w, ks) for w in own],
                                1).reshape(-1), *shared])


def pack_rows(dp: DecoderParams) -> RowsWeights:
    """DecoderParams -> csrc/decoder_rows.cu's operands at its cluster
    size for these widths."""
    cs = rows_cluster_size(dp.l1_wh.shape[0], dp.l1_wc.shape[0])
    c = lambda x: x.float().contiguous()
    return RowsWeights(rows_stream(dp, cs), c(dp.pre_b0), c(dp.pre_b1),
                       split_gates(dp.l1_b.float(), cs),
                       split_gates(dp.l2_b.float(), cs), c(dp.proj_b), cs)


def pack_weights(dp: DecoderParams, cs: int = CLUSTER_SIZE, *,
                 emt: EmtParams | None = None) -> KernelWeights:
    """DecoderParams (and under emt_attn its EmtParams) -> the kernels'
    operands: stacked LSTM kernels split into per-CTA gate columns (LSTM1's
    rows [prenet | context | context_emt | hidden]), the projection padded
    to a multiple of 8 columns, the folded location taps and attention
    bias, and the emt attention's query weight and output Dense; without
    emt_attn also csrc/decoder_rows.cu's stream (`pack_rows`), which the
    autoregressive and the teacher-forced decode read. The kernels' prenet
    is two layers of one width (`kernel_prenet`); for any other
    (`dp.pre_w0` None) ValueError."""
    if dp.pre_w0 is None or dp.pre_w1.shape != (dp.pre_w0.shape[1],) * 2:
        raise ValueError("the decode kernels take a prenet of two layers of "
                         "one width (tacotron.prenet_layers (P, P)); any "
                         "other decodes through the plain version")
    fo = dp.proj_b.shape[0]
    fop = -(-fo // 8) * 8
    proj_w = torch.cat([dp.proj_wo, dp.proj_wc], 0)
    wp, b_eff = fold_location(dp.loc_k, dp.loc_b, dp.wloc, dp.b_a)
    c = lambda x: x.contiguous()
    l1 = [dp.l1_wp, dp.l1_wc, dp.l1_wh]
    emt_kw = {}
    if emt is not None:
        U = dp.l1_wh.shape[0]
        l1.insert(2, emt.l1_we.to(dp.l1_wp.dtype))
        w2e = emt.emt_w2 if emt.emt_w1 is not None else emt.mh_q_w[:U]
        emt_kw = dict(
            w2e=c(w2e), E=emt.l1_we.shape[0],
            emt_out_w=None if emt.mh_out_w is None else c(emt.mh_out_w),
            emt_out_b=None if emt.mh_out_b is None else c(emt.mh_out_b))
    return KernelWeights(
        pre_w0=c(dp.pre_w0), pre_b0=c(dp.pre_b0), pre_w1=c(dp.pre_w1),
        pre_b1=c(dp.pre_b1),
        l1_w=split_gates(torch.cat(l1, 0), cs),
        l1_b=split_gates(dp.l1_b, cs),
        l2_w=split_gates(torch.cat([dp.l2_wx, dp.l2_wh], 0), cs),
        l2_b=split_gates(dp.l2_b, cs),
        wq=c(dp.wq), wp=c(wp), b_eff=c(b_eff), v_a=c(dp.v_a),
        proj_w=c(torch.nn.functional.pad(proj_w, (0, fop - fo))),
        proj_b=c(torch.nn.functional.pad(dp.proj_b, (0, fop - fo))),
        fop=fop, cs=cs, **emt_kw,
        rows=pack_rows(dp) if emt is None else None)


class Launch(NamedTuple):
    """What every launch of one decode shares: operands checked and laid
    out once (by `prepare_launch`), each rounded to bf16 where the route
    rounds it with bf16 weights."""

    lib: ctypes.CDLL
    kw: KernelWeights
    keys: torch.Tensor    # keys + folded attention bias, contiguous f32
    memory: torch.Tensor
    mask: torch.Tensor    # f32 1/0
    wp: torch.Tensor      # folded location taps
    v_a: torch.Tensor
    ints: dict
    # emt_attn: keys [B, Te, A2], score rows [nh, A2], emt memory [B, Te,
    # V] (f32), LSTM1's per-row bias [B, cs, 4U/cs] (l1_b, plus ref_spk's
    # addend where it is fed); all None without emt_attn
    emt: tuple


def _emt_launch_operands(kw: KernelWeights, emt, B, U, dev, rnd):
    """Check a call's EmtOperands against the kernel weights; -> (the
    Launch's emt tensors, keys and memory through `rnd`, their ints)."""
    if (emt is None) != (kw.E == 0):
        raise ValueError("emt_attn decodes need kernel weights packed with "
                         "the emt weights and the call's emt operands; "
                         "other decodes neither")
    if emt is None:
        return (None, None, None, None), dict(E=0, Te=0, A2=0, EV=0, NH=0)
    Te, A2 = emt.ekeys.shape[1:]
    nh, V = emt.score.shape[0], emt.emem.shape[2]
    if kw.emt_out_w is None and nh != 1:
        raise ValueError("the decode kernel runs the simple and multihead "
                         "emt scorers; style_tokens decodes through the "
                         "plain version")
    want_e = kw.emt_out_w.shape[1] if kw.emt_out_w is not None else V
    for name, x, shape in (("ekeys", emt.ekeys, (B, Te, A2)),
                           ("score", emt.score, (nh, A2)),
                           ("emem", emt.emem, (B, Te, V))):
        if tuple(x.shape) != shape or x.dtype != torch.float32 \
                or x.device != dev:
            raise ValueError(f"emt.{name} must be f32 {shape} on {dev}")
    if kw.w2e.shape != (U, A2) or kw.E != want_e or (
            kw.emt_out_w is not None and kw.emt_out_w.shape[0] != nh * V):
        raise ValueError("emt operands do not match the kernel weights")
    if A2 % 8 or kw.E % 8 or nh > 8 or Te < 1:
        raise ValueError("emt widths outside the kernel's envelope")
    brow = kw.l1_b[None].expand(B, -1, -1)
    if emt.rs_add is not None:
        if emt.rs_add.shape != (B, 4 * U):
            raise ValueError("emt.rs_add must be [B, 4U]")
        brow = brow + split_gates(emt.rs_add.float(), kw.cs).transpose(0, 1)
    return ((rnd(emt.ekeys).contiguous(), emt.score.contiguous(),
             rnd(emt.emem).contiguous(), brow.contiguous()),
            dict(E=kw.E, Te=Te, A2=A2, EV=V, NH=nh))


def weight_type(kw: KernelWeights, dev) -> torch.dtype:
    """The one dtype of the kernel's matmul weights (bf16 or f32) on
    `dev`, or ValueError: before any library is loaded."""
    names = ["pre_w0", "pre_w1", "l1_w", "l2_w", "wq", "proj_w"]
    names += [n for n in ("w2e", "emt_out_w") if getattr(kw, n) is not None]
    types = {getattr(kw, n).dtype for n in names}
    wd = kw.l1_w.dtype
    if len(types) != 1 or wd not in (torch.bfloat16, torch.float32):
        raise ValueError("the decode kernels take every matmul weight in one "
                         "type, bf16 or f32, got " + ", ".join(
                             f"{n} {getattr(kw, n).dtype}" for n in names))
    for n in names:
        if getattr(kw, n).device != dev:
            raise ValueError(f"kernel weight {n} is on "
                             f"{getattr(kw, n).device}, not {dev}")
    return wd


def _launch_operands(kw: KernelWeights, cfg: Config, keys, memory, mask, *,
                     teacher_forced: bool, emt: EmtOperands | None,
                     casts: Casts):
    """What every launch of a decode kernel shares, checked and laid out
    before any library is loaded: (bf16 weights?, keys + folded bias,
    memory, mask, taps, v_a, each rounded where the route rounds it with
    bf16 weights; the launch's ints; the emt operands)."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    B, T, M = memory.shape
    U, P = tc.decoder_lstm_units, tc.prenet_layers[-1]
    A, KW = kw.wq.shape[1], kw.wp.shape[0]
    dev = memory.device
    bf16 = weight_type(kw, dev) == torch.bfloat16
    if memory.dtype != torch.float32 or keys.shape != (B, T, A):
        raise ValueError("memory must be f32 [B, T, M] and keys [B, T, A]")
    if teacher_forced and (emt is not None or kw.E):
        raise ValueError("the teacher-forced decode does not run emt_attn")
    if teacher_forced and tc.smoothing:
        raise ValueError("the teacher-forced decode takes softmax attention "
                         "only, not smoothing")
    if kw.l1_w.shape[1] != P + M + kw.E + U:
        raise ValueError("kernel_weights do not match the memory width")
    rnd = round_bf16 if bf16 else identity
    casts = TEACHER_FORCED if teacher_forced else casts
    rc = lambda on, x: rnd(x) if on else x
    emt_ops, emt_ints = _emt_launch_operands(kw, emt, B, U, dev, rnd)
    win = int(tc.attention_win_size)
    monotonic = tc.synthesis_constraint_type == "monotonic"
    ints = dict(B=B, T=T, mels=mels, P=P, U=U, M=M, A=A, KW=KW,
                r=tc.outputs_per_step, FOp=kw.fop,
                constraint=int(bool(tc.synthesis_constraint)
                               and not teacher_forced),
                win_back=0 if monotonic else win // 2 + win % 2,
                win_fwd=win if monotonic else win // 2,
                stop_at_any=int(bool(tc.stop_at_any)),
                teacher_forced=int(teacher_forced),
                f32_weights=int(not bf16), smoothing=int(bool(tc.smoothing)),
                tanh_bf16=int(bf16 and casts.tanh), **emt_ints)
    return (bf16, rc(casts.keys, keys.float() + kw.b_eff).contiguous(),
            rnd(memory).contiguous(),
            mask.to(device=dev, dtype=torch.float32).contiguous(),
            rnd(kw.wp).contiguous(), rc(casts.v_a, kw.v_a).contiguous(),
            ints, emt_ops)


def prepare_launch(kw: KernelWeights, cfg: Config, keys, memory, mask, *,
                   emt: EmtOperands | None = None,
                   casts: Casts = WHOLE) -> Launch:
    """Check an emt_attn decode's operands against csrc/decoder.cu's
    envelope and lay them out (`casts`: the route's roundings)."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    B, T, M = memory.shape
    U, P = tc.decoder_lstm_units, tc.prenet_layers[-1]
    A, KW = kw.wq.shape[1], kw.wp.shape[0]
    bf16, keys, memory, mask, wp, v_a, ints, emt_ops = _launch_operands(
        kw, cfg, keys, memory, mask, teacher_forced=False, emt=emt,
        casts=casts)
    lib = _lib()
    cs = lib.taco_decoder_cluster_size()
    if kw.cs != cs:
        raise ValueError(f"kernel_weights are laid out for {kw.cs} CTAs, "
                         f"the kernel runs {cs}")
    lanes = 8 if bf16 else 4                 # weights a 16-byte load holds
    if U % (2 * cs) or M % cs or (4 * U // cs) // lanes > 512 or A % 8 \
            or P % 8:
        raise ValueError("widths outside the kernel's envelope")
    smem = lib.taco_decoder_smem_bytes(
        T, mels, P, U, M, A, KW, kw.fop, *(ints[k] for k in _EMT_INTS))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"decode kernel needs {smem} B of shared memory "
                         f"at T_in={T}")
    return Launch(lib, kw, keys, memory, mask, wp, v_a, ints, emt_ops)


_EMT_INTS = ("E", "Te", "A2", "EV", "NH")
_INT_ORDER = ("B", "T", "t0", "nsteps", "s_total", "mels", "P", "U", "M", "A",
              "KW", "r", "FOp", "constraint", "win_back", "win_fwd",
              "stop_at_any", *_EMT_INTS, "f32_weights", "smoothing",
              "tanh_bf16")


def pack_state(state: DecoderKernelState, P: int,
               cs: int = CLUSTER_SIZE):
    """DecoderKernelState -> the kernel's (vector [B, n], cum [B, T], pmax
    [B]): each row's vector is [xprev | 0 (P) | 0 (P) | ctx | ctx_emt (E,
    under emt_attn) | h1 | h2 | ctx | c1, c2 units of CTA 0 | ... | of CTA
    cs-1], the head of the kernel's shared memory, so that one loop copies
    it in or out."""
    B, U = state.c1.shape
    c = torch.stack([state.c1.reshape(B, cs, U // cs),
                     state.c2.reshape(B, cs, U // cs)], 2).reshape(B, 2 * U)
    emt = [] if state.ctx_emt is None else [state.ctx_emt.float()]
    vec = torch.cat([state.xprev, state.xprev.new_zeros(B, 2 * P), state.ctx,
                     *emt, state.h1, state.h2, state.ctx, c], 1)
    return (vec.float().contiguous(), state.cum.float().contiguous(),
            state.pmax.to(torch.int32).contiguous())


def unpack_state(vec, cum, pmax, mels: int, P: int, M: int,
                 cs: int = CLUSTER_SIZE, E: int = 0) -> DecoderKernelState:
    """The inverse of `pack_state` (E: the width of ctx_emt, 0 without
    emt_attn)."""
    B = vec.shape[0]
    o = mels + 2 * P
    U = (vec.shape[1] - o - 2 * M - E) // 4
    h = o + M + E                       # h1 | h2 | ctx | c
    c = vec[:, h + 2 * U + M:].reshape(B, cs, 2, U // cs)
    return DecoderKernelState(
        xprev=vec[:, :mels].contiguous(), c1=c[:, :, 0].reshape(B, U),
        h1=vec[:, h:h + U].contiguous(),
        c2=c[:, :, 1].reshape(B, U),
        h2=vec[:, h + U:h + 2 * U].contiguous(),
        ctx=vec[:, o:o + M].contiguous(), cum=cum, pmax=pmax,
        ctx_emt=vec[:, o + M:h].contiguous() if E else None)


def launch(L: Launch, cfg: Config, drop, state_in, state_out, out, align,
           fired_in, fired_out, *, t0: int, nsteps: int, s_total: int):
    """One launch of csrc/decoder.cu: steps t0 .. t0+nsteps-1 of arrays
    laid out for s_total steps; state_in / state_out are `pack_state`
    triples.
    Operands made by the caller are freed after it returns, maybe before
    the kernel ends; PyTorch's caching allocator reuses a freed block only
    for work queued later on the same stream, so they outlive the kernel.
    The caller counts the launch."""
    kw = L.kw
    nul = ctypes.c_void_p(None)
    p = lambda x: nul if x is None else ctypes.c_void_p(x.data_ptr())
    ptrs = [L.keys, L.memory, L.mask, drop, kw.pre_w0, kw.pre_b0, kw.pre_w1,
            kw.pre_b1, kw.l1_w, kw.l2_w, kw.l2_b, kw.wq, L.wp, L.v_a,
            kw.proj_w, kw.proj_b, *state_in, *state_out, fired_in,
            fired_out, out, align, *L.emt, kw.w2e, kw.emt_out_w,
            kw.emt_out_b]
    ints = dict(L.ints, t0=t0, nsteps=nsteps, s_total=s_total)
    lib = L.lib
    n = lib.taco_decoder_state_floats(ints["mels"], ints["P"], ints["U"],
                                      ints["M"], ints["E"])
    assert state_in[0].shape[1] == state_out[0].shape[1] == n
    assert len(ptrs) == lib.taco_decoder_n_ptr()
    assert len(_INT_ORDER) == lib.taco_decoder_n_int()
    dev = L.memory.device
    rc = lib.taco_decoder_launch(
        (ctypes.c_void_p * len(ptrs))(*[p(x) for x in ptrs]), len(ptrs),
        (ctypes.c_int * len(_INT_ORDER))(*[ints[k] for k in _INT_ORDER]),
        len(_INT_ORDER), float(cfg.tacotron.zoneout_rate),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    from ..native.build import check
    check(rc, "taco_decoder_launch")


# ------------------------------------------------ csrc/decoder_rows.cu


class RowsLaunch(NamedTuple):
    """What every launch of one decode through csrc/decoder_rows.cu shares
    (`prepare_rows`)."""

    lib: ctypes.CDLL
    rw: RowsWeights
    keys: torch.Tensor    # keys + folded attention bias, f32
    memory: torch.Tensor  # in the weight dtype
    mask: torch.Tensor    # f32 1/0
    wp: torch.Tensor      # folded location taps
    v_a: torch.Tensor
    ints: dict
    scratch: int          # bytes of global scratch a cluster


_ROWS_INTS = ("B", "T", "t0", "nsteps", "s_total", "mels", "P", "U", "M",
              "A", "KW", "r", "constraint", "win_back", "win_fwd",
              "stop_at_any", "f32_weights", "smoothing", "tanh_bf16", "cs",
              "teacher_forced")
# the train mode's residuals, in csrc/decoder_rows.cu's `Res` order
RES_NAMES = ("cum_pre", "q", "z1", "z2", "h0d", "hpre", "ctx", "h1", "c1",
             "h2", "c2")


def _rows_lib():
    from ..native import build
    global _rows_argtypes_set
    lib = build.load("decoder_rows")
    if not _rows_argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.taco_rows_launch.argtypes = [vp, ci, vp, ci, ctypes.c_float, vp]
        lib.taco_rows_launch.restype = ci
        lib.taco_rows_supported.argtypes = [ci] * 9
        lib.taco_rows_supported.restype = ci
        lib.taco_rows_plan.argtypes = [ci] * 10 + [vp]
        lib.taco_rows_plan.restype = ci
        for fn in ("rows", "n_ptr", "n_int"):
            getattr(lib, f"taco_rows_{fn}").argtypes = []
            getattr(lib, f"taco_rows_{fn}").restype = ci
        _rows_argtypes_set = True
    return lib


def rows_widths(cfg: Config, memory_width: int, T: int):
    """(T, mels, P, U, M, A, KW, r): csrc/decoder_rows.cu's widths."""
    tc = cfg.tacotron
    return (T, cfg.audio.num_mels, tc.prenet_layers[-1],
            tc.decoder_lstm_units, memory_width, tc.attention_dim,
            tc.attention_kernel, tc.outputs_per_step)


def rows_plan(widths, cs: int, f32: bool) -> dict:
    """The launch's plan (csrc/decoder_rows.cu `layout`), in bytes: shared
    memory, a CTA's own weight stream and the shared one (the prenet's),
    the global scratch of a cluster and what a CTA spills to it; and the
    buffers that sit in shared memory."""
    out = (ctypes.c_longlong * 6)()
    if _rows_lib().taco_rows_plan(*widths, cs, int(f32),
                                  ctypes.cast(out, ctypes.c_void_p)):
        raise ValueError(f"widths {widths} outside the decode kernel's "
                         f"envelope at cluster size {cs}")
    keys = ("smem", "stream", "shared", "scratch", "spill", "in_smem")
    return dict(zip(keys, (int(v) for v in out)))


def prepare_rows(kw: KernelWeights, cfg: Config, keys, memory, mask,
                 casts: Casts, *, teacher_forced: bool = False
                 ) -> RowsLaunch:
    """Check a decode's operands against csrc/decoder_rows.cu's envelope
    (`taco_rows_supported`) and lay them out once for its launches; the
    teacher-forced mode runs without the window constraint, emt_attn or
    smoothing and rounds as `build_train_fwd` does (`TEACHER_FORCED`, not
    `casts`)."""
    if kw.rows is None:
        raise ValueError("kernel_weights lack the decode's weight stream: "
                         "pack_weights(dp) packs it (no emt_attn)")
    bf16, keys, memory, mask, wp, v_a, ints, _ = _launch_operands(
        kw, cfg, keys, memory, mask, teacher_forced=teacher_forced,
        emt=None, casts=casts)
    rw = kw.rows
    wd = torch.bfloat16 if bf16 else torch.float32
    if rw.stream.device != memory.device:
        raise ValueError(f"the decode's weight stream is on "
                         f"{rw.stream.device}, not {memory.device}")
    widths = (ints["T"], ints["mels"], ints["P"], ints["U"], ints["M"],
              ints["A"], ints["KW"], ints["r"])
    plan = rows_plan(widths, rw.cs, not bf16)
    if rw.stream.numel() != rw.cs * plan["stream"] + plan["shared"]:
        raise ValueError("the decode's weight stream does not match these "
                         "widths")
    lib = _rows_lib()
    if lib.taco_rows_rows() != ROWS:
        raise ValueError("the decode kernel runs another number of rows a "
                         "cluster")
    return RowsLaunch(lib, rw, keys, memory.to(wd).contiguous(), mask, wp,
                      v_a, dict(ints, cs=rw.cs), plan["scratch"])


def pack_rows_state(state: DecoderKernelState):
    """DecoderKernelState -> csrc/decoder_rows.cu's (vector [B, mels + M +
    4U] = [xprev | ctx | h1 | h2 | c1 | c2], cum [B, T], pmax [B])."""
    vec = torch.cat([state.xprev, state.ctx, state.h1, state.h2, state.c1,
                     state.c2], 1)
    return (vec.float().contiguous(), state.cum.float().contiguous(),
            state.pmax.to(torch.int32).contiguous())


def unpack_rows_state(vec, cum, pmax, mels: int, M: int
                      ) -> DecoderKernelState:
    """The inverse of `pack_rows_state`."""
    U = (vec.shape[1] - mels - M) // 4
    part = lambda i: vec[:, mels + M + i * U:mels + M + (i + 1) * U]
    return DecoderKernelState(
        xprev=vec[:, :mels].contiguous(), c1=part(2).contiguous(),
        h1=part(0).contiguous(), c2=part(3).contiguous(),
        h2=part(1).contiguous(), ctx=vec[:, mels:mels + M].contiguous(),
        cum=cum, pmax=pmax)


def rows_launch(L: RowsLaunch, cfg: Config, drop, state_in, state_out, out,
                align, fired_in, fired_out, *, t0: int, nsteps: int,
                s_total: int, teacher=None, coins=None, zmask=None,
                res=None):
    """One launch of csrc/decoder_rows.cu: steps t0 .. t0+nsteps-1 of
    arrays laid out for s_total steps; state_in / state_out are
    `pack_rows_state` triples; in the teacher-forced mode (`prepare_rows(
    teacher_forced=True)`) teacher [s_total, B, mels] f32 and coins
    [s_total] int32, and in its train mode zmask [B, s_total, 4, U] uint8
    and the residual buffers `res` (f32 [B, s_total, ·] in `RES_NAMES`
    order). Its scratch, like every operand made here, outlives the kernel
    (see `launch`). The caller counts the launch."""
    rw, dev = L.rw, L.memory.device
    B = L.ints["B"]
    scratch = torch.empty(-(-B // ROWS) * L.scratch, dtype=torch.uint8,
                          device=dev)
    nul = ctypes.c_void_p(None)
    p = lambda x: nul if x is None else ctypes.c_void_p(x.data_ptr())
    ptrs = [rw.stream, L.keys, L.memory, L.mask, drop, rw.pre_b0, rw.pre_b1,
            rw.l1_b, rw.l2_b, L.wp, L.v_a, rw.proj_b, *state_in,
            *state_out, fired_in, fired_out, out, align, teacher, coins,
            zmask, *(res or [None] * len(RES_NAMES)), scratch]
    ints = dict(L.ints, t0=t0, nsteps=nsteps, s_total=s_total)
    lib = L.lib
    assert len(ptrs) == lib.taco_rows_n_ptr()
    assert len(_ROWS_INTS) == lib.taco_rows_n_int()
    rc = lib.taco_rows_launch(
        (ctypes.c_void_p * len(ptrs))(*[p(x) for x in ptrs]), len(ptrs),
        (ctypes.c_int * len(_ROWS_INTS))(*[ints[k] for k in _ROWS_INTS]),
        len(_ROWS_INTS), float(cfg.tacotron.zoneout_rate),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    from ..native.build import check
    check(rc, "taco_rows_launch")


def _check_state(state: DecoderKernelState, B, T, M, U, mels, E, dev):
    want = dict(xprev=(B, mels), c1=(B, U), h1=(B, U), c2=(B, U), h2=(B, U),
                ctx=(B, M), cum=(B, T), pmax=(B,))
    if (state.ctx_emt is None) != (E == 0):
        raise ValueError("state.ctx_emt must be given exactly under "
                         "emt_attn")
    if E:
        want["ctx_emt"] = (B, E)
    for name, shape in want.items():
        x = getattr(state, name)
        dtype = torch.int32 if name == "pmax" else torch.float32
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != dev:
            raise ValueError(f"state.{name} must be {dtype} {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _decode_cuda(kw: KernelWeights, cfg, keys, memory, mask, drop, steps,
                 early_stop_block, emit_alignments, emt):
    global launches, rows_launches
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r = tc.outputs_per_step
    B, T, M = memory.shape
    P = tc.prenet_layers[-1]
    dev = memory.device
    if drop.shape != (B, steps, 2, P) or drop.device != dev:
        raise ValueError(f"drop must be [B, steps, 2, P] on {dev}")
    rows = emt is None and kw.E == 0
    L = (prepare_rows(kw, cfg, keys, memory, mask, WHOLE) if rows
         else prepare_launch(kw, cfg, keys, memory, mask, emt=emt))
    drop = drop.to(torch.float32).contiguous()
    K = int(early_stop_block)
    if K <= 0 or K >= steps:
        K = steps
    FO = r * mels + r
    # what a skipped step reads as: frames 0, stop 1.0, alignments 0
    out = torch.zeros(B, steps, FO, device=dev)
    out[..., r * mels:] = 1.0
    align = (torch.zeros(B, steps, T, device=dev) if emit_alignments
             else None)
    state = init_decoder_state(cfg, B, T, M, dev)
    state = pack_rows_state(state) if rows else pack_state(state, P, kw.cs)
    # row i: the sticky stop flags after launch i and their count at [B]
    starts = range(0, steps, K)
    fired = torch.zeros(len(starts) + 1, B + 1, dtype=torch.int32,
                        device=dev)
    for i, t0 in enumerate(starts):
        args = (cfg, drop, state, state, out, align, fired[i], fired[i + 1])
        step = dict(t0=t0, nsteps=min(K, steps - t0), s_total=steps)
        if rows:
            rows_launch(L, *args, **step)
            rows_launches += 1
        else:
            launch(L, *args, **step)
            launches += 1
    frames = out[..., :r * mels].reshape(B, steps * r, mels)
    stops = out[..., r * mels:].reshape(B, steps * r)
    return frames, stops, (align.transpose(1, 2) if emit_alignments
                           else None)


def _decode_block_cuda(kw: KernelWeights, cfg, keys, memory, mask, state,
                       drop, emt, casts: Casts):
    global launches, rows_launches
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r = tc.outputs_per_step
    B, T, M = memory.shape
    P = tc.prenet_layers[-1]
    dev = memory.device
    K = drop.shape[1]
    if drop.shape != (B, K, 2, P) or drop.device != dev or K < 1:
        raise ValueError(f"drop must be [B, K, 2, P] on {dev}")
    _check_state(state, B, T, M, tc.decoder_lstm_units, mels, kw.E, dev)
    rows = emt is None and kw.E == 0
    FO = r * mels + r
    out = torch.empty(B, K, FO, device=dev)
    align = torch.empty(B, K, T, device=dev)
    drop = drop.to(torch.float32).contiguous()
    if rows:
        L = prepare_rows(kw, cfg, keys, memory, mask, casts)
        state_in = pack_rows_state(state)
        state_out = tuple(torch.empty_like(x) for x in state_in)
        rows_launch(L, cfg, drop, state_in, state_out, out, align, None,
                    None, t0=0, nsteps=K, s_total=K)
        rows_launches += 1
        state_out = unpack_rows_state(*state_out, mels, M)
    else:
        L = prepare_launch(kw, cfg, keys, memory, mask, emt=emt, casts=casts)
        state_in = pack_state(state, P, kw.cs)
        state_out = tuple(torch.empty_like(x) for x in state_in)
        launch(L, cfg, drop, state_in, state_out, out, align, None, None,
               t0=0, nsteps=K, s_total=K)
        launches += 1
        state_out = unpack_state(*state_out, mels, P, M, kw.cs, kw.E)
    return (out[..., :r * mels].reshape(B, K * r, mels),
            out[..., r * mels:].reshape(B, K * r), align.transpose(1, 2),
            state_out)
