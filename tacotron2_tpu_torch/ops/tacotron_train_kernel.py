"""The teacher-forced Tacotron decode as CUDA kernels: the eval forward,
the train forward and its BPTT backward.

Port of tacotron2_tpu/ops/tacotron_train_kernel.py:

- `teacher_forced_fwd` is `build_train_fwd` (:118, pallas_call at :325)
  with `train_zoneout=False`, as `_fused_teacher_forced_fn`
  (models/tacotron/decoder.py:183-221) runs it for GTA synthesis and
  `embed`: frames, stop logits and alignments, zoneout the EMA mix;
- `teacher_forced_train_fwd` is `build_train_fwd` in train mode:
  Bernoulli zoneout from masks the caller draws, and the per-step
  residuals the backward reads;
- `teacher_forced_bwd` is `build_train_bwd` (:371, pallas_call at :622):
  the reverse-time chain, emitting per-step activation gradients;
- `weight_grads` (:667) turns them into the parameter, key and memory
  gradients with library products, as JAX leaves them to XLA;
- `FusedTeacherForced` is `make_fused_teacher_forced` (:768): the
  autograd glue, and `extract_params_traced` (:844) the differentiable
  extraction of the decoder's parameters.

The two forwards launch the teacher-forced mode of `csrc/decoder_rows.cu`
(`decoder_rows_kernel<W, CSX, FIX, true>`, eval or train mode: one
cluster for 8 rows, each weight tile read once a step for all of them on
the tensor cores; its note has the design), through
`ops/tacotron_decoder_kernel.py`'s `prepare_rows` / `rows_launch`, and
the backward `csrc/decoder_bwd.cu`, for CUDA tensors, and raise if they
cannot (a ValueError naming the widths outside the kernel's envelope);
nothing falls back to another kernel or to the plain versions. CPU
tensors take the plain versions in models/tacotron/decoder.py
(`teacher_forced`, `teacher_forced_train`, `teacher_forced_bwd_plain`).
Each counts its launches.

The weights are `ops/tacotron_decoder_kernel.py`'s: matmul weights in
`tacotron.fused_train_dtype`, bf16 (the default) or f32, one type for all
(kernels and plain versions alike), laid out by `pack_weights` once per
set of weights (the forward's stream of mma tiles, `rows`; the backward
repacks the rest on every call, `bwd_stream`). With bf16 weights every
activation is rounded to bf16 where it enters a product (the memory and
the location taps too, not the keys or v_a) and sums are f32, as in
`build_train_fwd`; with f32 weights nothing is rounded. Prenet dropout
(`drop_masks`) and zoneout (`zoneout_masks`) come from the caller: the
TPU kernels draw them from the TPU PRNG per (seed, step) and draw them
again in the backward; the port draws them once, from a torch.Generator,
and forward and backward read the same tensors. The residuals are f32
(JAX keeps them in the weights' dtype); with bf16 weights the backward
reads the gates and cells rounded as JAX stores them, and rounds every
gradient to bf16 where it enters a product, as `build_train_bwd` does
(see `teacher_forced_bwd_plain`): its products are bf16 × bf16 with f32
sums.

On a CUDA device the kernels run whatever `use_fused_train_decoder` says:
that flag chooses between two TPU implementations of one function (the
Pallas kernels or the flax scan), as `use_fused_decoder` does for the
autoregressive decode, which the port ignores alike. What the JAX dispatch
sends to the scan instead (`decoder.py:311-316`) these kernels refuse
(`check_config`): `emt_attn`, a prenet other than two layers of one width
and smoothing attention, which the model and the synthesizer send to the
plain teacher-forced decode as JAX sends them to the scan
(`models/tacotron/decoder.py:teacher_forced_route`), so only a caller
that asks for the kernel by name meets the refusal.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..config import Config
from ..models.tacotron.attention import identity
from ..models.tacotron.decoder import (TEACHER_FORCED, DecoderParams,
                                      EmtParams, emt_context_width,
                                      init_decoder_state, kernel_prenet,
                                      round_bf16,
                                      teacher_forced,
                                      teacher_forced_bwd_plain,
                                      teacher_forced_train)
from . import tacotron_decoder_kernel as dk

# kernel launches (the counts a run reads to show that its main path went
# through the CUDA kernels): the eval forward (`teacher_forced_fwd`), the
# train forward (`teacher_forced_train_fwd`) and the backward
# (`teacher_forced_bwd`)
launches = 0
train_launches = 0
bwd_launches = 0
_bwd_argtypes_set = False
# the residuals the train forward writes, in csrc/decoder_rows.cu's order
RES_NAMES = dk.RES_NAMES


def train_weight_dtype(cfg: Config) -> torch.dtype:
    return (torch.bfloat16 if cfg.tacotron.fused_train_dtype == "bfloat16"
            else torch.float32)


def check_config(cfg: Config) -> None:
    """Raise on what the teacher-forced decode does not take."""
    tc = cfg.tacotron
    if cfg.gst.emt_attn:
        raise ValueError("the teacher-forced decode has no emt_attn scorers")
    if tc.smoothing:
        raise ValueError("the teacher-forced decode takes softmax attention "
                         "only, not smoothing")
    if not kernel_prenet(cfg):
        raise ValueError("the teacher-forced decode takes two prenet layers "
                         f"of equal width, not {tuple(tc.prenet_layers)}")


def extract_params(params, cfg: Config, *, device="cuda") -> DecoderParams:
    """Flax Tacotron params -> DecoderParams in the train weight dtype."""
    check_config(cfg)
    return dk.extract_decoder_params(params, cfg, device=device,
                                     weight_dtype=train_weight_dtype(cfg))


def teacher_forced_fwd_plain(dp: DecoderParams, cfg: Config, keys, memory,
                             mask, teacher, coins, drop):
    """The kernel's plain PyTorch version (same contract as
    `teacher_forced_fwd`)."""
    check_config(cfg)
    return teacher_forced(dp, cfg, keys, memory, mask, teacher, coins, drop)


def teacher_forced_fwd(dp: DecoderParams, cfg: Config, keys, memory, mask,
                       teacher, coins, drop, *,
                       kernel_weights: dk.KernelWeights | None = None):
    """Teacher-forced decode of steps = teacher.shape[0] steps. keys [B, T,
    A], memory [B, T, M], mask [B, T], teacher [steps, B, mels], coins
    [steps] (1: step t takes teacher[t]), drop [B, steps, 2, P]. Returns
    (frames [B, steps*r, mels], stop logits [B, steps*r], alignments [B, T,
    steps]). CPU tensors take the plain version with `dp`; CUDA tensors
    launch the kernel with `kernel_weights` (`dk.pack_weights(dp)`) or
    raise."""
    check_config(cfg)
    if memory.device.type == "cpu":
        return teacher_forced(dp, cfg, keys, memory, mask, teacher, coins,
                              drop)
    if kernel_weights is None:
        raise ValueError("the teacher-forced kernel takes kernel_weights="
                         "pack_weights(dp), built once per set of weights")
    global launches
    out = _teacher_forced_cuda(kernel_weights, cfg, keys, memory, mask,
                               teacher, coins, drop)
    launches += 1
    return out


def _check_tf_operands(cfg, memory, teacher, coins, drop):
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    B, _, _ = memory.shape
    dev = memory.device
    steps = teacher.shape[0]
    P = tc.prenet_layers[-1]
    if steps < 1 or teacher.shape != (steps, B, mels) or teacher.device != dev:
        raise ValueError(f"teacher must be [steps, B, mels] on {dev}, got "
                         f"{tuple(teacher.shape)} on {teacher.device}")
    if coins.shape != (steps,):
        raise ValueError(f"coins must be [{steps}], got {tuple(coins.shape)}")
    if drop.shape != (B, steps, 2, P) or drop.device != dev:
        raise ValueError(f"drop must be [B, steps, 2, P] on {dev}")
    return steps


def _teacher_forced_cuda(kw: dk.KernelWeights, cfg: Config, keys, memory,
                         mask, teacher, coins, drop, zmask=None):
    """One launch of csrc/decoder_rows.cu's teacher-forced mode for all
    steps; with zmask [B, steps, 4, U] the train mode, which also returns
    the residuals."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r, P, U = tc.outputs_per_step, tc.prenet_layers[-1], tc.decoder_lstm_units
    B, T, M = memory.shape
    dev = memory.device
    steps = _check_tf_operands(cfg, memory, teacher, coins, drop)
    L = dk.prepare_rows(kw, cfg, keys, memory, mask, TEACHER_FORCED,
                        teacher_forced=True)
    state = dk.pack_rows_state(init_decoder_state(cfg, B, T, M, dev))
    out = torch.empty(B, steps, r * mels + r, device=dev)
    align = torch.empty(B, steps, T, device=dev)
    res = None
    if zmask is not None:
        if zmask.shape != (B, steps, 4, U) or zmask.device != dev:
            raise ValueError(f"zmask must be [B, steps, 4, U] on {dev}")
        A = kw.wq.shape[1]
        width = dict(cum_pre=T, q=A, z1=4 * U, z2=4 * U, h0d=P, hpre=P,
                     ctx=M, h1=U, c1=U, h2=U, c2=U)
        res = {k: torch.empty(B, steps, width[k], device=dev)
               for k in RES_NAMES}
    dk.rows_launch(L, cfg, drop.to(torch.float32).contiguous(), state,
                   state, out, align, None, None, t0=0, nsteps=steps,
                   s_total=steps,
                   teacher=teacher.to(torch.float32).contiguous(),
                   coins=coins.to(device=dev, dtype=torch.int32).contiguous(),
                   zmask=(None if zmask is None
                          else zmask.to(torch.uint8).contiguous()),
                   res=None if res is None else [res[k] for k in RES_NAMES])
    frames = out[..., :r * mels].reshape(B, steps * r, mels)
    stops = out[..., r * mels:].reshape(B, steps * r)
    if res is None:
        return frames, stops, align.transpose(1, 2)
    res.update(out=out, align=align)
    return frames, stops, align.transpose(1, 2), res


def teacher_forced_train_fwd_plain(dp: DecoderParams, cfg: Config, keys,
                                   memory, mask, teacher, coins, drop,
                                   zmask):
    """The train forward's plain PyTorch version (same contract as
    `teacher_forced_train_fwd`)."""
    check_config(cfg)
    return teacher_forced_train(dp, cfg, keys, memory, mask, teacher, coins,
                                drop, zmask)


def teacher_forced_train_fwd(dp: DecoderParams, cfg: Config, keys, memory,
                             mask, teacher, coins, drop, zmask, *,
                             kernel_weights: dk.KernelWeights | None = None):
    """The train forward: `teacher_forced_fwd`'s operands and zoneout masks
    zmask [B, steps, 4, U] bool (`zoneout_masks`). Returns (frames, stop
    logits, alignments, res), res the residuals of
    `models/tacotron/decoder.py:teacher_forced_train`. CPU tensors take
    the plain version; CUDA tensors launch the kernel's train mode with
    `kernel_weights` or raise."""
    check_config(cfg)
    if memory.device.type == "cpu":
        return teacher_forced_train(dp, cfg, keys, memory, mask, teacher,
                                    coins, drop, zmask)
    if kernel_weights is None:
        raise ValueError("the teacher-forced kernel takes kernel_weights="
                         "pack_weights(dp), built once per set of weights")
    global train_launches
    out = _teacher_forced_cuda(kernel_weights, cfg, keys, memory, mask,
                               teacher, coins, drop, zmask)
    train_launches += 1
    return out


def teacher_forced_bwd(dp: DecoderParams, cfg: Config, res, keys, memory,
                       mask, coins, drop, zmask, dout, dalign, *,
                       kernel_weights: dk.KernelWeights | None = None,
                       cs: int | None = None):
    """The BPTT backward of the train forward: res its residuals, dout
    [B, steps, r*mels + r] the gradient of its projection (frames | stop
    logits), dalign [B, steps, T] that of its alignments. Returns the dict
    of `models/tacotron/decoder.py:teacher_forced_bwd_plain`. CPU tensors
    take that plain version; CUDA tensors launch `csrc/decoder_bwd.cu`
    with `kernel_weights` (whose matmul weights `bwd_stream` packs on
    every call) at cluster size `cs` (default `bwd_cluster_size`) or
    raise."""
    check_config(cfg)
    if memory.device.type == "cpu":
        return teacher_forced_bwd_plain(dp, cfg, res, keys, memory, mask,
                                        coins, drop, zmask, dout, dalign)
    if kernel_weights is None:
        raise ValueError("the backward kernel takes kernel_weights="
                         "pack_weights(dp), built once per set of weights")
    global bwd_launches
    out = _bwd_cuda(kernel_weights, cfg, res, keys, memory, coins, drop,
                    zmask, dout, dalign, cs)
    bwd_launches += 1
    return out


def _bwd_lib():
    from ..native import build
    global _bwd_argtypes_set
    lib = build.load("decoder_bwd")
    if not _bwd_argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.taco_decoder_bwd_launch.argtypes = [vp, ci, vp, ci, vp]
        lib.taco_decoder_bwd_launch.restype = ci
        lib.taco_decoder_bwd_supported.argtypes = [ci] * 10
        lib.taco_decoder_bwd_supported.restype = ci
        lib.taco_decoder_bwd_plan.argtypes = [ci] * 11 + [vp]
        lib.taco_decoder_bwd_plan.restype = ci
        for fn in ("rows", "n_ptr", "n_int"):
            getattr(lib, f"taco_decoder_bwd_{fn}").argtypes = []
            getattr(lib, f"taco_decoder_bwd_{fn}").restype = ci
        _bwd_argtypes_set = True
    return lib


_BWD_INTS = ("B", "T", "S", "mels", "P", "U", "M", "A", "KW", "r", "FOp",
             "f32_weights", "cs")
# csrc/decoder_bwd.cu's stream (`dk.stream_tiles`): a product's m-tiles go
# in groups of BWD_NW (its compute warps, one each), BWD_KC k-tiles a warp
# in each 32 KB chunk
BWD_NW, BWD_KC = dk.STREAM_NW, dk.STREAM_KC


def bwd_widths(cfg: Config, kw: dk.KernelWeights, memory_width: int,
               T: int):
    """(T, mels, P, U, M, A, KW, FOp, r): the backward kernel's widths."""
    tc = cfg.tacotron
    return (T, cfg.audio.num_mels, tc.prenet_layers[-1],
            tc.decoder_lstm_units, memory_width, kw.wq.shape[1],
            kw.wp.shape[0], kw.fop, tc.outputs_per_step)


def bwd_supported(widths, cs: int) -> bool:
    """Whether kernel 4b takes these widths (`bwd_widths`) at cluster size
    cs: csrc/decoder_bwd.cu's `supported`, the one statement of its
    envelope."""
    return bool(_bwd_lib().taco_decoder_bwd_supported(*widths, cs))


def bwd_cluster_size(widths) -> int:
    """The backward kernel's cluster size at these widths: 16 CTAs (each
    SM streams half the weight bytes of 8) where it takes them, else 8."""
    return 16 if bwd_supported(widths, 16) else 8


def bwd_plan(widths, cs: int, f32: bool) -> dict:
    """The launch's plan (csrc/decoder_bwd.cu `layout`), in bytes: shared
    memory, a CTA's own weight stream and the shared one (the prenet's),
    the global scratch of a cluster and what a CTA spills to it; and the
    buffers that sit in shared memory and the ring's slots."""
    out = (ctypes.c_longlong * 7)()
    if _bwd_lib().taco_decoder_bwd_plan(*widths, cs, int(f32),
                                        ctypes.cast(out, ctypes.c_void_p)):
        raise ValueError(f"widths {widths} outside the backward kernel's "
                         f"envelope at cluster size {cs}")
    keys = ("smem", "stream", "shared", "scratch", "spill", "in_smem",
            "slots")
    return dict(zip(keys, (int(v) for v in out)))


def bwd_stream(kw: dk.KernelWeights, cs: int):
    """The backward kernel's weight stream, bytes: for each CTA c its own
    tiles of the projection's rows of its units and context columns, the
    query weight's rows of its units, its gate columns of [l2_wx; l2_wh]
    and of [l1_wp; l1_wc; l1_wh] (`pack_weights`' gate split, redone for
    cs CTAs); then, once for every CTA, pre_w1 and pre_w0
    (csrc/decoder_bwd.cu's products, in the order it takes them), in the
    weight dtype. Built from the weights on every call: they change every
    train step."""
    U = kw.l2_w.shape[1] // 2
    M = kw.proj_w.shape[0] - U
    Uc, Mc = U // cs, M // cs
    ks = 16 if kw.l1_w.dtype == torch.bfloat16 else 8

    def gates(w):
        """[kw.cs, K, 4U/kw.cs] -> [cs, K, 4U/cs]"""
        n, K, g = w.shape
        w = w.reshape(n, K, 4, g // 4).permute(1, 2, 0, 3).reshape(K, -1)
        return dk.split_gates(w, cs)

    proj = kw.proj_w
    proj = torch.cat([proj[:U].reshape(cs, Uc, -1),
                      proj[U:].reshape(cs, Mc, -1)], 1)
    own = [proj, kw.wq.reshape(cs, Uc, -1), gates(kw.l2_w), gates(kw.l1_w)]
    shared = [dk.stream_tiles(w[None], ks) for w in (kw.pre_w1, kw.pre_w0)]
    return torch.cat([torch.cat([dk.stream_tiles(w, ks) for w in own],
                                1).reshape(-1), *[t[0] for t in shared]])


def _bwd_cuda(kw: dk.KernelWeights, cfg: Config, res, keys, memory, coins,
              drop, zmask, dout, dalign, cs=None):
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r, P, U = tc.outputs_per_step, tc.prenet_layers[-1], tc.decoder_lstm_units
    B, T, M = memory.shape
    S = dout.shape[1]
    A, KW = kw.wq.shape[1], kw.wp.shape[0]
    FO = r * mels + r
    dev = memory.device
    if kw.E:
        raise ValueError("the backward takes no emt_attn weights")
    bf16 = dk.weight_type(kw, dev) == torch.bfloat16
    rnd = round_bf16 if bf16 else identity
    lib = _bwd_lib()
    widths = bwd_widths(cfg, kw, M, T)
    cs = cs or bwd_cluster_size(widths)
    if not bwd_supported(widths, cs):
        raise ValueError(f"widths {widths} outside the backward kernel's "
                         f"envelope at cluster size {cs}")
    plan = bwd_plan(widths, cs, not bf16)
    want = dict(align=T, cum_pre=T, q=A, z1=4 * U, z2=4 * U, c1=U, c2=U,
                h0d=P, hpre=P)
    for k, n in want.items():
        if res[k].shape != (B, S, n) or res[k].dtype != torch.float32:
            raise ValueError(f"residual {k} must be f32 [B, S, {n}]")
    if dout.shape != (B, S, FO) or dalign.shape != (B, S, T):
        raise ValueError("dout must be [B, S, r*mels + r], dalign [B, S, T]")
    if (drop.shape != (B, S, 2, P) or zmask.shape != (B, S, 4, U)
            or coins.shape != (S,)):
        raise ValueError("drop, zmask or coins do not match the residuals")
    stream = bwd_stream(kw, cs)
    if stream.numel() != cs * plan["stream"] + plan["shared"]:
        raise ValueError(f"weight stream of {stream.numel()} bytes, the "
                         f"kernel reads {cs} x {plan['stream']} + "
                         f"{plan['shared']}")
    rows = lib.taco_decoder_bwd_rows()
    clusters = -(-B // rows)
    wp = rnd(kw.wp)
    keys_eff = (keys.float() + kw.b_eff).contiguous()
    f32 = lambda x: x.to(device=dev, dtype=torch.float32).contiguous()
    e = lambda *shape: torch.empty(*shape, device=dev)
    out = dict(dz1=e(B, S, 4 * U), dz2=e(B, S, 4 * U), da0=e(B, S, P),
               da1=e(B, S, P), dproj=e(B, S, FO), dctx=e(B, S, M),
               dq=e(B, S, A), dcum=e(B, S, T), dkeys=e(B, T, A),
               dwp=e(clusters, cs, KW, A), dva=e(B, cs, A))
    scratch = torch.empty(clusters * plan["scratch"], dtype=torch.uint8,
                          device=dev)
    mem_w = memory.to(device=dev, dtype=kw.l1_w.dtype).contiguous()
    ptrs = [stream, keys_eff, mem_w, f32(wp), f32(kw.v_a),
            *[f32(res[k]) for k in ("align", "cum_pre", "q", "z1", "z2",
                                    "c1", "c2", "h0d", "hpre")],
            f32(drop), zmask.to(device=dev, dtype=torch.uint8).contiguous(),
            coins.to(device=dev, dtype=torch.int32).contiguous(),
            f32(dout), f32(dalign),
            *[out[k] for k in ("dz1", "dz2", "da0", "da1", "dproj", "dctx",
                               "dq", "dcum", "dkeys", "dwp", "dva")],
            scratch]
    ints = dict(B=B, T=T, S=S, mels=mels, P=P, U=U, M=M, A=A, KW=KW, r=r,
                FOp=kw.fop, f32_weights=int(not bf16), cs=cs)
    assert len(ptrs) == lib.taco_decoder_bwd_n_ptr()
    assert len(_BWD_INTS) == lib.taco_decoder_bwd_n_int()
    rc = lib.taco_decoder_bwd_launch(
        (ctypes.c_void_p * len(ptrs))(*[ctypes.c_void_p(x.data_ptr())
                                        for x in ptrs]), len(ptrs),
        (ctypes.c_int * len(_BWD_INTS))(*[ints[k] for k in _BWD_INTS]),
        len(_BWD_INTS),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    from ..native.build import check
    check(rc, "taco_decoder_bwd_launch")
    # the per-CTA partial sums, added in a fixed order
    out["dwp"] = out["dwp"].sum((0, 1))
    out["dva"] = out["dva"].sum((0, 1))
    return out


def _f32(x):
    return x.float()


def weight_grads(cfg: Config, dp: DecoderParams, res, bwd, teacher, coins):
    """The parameter, key and memory gradients from the backward's per-step
    activation gradients (JAX `weight_grads`, :667-765): f32 products over
    the stacked steps, each activation entering as it entered the forward
    product (rounded to bf16 with bf16 weights). teacher [steps, B, mels].
    Returns (DecoderParams of gradients, dkeys [B, T, A], dmemory [B, T,
    M])."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r = tc.outputs_per_step
    rnd = round_bf16 if dp.l1_wp.dtype == torch.bfloat16 else identity
    B, S = res["z1"].shape[:2]

    def mm(x, g):
        """sum over (b, s) of rnd(x)ᵀ g, in f32."""
        x = rnd(_f32(x))
        return x.reshape(B * S, -1).t() @ _f32(g).reshape(B * S, -1)

    def shift1(x):
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)

    sum_bs = lambda g: _f32(g).sum((0, 1))
    prev = shift1(res["out"][..., (r - 1) * mels:r * mels])
    x_in = torch.where(coins.to(prev.device).bool()[None, :, None],
                       teacher.to(prev).transpose(0, 1), prev)
    da0, da1, dz1, dz2 = bwd["da0"], bwd["da1"], bwd["dz1"], bwd["dz2"]
    dproj, dkeys = bwd["dproj"], bwd["dkeys"]
    d_beff = dkeys.sum((0, 1))
    loc_k, loc_b, wloc = _f32(dp.loc_k), _f32(dp.loc_b), _f32(dp.wloc)
    grads = DecoderParams(
        pre_w0=mm(x_in, da0), pre_b0=sum_bs(da0),
        pre_w1=mm(res["h0d"], da1), pre_b1=sum_bs(da1),
        l1_wp=mm(res["hpre"], dz1), l1_wc=mm(shift1(res["ctx"]), dz1),
        l1_wh=mm(shift1(res["h1"]), dz1), l1_b=sum_bs(dz1),
        l2_wx=mm(res["h1"], dz2), l2_wh=mm(shift1(res["h2"]), dz2),
        l2_b=sum_bs(dz2), wq=mm(res["h2"], bwd["dq"]),
        loc_k=bwd["dwp"] @ wloc.t(), loc_b=wloc @ d_beff,
        wloc=loc_k.t() @ bwd["dwp"] + torch.outer(loc_b, d_beff),
        v_a=bwd["dva"], b_a=d_beff,
        proj_wo=mm(res["h2"], dproj), proj_wc=mm(res["ctx"], dproj),
        proj_b=sum_bs(dproj))
    dmem = torch.einsum("bst,bsm->btm", rnd(_f32(res["align"])),
                        _f32(bwd["dctx"]))
    return grads, dkeys, dmem


def extract_params_traced(dec, cfg: Config) -> DecoderParams:
    """The decoder module's flax-layout parameters (models/tacotron/
    decoder.py:Decoder) -> DecoderParams in f32, differentiably, so that
    gradients reach the flax-named parameters (JAX `extract_decoder_
    params_traced`, :844): the LSTM kernels split by input (under emt_attn
    without the emt rows, which `extract_emt_params_traced` takes), the
    forget bias folded, frame and stop projections joined. The prenet
    fields are None for a prenet other than the kernels' (`prenet_traced`
    gives its layers)."""
    tc = cfg.tacotron
    U, P = tc.decoder_lstm_units, tc.prenet_layers[-1]
    pre, att = dec.prenet, dec.attention
    l1k, l2k = dec.lstm1.kernel, dec.lstm2.kernel
    M, ER = dec.memory_width, emt_context_width(cfg) + dec.ref_width
    fold = torch.zeros(4 * U, device=l1k.device)
    fold[2 * U:3 * U] = 1.0
    fp, sp = dec.frame_projection["Dense_0"], dec.stop_projection["Dense_0"]
    proj_w = torch.cat([fp.kernel, sp.kernel], 1)
    conv = att.location_features_convolution
    two = kernel_prenet(cfg)
    return DecoderParams(
        pre_w0=pre["Dense_0"].kernel if two else None,
        pre_b0=pre["Dense_0"].bias if two else None,
        pre_w1=pre["Dense_1"].kernel if two else None,
        pre_b1=pre["Dense_1"].bias if two else None,
        l1_wp=l1k[:P], l1_wc=l1k[P:P + M], l1_wh=l1k[P + M + ER:],
        l1_b=dec.lstm1.bias + fold, l2_wx=l2k[:U], l2_wh=l2k[U:],
        l2_b=dec.lstm2.bias + fold, wq=att.query_layer.kernel,
        loc_k=conv.kernel[:, 0], loc_b=conv.bias,
        wloc=att.location_features_layer.kernel,
        v_a=att.attention_variable_projection[:, 0], b_a=att.attention_bias,
        proj_wo=proj_w[:U], proj_wc=proj_w[U:],
        proj_b=torch.cat([fp.bias, sp.bias]))


def prenet_traced(dec) -> tuple:
    """The decoder module's prenet as (kernel, bias) pairs, one a layer,
    differentiably (the plain decode's `prenet`)."""
    return tuple((d.kernel, d.bias) for d in dec.prenet.values())


def extract_emt_params_traced(dec, cfg: Config) -> EmtParams | None:
    """The emt_attn attention's weights of the decoder module, in f32 and
    differentiably (the layout of `ops/tacotron_decoder_kernel.
    extract_emt_params`): LSTM1's context_emt and ref_spk rows, and the
    simple attention's W1, W2, V or the multi-head attention's q_proj,
    k_proj, scorer and (multihead) attn_emt_out. None without emt_attn."""
    gst = cfg.gst
    if not gst.emt_attn:
        return None
    P = cfg.tacotron.prenet_layers[-1]
    l1k, M = dec.lstm1.kernel, dec.memory_width
    E, R = emt_context_width(cfg), dec.ref_width
    ae = dec.attention_emt
    ep = dict(l1_we=l1k[P + M:P + M + E],
              l1_wr=l1k[P + M + E:P + M + E + R] if R else None)
    if gst.emt_attn_type == "simple":
        ep.update(emt_w1=ae.W1.kernel, emt_b1=ae.W1.bias,
                  emt_w2=ae.W2.kernel, emt_b2=ae.W2.bias,
                  emt_v=ae.V.kernel[:, 0])
    else:
        ep.update(mh_q_w=ae.q_proj.kernel, mh_q_b=ae.q_proj.bias,
                  mh_k_w=ae.k_proj.kernel, mh_k_b=ae.k_proj.bias,
                  mh_v=ae.attention_v, mh_g=ae.attention_g,
                  mh_b=ae.attention_b)
        if gst.emt_attn_type == "multihead":
            ep.update(mh_out_w=dec.attn_emt_out.kernel,
                      mh_out_b=dec.attn_emt_out.bias)
    return EmtParams(**ep)


MATMUL = ("pre_w0", "pre_w1", "l1_wp", "l1_wc", "l1_wh", "l2_wx", "l2_wh",
          "wq", "proj_wo", "proj_wc")
# the emt_attn weights that the step loop multiplies (the decode weight
# dtype in `extract_emt_params`)
EMT_MATMUL = ("l1_we", "emt_w2", "mh_q_w", "mh_out_w")


def cast_params(dp: DecoderParams, weight_dtype) -> DecoderParams:
    """Matmul weights in `weight_dtype`, the rest f32 (the layout of
    `ops/tacotron_decoder_kernel.extract_decoder_params`); absent fields
    stay None."""
    return DecoderParams(*[
        None if v is None else
        v.detach().to(weight_dtype if k in MATMUL else torch.float32)
        for k, v in dp._asdict().items()])


class FusedTeacherForced(torch.autograd.Function):
    """The teacher-forced decode with the fused backward (JAX
    `make_fused_teacher_forced`, :768): forward `teacher_forced_train_fwd`,
    backward `teacher_forced_bwd` + `weight_grads`. apply(cfg, timer, keys
    [B, T, A], memory [B, T, M], mask [B, T], teacher [steps, B, mels],
    coins [steps], drop [B, steps, 2, P], zmask [B, steps, 4, U], *dp)
    with dp the f32 DecoderParams of `extract_params_traced` and timer
    None or a `StepTimer` (train/tacotron_step.py) that times the two
    kernels and weight_grads -> (frames [B,
    steps*r, mels], stop logits [B, steps*r], alignments [B, T, steps]),
    with gradients for keys, memory and every field of dp. The weights are
    cast to `fused_train_dtype` inside; their gradients come back f32. The
    teacher frames, mask, coins and masks get none (:832-839). The saved
    residuals live as long as the graph: each backward over one forward
    (`torch.autograd.grad(..., retain_graph=True)`, one a loss target, as
    the JAX step takes up to three gradients of one forward) launches the
    backward again on them."""

    @staticmethod
    def forward(ctx, cfg, timer, keys, memory, mask, teacher, coins, drop,
                zmask, *dp):
        time = timer or (lambda name: contextlib.nullcontext())
        dpw = cast_params(DecoderParams(*dp), train_weight_dtype(cfg))
        kw = (dk.pack_weights(dpw) if memory.device.type == "cuda"
              else None)
        with time("train forward (kernel 4a)"):
            frames, stops, aligns, res = teacher_forced_train_fwd(
                dpw, cfg, keys, memory, mask, teacher, coins, drop, zmask,
                kernel_weights=kw)
        ctx.saved = (cfg, time, dpw, kw, res, keys, memory, mask, teacher,
                     coins, drop, zmask)
        return frames, stops, aligns

    @staticmethod
    def backward(ctx, dframes, dstops, daligns):
        (cfg, time, dpw, kw, res, keys, memory, mask, teacher, coins, drop,
         zmask) = ctx.saved
        B, S = res["out"].shape[:2]
        dout = torch.cat([dframes.reshape(B, S, -1),
                          dstops.reshape(B, S, -1)], -1)
        with time("backward (kernel 4b)"):
            bwd = teacher_forced_bwd(dpw, cfg, res, keys, memory, mask,
                                     coins, drop, zmask, dout,
                                     daligns.transpose(1, 2),
                                     kernel_weights=kw)
        with time("weight_grads"):
            grads, dkeys, dmem = weight_grads(cfg, dpw, res, bwd, teacher,
                                              coins)
        return (None, None, dkeys, dmem, None, None, None, None, None,
                *grads)
