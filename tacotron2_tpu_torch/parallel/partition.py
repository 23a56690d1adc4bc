"""WaveNet tensor parallelism: the residual blocks' channels over 'model'.

Counterpart of tacotron2_tpu/parallel/partition.py. The rules are JAX's
`_wavenet_param_spec` (:33-50): in each residual block the causal conv,
the cin/gin 1×1s and their biases (or weight norm's `v` and `g`) are split
along the gate axis G, the skip and out 1×1 kernels along their G/2 rows,
and everything else is replicated, skip and out biases included (added
once). The port holds these weights in flax's layouts ([kw, in, out],
[in, out]; only the replicated upsample kernels are in torch's), so the
axes are JAX's own. Slices are contiguous: over mp processes, model rank
m holds block m of the axis, as `jax.device_put` places a NamedSharding
on the device at mesh position (d, m).

`shard_wavenet_state` cuts a whole `WaveNetTrainState` (weights, EMA,
Adam's moments) down to the process's slices and marks both models with
the group (`WaveNet.tp`); `gather_wavenet_state` undoes it on every
process of a model group, for checkpoints. Under a sharded model the
WaveNet computes in one of two ways, as JAX's does (models/wavenet/
model.py:102-164):

- the fused stack (training, where 'data' > 1, the JAX shard_map with
  P() weights): `gathered_stack_params` all-gathers each sharded weight
  over the model group; kernels 5a/5b then run on the data shard's rows
  with whole weights, the same on every process of a model group, so the
  backward keeps each weight gradient's own slice and moves nothing;
- the channel-split layer loop (`split_block`, everything else): each
  process runs the gated convs on its share of the gate channels and the
  skip and out products on its rows of h, and one all-reduce of the
  [skip | out] partial sums over the model group a layer makes them
  whole (the backward: one all-reduce of the block input's gradient a
  layer, and one of the conditioning's a step).

The gate's halves. The stored G split puts the tanh half a and the
sigmoid half b on different processes (at mp = 2 all of a on m = 0, all of
b on m = 1), yet h = tanh(a)·σ(b) needs both for the same rows. Exchanging
the halves moves B·T·G/mp activations a layer each way; the port instead
regroups the gate-side weights once a forward (`regroup`: an all-gather
of the shards, each process keeping rows [m·G/2mp, (m+1)·G/2mp) of a and
the same rows of b, the rows of h whose skip/out kernel rows it stores)
and its backward all-gathers the regrouped weights' gradients back into
the stored slices: weights, not activations (at the r5 widths ~0.5 MB a
layer against ~65 MB of gate activations at B 16 × 8,000 samples).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
import torch.distributed as tdist

from .dist import DataParallel

GATE_ROLES = ("causal_conv", "cin_conv", "gin_conv")
ROW_ROLES = ("skip_conv", "out_conv")


def leaf_axis(role: str, ndim: int) -> Optional[int]:
    """The axis of a residual-block leaf split over 'model' (JAX
    `_wavenet_param_spec`), or None where it is replicated."""
    if role == "causal_conv":
        return {3: 2, 2: 1}.get(ndim, 0)
    if role in GATE_ROLES:
        return 1 if ndim == 2 else 0
    if role in ROW_ROLES:
        return 0 if ndim == 2 else None
    return None


def param_axis(path: str, ndim: int) -> Optional[int]:
    """`leaf_axis` of a flax path of the WaveNet tree."""
    if "residual_block" not in path:
        return None
    for role in GATE_ROLES + ROW_ROLES:
        if role in path:
            return leaf_axis(role, ndim)
    return None


def wavenet_param_specs(model) -> Dict[str, Optional[int]]:
    """{flax path: axis split over 'model', or None} of every parameter of
    a whole WaveNet."""
    from ..convert import wavenet_named_parameters
    return {path: param_axis(path, p.dim())
            for path, p in wavenet_named_parameters(model)}


def local_block(x: torch.Tensor, axis: int, m: int, mp: int
                ) -> torch.Tensor:
    """Block m of mp along `axis` (contiguous; the axis must divide)."""
    n = x.shape[axis]
    if n % mp:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not divide "
                         f"over {mp} model ranks")
    return x.narrow(axis, m * (n // mp), n // mp)


def shard_wavenet_state(state, dp: DataParallel):
    """Cut a whole WaveNetTrainState to process (d, m)'s slices, in place:
    the sharded parameters of the model and of its EMA copy and their Adam
    moments keep block m of their axis; the step, the count and the
    replicated tensors stay whole. Nothing is exchanged, so `dp` need not
    name live groups. Returns the state."""
    from ..convert import wavenet_named_parameters
    if dp.model_world == 1:
        return state
    if state.model.tp is not None:
        raise ValueError("the state is sharded already")
    m, mp = dp.model_rank, dp.model_world
    named = wavenet_named_parameters(state.model)
    ema = wavenet_named_parameters(state.ema)
    opt = state.opt
    with torch.no_grad():
        for i, ((path, p), (_, e)) in enumerate(zip(named, ema)):
            ax = param_axis(path, p.dim())
            if ax is None:
                continue
            cut = lambda t: local_block(t, ax, m, mp).clone()
            p.data, e.data = cut(p.data), cut(e.data)
            if opt.mu[i] is not None:
                opt.mu[i], opt.nu[i] = cut(opt.mu[i]), cut(opt.nu[i])
    state.model.tp = state.ema.tp = dp
    return state


def _all_gather(x: torch.Tensor, tp: DataParallel) -> list:
    parts = [torch.empty_like(x) for _ in range(tp.model_world)]
    tdist.all_gather(parts, x.contiguous(), group=tp.model_group)
    return parts


def _whole(model, tp: DataParallel):
    """A whole copy of a sharded WaveNet (every process of the model group
    calls it)."""
    from ..convert import wavenet_named_parameters
    from ..models.wavenet.model import WaveNet
    p0 = next(model.parameters())
    out = WaveNet(model.cfg, model.global_conditioning).to(p0.device)
    with torch.no_grad():
        for (path, p), (_, q) in zip(wavenet_named_parameters(model),
                                     wavenet_named_parameters(out)):
            ax = param_axis(path, p.dim())
            q.data = (p.detach().clone() if ax is None
                      else torch.cat(_all_gather(p.detach(), tp), ax))
    return out.requires_grad_(p0.requires_grad)


def gather_wavenet_state(state):
    """The whole WaveNetTrainState of a sharded one (the inverse of
    `shard_wavenet_state`; a collective over each model group, so every
    process calls it), a new state; the sharded one is left as it was. A
    whole state is returned as it is."""
    from ..convert import wavenet_named_parameters
    from ..train.wavenet_step import WaveNetTrainState
    tp = state.model.tp
    if tp is None:
        return state
    opt = copy.copy(state.opt)
    opt.mu, opt.nu = list(opt.mu), list(opt.nu)
    for i, (path, p) in enumerate(wavenet_named_parameters(state.model)):
        ax = param_axis(path, p.dim())
        if ax is not None and opt.mu[i] is not None:
            opt.mu[i] = torch.cat(_all_gather(opt.mu[i], tp), ax)
            opt.nu[i] = torch.cat(_all_gather(opt.nu[i], tp), ax)
    return WaveNetTrainState(state.step, _whole(state.model, tp),
                             _whole(state.ema, tp), opt)


def sharded_global_norm(model, tensors) -> torch.Tensor:
    """optax.global_norm of the whole tree from a WaveNet's per-parameter
    tensors (gradients): of a sharded model, the squares of the sharded
    slices summed over the model group and the replicated tensors counted
    once; of a whole one, `global_norm`."""
    from ..convert import wavenet_named_parameters
    from ..train.optim import global_norm
    tp = model.tp
    if tp is None:
        return global_norm(tensors)
    sq = torch.zeros(2, device=tensors[0].device)
    for (path, p), t in zip(wavenet_named_parameters(model), tensors):
        sq[int(param_axis(path, p.dim()) is None)] += (t.float() ** 2).sum()
    part = sq[:1].clone()
    tdist.all_reduce(part, group=tp.model_group)
    return torch.sqrt(part[0] + sq[1])


# --------------------------------------------------------- the collectives

class _Gather(torch.autograd.Function):
    """The whole weight from its slices (all-gather along `axis`); every
    process of the model group computes the same thing from it, so the
    backward keeps the gradient's own slice."""

    @staticmethod
    def forward(ctx, x, axis, tp):
        ctx.axis, ctx.tp = axis, tp
        return torch.cat(_all_gather(x, tp), axis)

    @staticmethod
    def backward(ctx, g):
        return local_block(g, ctx.axis, ctx.tp.model_rank,
                           ctx.tp.model_world).contiguous(), None, None


def _compute_cols(G: int, j: int, mp: int, device) -> torch.Tensor:
    """The gate columns process j computes: rows [j·n, (j+1)·n) of the
    tanh half and the same rows of the sigmoid half, n = G/2/mp."""
    H = G // 2
    n = H // mp
    r = torch.arange(j * n, (j + 1) * n, device=device)
    return torch.cat([r, H + r])


class _Regroup(torch.autograd.Function):
    """Stored gate-axis slices (block m of the last axis) -> the compute
    layout (`_compute_cols`); the backward all-gathers the compute-layout
    gradients and keeps the stored slice's."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        full = torch.cat(_all_gather(x, tp), -1)
        G = full.shape[-1]
        ctx.G = G
        return full.index_select(-1, _compute_cols(
            G, tp.model_rank, tp.model_world, x.device)).contiguous()

    @staticmethod
    def backward(ctx, g):
        tp, G = ctx.tp, ctx.G
        full = g.new_zeros(*g.shape[:-1], G)
        for j, part in enumerate(_all_gather(g.contiguous(), tp)):
            full.index_copy_(-1, _compute_cols(G, j, tp.model_world,
                                               g.device), part)
        return local_block(full, -1 % full.dim(), tp.model_rank,
                           tp.model_world).contiguous(), None


class _AllReduce(torch.autograd.Function):
    """Sum over the model group in the forward (`fwd`) and of the
    gradients in the backward (`bwd`): Megatron's f (copy in, sum the
    gradients), g (sum the partials, copy the gradient) or both."""

    @staticmethod
    def forward(ctx, x, tp, fwd, bwd):
        ctx.tp, ctx.bwd = tp, bwd
        if not fwd:
            return x.view_as(x)
        x = x.contiguous().clone()
        tdist.all_reduce(x, group=tp.model_group)
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd:
            g = g.contiguous().clone()
            tdist.all_reduce(g, group=ctx.tp.model_group)
        return g, None, None, None


def copy_to_model(x, tp):
    """x used whole by every process's channel share: its gradient is the
    sum of theirs."""
    return None if x is None else _AllReduce.apply(x, tp, False, True)


def reduce_from_model(x, tp):
    """The sum of the processes' partial products (the gradient goes to
    each as it is)."""
    return _AllReduce.apply(x, tp, True, False)


# ---------------------------------------------------------------- compute

def _weights(conv, leaf):
    """(weight, bias or None) of a `_WeightNormed` conv with `leaf` applied
    to each stored tensor."""
    from ..models.wavenet.modules import weight_norm
    if conv.is_weight_normed:
        w = weight_norm(leaf(conv.v), leaf(conv.g))
    else:
        w = leaf(conv.kernel)
    return w, (None if conv.bias is None else leaf(conv.bias))


def gathered_stack_params(blocks, cfg, tp: DataParallel):
    """The fused stack's StackParams from whole weights, all-gathered over
    the model group (differentiable: each slice gets its gradient)."""
    from ..ops import wavenet_train_kernel as wtk
    roles = dict(conv="causal_conv", cin="cin_conv", skip="skip_conv",
                 out="out_conv")

    def wb(conv, name):
        def leaf(t):
            ax = leaf_axis(roles[name], t.dim())
            return t if ax is None else _Gather.apply(t, ax, tp)
        w, b = _weights(conv, leaf)
        return w, (w.new_zeros(w.shape[-1]) if b is None else b)
    return wtk.extract_stack_params(blocks, cfg, wb)


def _row_weights(conv, tp):
    """A skip/out 1×1's stored rows of its weight and its whole bias; under
    weight norm the norm of each output column sums the rows' squares over
    the model group."""
    if not conv.is_weight_normed:
        return conv.kernel, conv.bias
    v = conv.v
    sq = _AllReduce.apply((v * v).sum(0, keepdim=True), tp, True, True)
    g = copy_to_model(conv.g, tp)
    return v * (g / torch.sqrt(sq + 1e-12)), conv.bias


def _biased(y, b, rnd):
    return y if b is None else rnd(y + rnd(b))


def split_block(blk, tp: DataParallel, x, c, g=None, *, kept=None,
                keep: float = 1.0, rnd=None, res_rnd=None):
    """`ResidualConv1DGLU.forward` on the process's channel share: the
    gate on its compute-layout columns, h on its rows, the skip and out
    products summed over the model group. x is the whole block input; c
    and g have passed `copy_to_model`. Returns (x_next, skip), whole."""
    cc = blk.causal_conv
    G = (cc.v if cc.is_weight_normed else cc.kernel).shape[-1] \
        * tp.model_world
    if (G // 2) % tp.model_world:
        raise ValueError(f"gate_channels={G}: G/2 does not divide over "
                         f"{tp.model_world} model ranks")
    residual = x
    if kept is not None:
        x = torch.where(kept, rnd(x / keep), x.new_zeros(()))
    x = copy_to_model(x, tp)
    regroup = lambda t: _Regroup.apply(t, tp)
    w, b = _weights(cc, regroup)
    y = _biased(cc.product(x, w, rnd), b, rnd)
    a, bb = y.chunk(2, -1)
    for conv, v in ((blk.cin_conv, c), (blk.gin_conv, g)):
        if conv is not None and v is not None:
            w, b = _weights(conv, regroup)
            va, vb = _biased(conv.product(v, w, rnd), b, rnd).chunk(2, -1)
            a, bb = rnd(a + va), rnd(bb + vb)
    h = rnd(rnd(torch.tanh(a)) * rnd(torch.sigmoid(bb)))
    ws, bs = _row_weights(blk.skip_conv, tp)
    wo, bo = _row_weights(blk.out_conv, tp)
    S = ws.shape[-1]
    both = reduce_from_model(rnd(h) @ torch.cat([rnd(ws), rnd(wo)], -1), tp)
    s = _biased(rnd(both[..., :S]), bs, rnd)
    o = _biased(rnd(both[..., S:]), bo, rnd)
    if blk.residual_legacy:
        return res_rnd(o + residual) * float(0.5 ** 0.5), s
    return res_rnd(o + residual), s
