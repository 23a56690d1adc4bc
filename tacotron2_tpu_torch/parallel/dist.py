"""A (data × model) layout over a `torch.distributed` process group.

Counterpart of tacotron2_tpu/parallel/mesh.py. The JAX package lays its
devices out as a ('data', 'model') mesh (`make_mesh`, mesh.py:108-121)
and steps on one global batch sharded over 'data'; here each card runs one
process (torchrun's env contract: RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT). With `mesh.model_parallelism` = mp, process r
sits at mesh position (d, m) = divmod(r, mp), where
`np.asarray(devices).reshape(dp, mp)` puts JAX's device r; it belongs to
one data group (the dp processes of its m) and one model group (the mp
processes of its d). `DataParallel` is the process's view of the 'data'
axis: `rank` = d, `world` = dp and `group` = its data group (the default
group where mp = 1), so the batch collectives below run over 'data', and
the processes of one model group hold the same rows, as P('data', ...)
places them on a 2-D mesh. `model_rank`, `model_world` and `model_group`
are its place on 'model', which only the WaveNet's channel sharding
(`partition.py`) reads. Data shard d holds rows [d·B/dp, (d+1)·B/dp) of
the global batch of B rows, and the group's collectives make every step
the step over the global batch, not a mean of per-rank steps:

- `maybe_initialize_distributed` starts the group from that env (a no-op
  without it), with an explicit backend: nccl on the card, gloo where
  asked (the CPU, or ranks that share one card, which nccl refuses);
- `DataParallel` describes the rank (rank, world, device, group);
- inside `activate(dp)` (a trainer's step) the model and the losses take
  their batch reductions over the group: `batch_mean`, `global_count`,
  `batch_sum` (with autograd), `gather_rows` (with autograd), `once` (a
  term computed whole on every rank, counted once across the group),
  `global_rows`, and `rand_rows` (a random draw for the global batch, of
  which the rank keeps its rows, so that dropout and zoneout masks are
  those of the one-process step on the global batch). Outside a step
  each is the one-process operation;
- `pad_to_group`, `all_reduce_grads`, `reduce_metrics` are the steps'
  collectives; `host_rows`, `is_chief`, `shard_batch`,
  `host_shard_indices`, `rank_world` and `all_gather_rows` the host
  loops', the feeders' and the serving paths'.

Only all_reduce, broadcast and all_gather are used, the collectives gloo
takes on CUDA tensors too.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from ..config import MeshConfig

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class DataParallel:
    """One process of a (data × model) group: its index d on 'data', the
    data axis' size, its device and its data group (None: the default
    one); its index m on 'model', that axis' size and its model group
    (None where the size is 1)."""

    rank: int
    world: int
    device: torch.device
    group: object = None
    model_rank: int = 0
    model_world: int = 1
    model_group: object = None

    @property
    def global_rank(self) -> int:
        """The process's rank in the whole group: d·mp + m."""
        return self.rank * self.model_world + self.model_rank


_CURRENT: Optional[DataParallel] = None     # set by the initialization
_ACTIVE: Optional[DataParallel] = None      # set inside a step


def check_mesh(mesh: Optional[MeshConfig], world: int) -> tuple:
    """MeshConfig against the group, as `make_mesh` checks it against the
    devices: (dp, mp), with dp = `data_parallelism` or, at -1, world / mp;
    raises where mp does not divide the world or dp·mp is not it."""
    mesh = mesh or MeshConfig()
    mp = max(1, mesh.model_parallelism)
    if world % mp:
        raise ValueError(f"{world} ranks not divisible by "
                         f"model_parallelism={mp}")
    dp = mesh.data_parallelism if mesh.data_parallelism > 0 else world // mp
    if dp * mp != world:
        raise ValueError(f"mesh {dp}x{mp} != {world} ranks")
    return dp, mp


def mesh_groups(rank: int, dp: int, mp: int) -> tuple:
    """(data group, model group) of process `rank` on a dp × mp layout:
    every process creates every group, in one order (`new_group`'s rule),
    and keeps its two. Where mp is 1 the data group is the default one."""
    if mp == 1:
        return None, None
    d, m = divmod(rank, mp)
    data = [tdist.new_group([i * mp + j for i in range(dp)])
            for j in range(mp)]
    model = [tdist.new_group([i * mp + j for j in range(mp)])
             for i in range(dp)]
    return data[m], model[d]


def rank_device(device, backend: str, local_rank: int,
                local_world: int) -> torch.device:
    """The rank's device: the CPU where asked, else cuda:LOCAL_RANK (or the
    index given). Ranks of one host that would share a card raise under
    nccl, which refuses two ranks on one device; under gloo they share it
    (LOCAL_RANK modulo the cards)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device {dev}: cuda or cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device; pass device='cpu' to train on "
                           "the CPU")
    if dev.index is None:
        shared, index = local_rank >= n, local_rank % n
    else:
        shared, index = local_world > 1, dev.index
    if shared and backend == "nccl":
        raise ValueError(
            f"NCCL refuses two ranks on one device: {local_world} ranks on "
            f"this host, {n} card(s), rank {local_rank} would share "
            f"cuda:{index}; run one rank a card, or pass backend='gloo' to "
            f"share a card")
    return torch.device("cuda", index)


def maybe_initialize_distributed(backend: Optional[str] = None,
                                 device=None,
                                 mesh: Optional[MeshConfig] = None,
                                 timeout_s: float = 1800.0
                                 ) -> Optional[DataParallel]:
    """Start the process group from torchrun's env (JAX mesh.py:24: one code
    path for one process and for N). Without RANK / WORLD_SIZE /
    LOCAL_RANK / MASTER_ADDR / MASTER_PORT it does nothing and returns
    None; a second call returns the group already started. `device`
    "cpu" keeps the rank on the CPU, else it takes cuda:LOCAL_RANK
    (`rank_device`). `backend` defaults to nccl on the card and gloo on
    the CPU; it is never switched behind the caller's back."""
    global _CURRENT
    if _CURRENT is not None:
        return _CURRENT
    if not all(os.environ.get(k) for k in ENV):
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dp_size, mp = check_mesh(mesh, world)
    cpu = torch.device(device if device is not None else "cuda").type \
        == "cpu"
    backend = backend or ("gloo" if cpu else "nccl")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: nccl or gloo")
    if backend == "nccl" and cpu:
        raise ValueError("nccl runs on CUDA devices; the CPU takes gloo")
    dev = rank_device(device, backend, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    data_group, model_group = mesh_groups(rank, dp_size, mp)
    d, m = divmod(rank, mp)
    _CURRENT = DataParallel(d, dp_size, dev, data_group, m, mp, model_group)
    return _CURRENT


def current() -> Optional[DataParallel]:
    """The group this process started, or None."""
    return _CURRENT


def shutdown() -> None:
    """Leave the group (each rank, at its end)."""
    global _CURRENT
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _CURRENT = None


def barrier() -> None:
    """Wait for every rank of the started group (nothing without one)."""
    if _CURRENT is not None:
        tdist.barrier()


def rank_world() -> tuple:
    """(d, dp), the process's place on 'data' in the started group, (0, 1)
    without one: what the feeders and host loops shard by."""
    dp = _CURRENT
    return (dp.rank, dp.world) if dp is not None else (0, 1)


def is_chief() -> bool:
    """Whether this process writes the run's files: rank 0 of the whole
    group, or a process without a group."""
    dp = _CURRENT
    return dp is None or dp.global_rank == 0


def host_rows(batch_size: int, device):
    """A host loop's (group or None, its device, this rank's rows of each
    step of `batch_size` global rows)."""
    dp = _CURRENT
    if dp is None:
        return None, device, batch_size
    if batch_size % dp.world:
        raise ValueError(f"batch size {batch_size} does not divide over "
                         f"{dp.world} ranks")
    return dp, dp.device, batch_size // dp.world


def host_shard_indices(n: int) -> np.ndarray:
    """This data shard's stride shard of range(n) (JAX mesh.py:102)."""
    rank, world = rank_world()
    return np.arange(rank, n, world)


def shard_batch(batch, dp: DataParallel):
    """Data shard `dp.rank`'s rows of a global batch: the block [d·B/dp,
    (d+1)·B/dp) of every array's leading axis, as the JAX mesh shards
    P('data') (mesh.py:132); the processes of one model group get the
    same rows. B must divide by the data axis' size."""
    def rows(x):
        if not (torch.is_tensor(x) or isinstance(x, np.ndarray)) \
                or x.ndim == 0:
            return x
        B = x.shape[0]
        assert B % dp.world == 0, \
            f"batch {B} not divisible by the {dp.world} ranks"
        n = B // dp.world
        return x[dp.rank * n:(dp.rank + 1) * n]
    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    return rows(batch)


class _GatherRows(torch.autograd.Function):
    """all_gather along the rows, in rank order; the backward sums the
    ranks' gradients of the whole (an all_reduce: gloo has no
    reduce_scatter on CUDA tensors) and keeps the rank's rows."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp, ctx.n = dp, x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dp.world)]
        tdist.all_gather(parts, x, group=dp.group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g):
        dp, n = ctx.dp, ctx.n
        g = g.contiguous().clone()
        tdist.all_reduce(g, group=dp.group)
        return g[dp.rank * n:(dp.rank + 1) * n], None


class _SumOverGroup(torch.autograd.Function):
    """all_reduce SUM whose backward is the all_reduce SUM of the
    gradients (torch.distributed.nn.functional.all_reduce's rule, which
    this version of torch deprecates)."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        x = x.contiguous().clone()
        tdist.all_reduce(x, group=dp.group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        tdist.all_reduce(g, group=ctx.dp.group)
        return g, None


def all_gather_rows(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """The ranks' tensors concatenated along the rows in rank order, on
    every rank (with autograd)."""
    return _GatherRows.apply(x, dp)


# ---------------------------------------------------------------- the step

def active() -> Optional[DataParallel]:
    """The group of the step being run, or None."""
    return _ACTIVE


@contextlib.contextmanager
def activate(dp: Optional[DataParallel]):
    """Run the body's batch reductions and random draws over `dp`'s group
    (nothing changes for None)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, dp
    try:
        yield dp
    finally:
        _ACTIVE = prev


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch of a tensor whose shape is the same
    on every rank (its padded axes padded to the group's length): the
    rank's share, Σ x / (x.numel() · world)."""
    dp = _ACTIVE
    if dp is None:
        return x.mean()
    return x.sum() / (x.numel() * dp.world)


def global_count(n: torch.Tensor) -> torch.Tensor:
    """A denominator summed over the group, without gradient."""
    dp = _ACTIVE
    if dp is None:
        return n
    n = n.detach().float().clone()
    tdist.all_reduce(n, group=dp.group)
    return n


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the group, with autograd (the backward sums the
    ranks' gradients)."""
    dp = _ACTIVE
    return x if dp is None else _SumOverGroup.apply(x, dp)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of x, with autograd."""
    dp = _ACTIVE
    return x if dp is None else all_gather_rows(x, dp)


def once(x):
    """A term that every rank computes whole (of the parameters, or of
    gathered or summed values): its share, so the group counts it once."""
    dp = _ACTIVE
    return x if dp is None else x / dp.world


def global_rows(n: int) -> int:
    """The global batch's rows, of a rank's n."""
    dp = _ACTIVE
    return n if dp is None else n * dp.world


def rand_rows(shape: Sequence[int], generator=None, device=None,
              dim: int = 0) -> torch.Tensor:
    """torch.rand of `shape`, whose axis `dim` is the batch: inside a step
    the draw for the global batch, of which the rank keeps its rows; the
    generator moves alike on every rank."""
    dp = _ACTIVE
    if dp is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    full = list(shape)
    n = full[dim]
    full[dim] = n * dp.world
    u = torch.rand(full, generator=generator, device=device)
    return u.narrow(dim, dp.rank * n, n).contiguous()


def pad_to_group(batch: Dict[str, torch.Tensor], pads: Dict[str, object],
                 dp: DataParallel) -> Dict[str, torch.Tensor]:
    """Pad axis 1 of each key of `pads` to its longest over the group (one
    all_reduce MAX), with the pad value given (a scalar, or a vector over
    the trailing axis), so that every padded axis has the global batch's
    length. Checks that every rank holds as many rows."""
    keys = [k for k in pads if k in batch]
    B = next(iter(batch.values())).shape[0]
    dev = next(iter(batch.values())).device
    lens = torch.tensor([B, -B] + [batch[k].shape[1] for k in keys],
                        dtype=torch.int64, device=dev)
    tdist.all_reduce(lens, op=tdist.ReduceOp.MAX, group=dp.group)
    lens = lens.tolist()
    if lens[0] != -lens[1]:
        raise ValueError(f"ranks hold {-lens[1]} to {lens[0]} rows: every "
                         f"rank steps on B/world rows")
    out = dict(batch)
    for k, n in zip(keys, lens[2:]):
        x = batch[k]
        if x.shape[1] == n:
            continue
        shape = list(x.shape)
        shape[1] = n - x.shape[1]
        fill = torch.as_tensor(pads[k], dtype=x.dtype, device=x.device)
        out[k] = torch.cat([x, fill.expand(shape)], 1)
    return out


def _buckets(grads, keep) -> Dict[torch.dtype, list]:
    by_dtype: Dict[torch.dtype, list] = {}
    for i, g in enumerate(grads):
        if g is not None and keep(i):
            by_dtype.setdefault(g.dtype, []).append(i)
    return by_dtype


def all_reduce_grads(grads: Sequence[Optional[torch.Tensor]],
                     dp: DataParallel,
                     replicated: Optional[Sequence[bool]] = None) -> list:
    """The gradients summed over the data group, as one flat bucket a
    dtype (None entries stay None). Under a (data × model) group the
    gradients of tensors replicated over 'model' (every one, unless
    `replicated` says which) are then broadcast from the model group's
    first process: its processes compute them alike, but a backward that
    is not deterministic (cuDNN's, atomics) would let their copies of the
    weights drift apart, where JAX's devices along 'model' stay equal."""
    out = list(grads)
    for idx in _buckets(grads, lambda i: True).values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        tdist.all_reduce(flat, group=dp.group)
        for i, part in zip(idx, torch.split(
                flat, [grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    if dp.model_world == 1:
        return out
    rep = (lambda i: True) if replicated is None else \
        (lambda i: replicated[i])
    for idx in _buckets(out, rep).values():
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        tdist.broadcast(flat, src=dp.rank * dp.model_world,
                        group=dp.model_group)
        for i, part in zip(idx, torch.split(
                flat, [out[i].numel() for i in idx])):
            out[i] = part.view_as(out[i])
    return out


def reduce_metrics(terms: Dict[str, torch.Tensor],
                   dp: DataParallel) -> Dict[str, torch.Tensor]:
    """Each rank's shares of the scalar terms summed over the group (one
    all_reduce): the global batch's values."""
    keys = [k for k, v in terms.items() if torch.is_tensor(v)
            and v.dim() == 0]
    if not keys:
        return dict(terms)
    flat = torch.stack([terms[k].detach().float() for k in keys])
    tdist.all_reduce(flat, group=dp.group)
    out = dict(terms)
    out.update(zip(keys, flat.unbind()))
    return out
