"""Training checkpoints (Tacotron and WaveNet): save, restore, partial
restore.

Counterpart of tacotron2_tpu/train/checkpoint.py (orbax there). The port
writes one flax-msgpack file a checkpoint (`utils/flax_msgpack.py`), a map
of:

- "params": the flax-named parameter tree (`convert.tacotron_to_flax`),
  the layout of the JAX package's own checkpoints, so that
  `TacotronSynthesizer` and `cli synthesize --checkpoint` read it as they
  read `taco_ckpt.msgpack`;
- "batch_stats": the BatchNorm statistics, likewise;
- "opt_state": {"count": updates made, "mu", "nu": the Adam moments as
  flax-named trees in the parameters' layout, of the masked-on
  parameters}, the main optimizer's; "opt_state_refnet" and
  "opt_state_nat" alike, the refnet and nat-GAN optimizers', where the
  state holds them (the JAX TrainState's three optimizer states);
- "step": the train step.

Restoring a Tacotron state can keep the fresh values of the parameters
whose flax path a predicate names (`keep_fresh`: the host loop keeps the
`pretrained` subtrees, as JAX `tacotron_train.py:73-77` does with
`partial_restore`).

A WaveNet training state is a map of "params" and "ema_params" (flax-
named trees of `convert.wavenet_to_flax`: `convert.load_wavenet` hands
the EMA tree to `WaveNetSynthesizer` and `cli synthesize
--wavenet-checkpoint`), "opt_state" {"count", "mu", "nu"} in the same
layout, and "step".

A style discriminator's checkpoint (`disc/train.py`) is its flax tree as
it is: {"params", "batch_stats"}.

`CheckpointManager` keeps `<dir>/ckpt-<step>.msgpack`, the newest
`max_to_keep`; `partial_restore` keeps fresh values for the subtrees a
predicate names (the reference's filtered savers);
`import_pretrained_subtree` / `graft_pretrained` take a discriminator's
encoder into the Tacotron's `pretrained_ref_enc_{emt,spk}` (JAX :71).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Callable, Optional

from .. import convert
from ..utils import flax_msgpack
from .tacotron_step import TrainState
from .wavenet_step import WaveNetTrainState


OPT_KEYS = (("opt", "opt_state"), ("opt_refnet", "opt_state_refnet"),
            ("opt_nat", "opt_state_nat"))


def _opt_tree(model, opt) -> dict:
    mu, nu = {}, {}
    for (name, _), m, v in zip(model.named_parameters(), opt.mu, opt.nu):
        if m is not None:
            path = convert.flax_path(name)
            convert.tree_set(mu, path, convert.to_flax_array(
                name, m, offset=False))
            convert.tree_set(nu, path, convert.to_flax_array(
                name, v, offset=False))
    return dict(count=int(opt.count), mu=mu, nu=nu)


def state_tree(state: TrainState) -> dict:
    """The checkpoint's tree of a TrainState."""
    params, stats = convert.tacotron_to_flax(state.model)
    tree = dict(params=params, batch_stats=stats, step=int(state.step))
    for attr, key in OPT_KEYS:
        if getattr(state, attr) is not None:
            tree[key] = _opt_tree(state.model, getattr(state, attr))
    return tree


def load_state_tree(state: TrainState, tree: dict,
                    keep_fresh: Optional[Callable[[str], bool]] = None
                    ) -> TrainState:
    """Fill a TrainState (its model and optimizers) from a checkpoint's
    tree; with `keep_fresh`, the parameters whose lower-case flax path it
    names keep their values (`partial_restore`)."""
    import torch
    params = tree["params"]
    if keep_fresh is not None:
        params = partial_restore(params, convert.tacotron_to_flax(
            state.model)[0], keep_fresh)
    convert.load_tacotron(state.model, params, tree["batch_stats"])
    for attr, key in OPT_KEYS:
        opt = getattr(state, attr)
        if opt is None:
            continue
        sub = tree[key]
        with torch.no_grad():
            for i, (name, p) in enumerate(state.model.named_parameters()):
                if opt.mu[i] is None:
                    continue
                path = convert.flax_path(name)
                for mom, k in ((opt.mu, "mu"), (opt.nu, "nu")):
                    mom[i].copy_(torch.from_numpy(convert.from_flax_array(
                        name, convert.tree_get(sub[k], path),
                        offset=False)))
        opt.count = int(sub["count"])
    state.step = int(tree["step"])
    return state


def wavenet_state_tree(state: WaveNetTrainState) -> dict:
    """The checkpoint's tree of a whole WaveNetTrainState (a state sharded
    over 'model' is made whole first by `partition.gather_wavenet_state`,
    on every process)."""
    if state.model.tp is not None:
        raise ValueError("a sharded WaveNet state: gather_wavenet_state on "
                         "every process first, then save the whole one")
    mu, nu = {}, {}
    for (path, _), m, v in zip(convert.wavenet_named_parameters(state.model),
                               state.opt.mu, state.opt.nu):
        convert.tree_set(mu, path, convert.wavenet_flax_array(path, m))
        convert.tree_set(nu, path, convert.wavenet_flax_array(path, v))
    return dict(params=convert.wavenet_to_flax(state.model),
                ema_params=convert.wavenet_to_flax(state.ema),
                opt_state=dict(count=int(state.opt.count), mu=mu, nu=nu),
                step=int(state.step))


def load_wavenet_state_tree(state: WaveNetTrainState, tree: dict
                            ) -> WaveNetTrainState:
    """Fill a WaveNetTrainState from a checkpoint's tree."""
    import torch
    convert.load_wavenet_params(state.model, tree["params"])
    convert.load_wavenet_params(state.ema, tree["ema_params"])
    opt = tree["opt_state"]
    with torch.no_grad():
        for (path, _), m, v in zip(
                convert.wavenet_named_parameters(state.model), state.opt.mu,
                state.opt.nu):
            for mom, key in ((m, "mu"), (v, "nu")):
                mom.copy_(torch.from_numpy(convert.wavenet_port_array(
                    path, convert.tree_get(opt[key], path))))
    state.opt.count = int(opt["count"])
    state.step = int(tree["step"])
    return state


def save(path: str, state) -> None:
    """Write a TrainState, a WaveNetTrainState or a tree (a map of numpy
    arrays, as a style discriminator's {"params", "batch_stats"})."""
    if isinstance(state, dict):
        tree = state
    elif isinstance(state, WaveNetTrainState):
        tree = wavenet_state_tree(state)
    else:
        tree = state_tree(state)
    flax_msgpack.save(path, tree)


def restore(path: str, state, keep_fresh=None):
    tree = flax_msgpack.load(path)
    if isinstance(state, WaveNetTrainState):
        return load_wavenet_state_tree(state, tree)
    return load_state_tree(state, tree, keep_fresh)


class CheckpointManager:
    """Checkpoints `<directory>/ckpt-<step>.msgpack`, the newest
    `max_to_keep` kept."""

    def __init__(self, directory: str, max_to_keep: int = 50):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(1, max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.msgpack")

    def steps(self):
        found = []
        for p in glob.glob(os.path.join(self.directory, "ckpt-*.msgpack")):
            m = re.fullmatch(r"ckpt-(\d+)\.msgpack", os.path.basename(p))
            if m:
                found.append(int(m.group(1)))
        return sorted(found)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> str:
        path = self.path(step)
        save(path, state)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, state, step: Optional[int] = None, keep_fresh=None):
        return restore(self._path_of(step), state, keep_fresh)

    def load(self, step: Optional[int] = None) -> dict:
        """The checkpoint's own tree (the newest without `step`)."""
        return flax_msgpack.load(self._path_of(step))

    def _path_of(self, step: Optional[int]) -> str:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return self.path(step)


def partial_restore(restored: Any, fresh: Any,
                    skip_predicate: Callable[[str], bool], _path: str = ""
                    ) -> Any:
    """The restored tree, but fresh values for the leaves whose
    lower-case path `skip_predicate` names (e.g. "pretrained" subtrees on
    restart, tacotron/train.py:274-288)."""
    if isinstance(restored, dict):
        return {k: partial_restore(restored[k], fresh[k], skip_predicate,
                                   f"{_path}/{k}" if _path else str(k))
                for k in restored}
    return fresh if skip_predicate(_path.lower()) else restored


def import_pretrained_subtree(params: Any, pretrained: Any,
                              target_prefix: str) -> Any:
    """`params` with its subtree `target_prefix` replaced by `pretrained`
    (the reference's pretrained emt/spk discriminator import,
    tacotron/train.py:280-285); KeyError naming it where the model has no
    such subtree."""
    if target_prefix not in params:
        raise KeyError(f"model has no subtree {target_prefix!r}")
    new = dict(params)
    new[target_prefix] = pretrained
    return new


def graft_pretrained(model, pretrained: Any, pretrained_stats: Any,
                     target_prefix: str):
    """Graft a discriminator's encoder subtree and its BatchNorm
    statistics into the port Tacotron's `target_prefix`
    (`pretrained_ref_enc_{emt,spk}`; JAX tacotron_train.py:81-108): the
    parameters by `import_pretrained_subtree`, the statistics where the
    disc has some and the model keeps that subtree's. Returns the model."""
    params, stats = convert.tacotron_to_flax(model)
    params = import_pretrained_subtree(params, pretrained, target_prefix)
    if pretrained_stats and target_prefix in stats:
        stats = dict(stats)
        stats[target_prefix] = pretrained_stats
    return convert.load_tacotron(model, params, stats)
