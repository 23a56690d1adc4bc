"""The port's WaveNet tensor parallelism (`parallel/partition.py`, the
(data × model) layout of `parallel/dist.py`) on the CPU, against the JAX
package's ('data', 'model') mesh and its unsharded computation.

- Layout, with no process started: the slices `shard_wavenet_state` keeps
  at each mesh position (d, m) of a (4, 2) mesh are the `addressable_shards`
  that JAX's `shard_wavenet_state` puts on the device at (d, m) of the
  8-device CPU mesh, for the parameters, the EMA and Adam's moments.
- Numbers: one gloo group of 2 × 2 processes for the module
  (`torch_parallel_worker.py`, the port alone), mesh (data 2, model 2), at
  tests/test_model_parallel.py's `mp_config`, against JAX's unsharded
  `WaveNet.apply` and `WaveNetTrainer.train_step` on the global batch, at
  that file's tolerances (forward 2e-5 absolute / 1e-4 relative, loss 1e-5
  relative, weights 1e-5 absolute / 1e-4 relative after the steps). The
  clip norm is 1.0, under the ~1.6 the gradients have, so the global-norm
  clipping binds and `grad_norm` (1e-4 relative) is the sharded norm.
  Cases: "loop", the channel-split layer loop (train=False and
  `use_fused_train_stack=False`, JAX's test); "fused", the fused stack on
  weights gathered over 'model' (the plain version of kernels 5a/5b here,
  one forward and one backward a step on every process); "gin", global
  conditioning with weight norm, which takes the split layer loop in
  training. JAX's fused stack saves bf16 activations for its backward, so
  its mesh step leaves the unsharded (layer-loop) step's weights by more
  than 1e-5 after Adam: the fused case's loss and grad_norm are held to
  JAX, its weights to the port's one-process step through the same plain
  stack. Each case's gathered whole state (weights, EMA, moments) equals
  the port's one-process step's on the global batch (ONE_PROCESS_ATOL);
  the data-dependent init under the group gathers to the one-process init;
  a Tacotron step with dropout, zoneout and coins under the 2-D group equals
  the one-process step on the global batch (tests/test_torch_parallel.py's
  bounds), the two processes of a model group bit for bit alike.
"""

import copy
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_worker as W  # noqa: E402
from test_model_parallel import make_batch, mp_config  # noqa: E402
from test_torch_parallel import (case_cfgs, global_batch,  # noqa: E402
                                 init_weights, noise_bound, port_one_process,
                                 rank_batches)
from test_torch_train_step import _close  # noqa: E402
from test_torch_wavenet_train import port_cfg  # noqa: E402

from tacotron2_tpu.models.wavenet.model import WaveNet as JaxWaveNet
from tacotron2_tpu.parallel.mesh import make_mesh
from tacotron2_tpu.parallel.partition import shard_wavenet_state as jax_shard
from tacotron2_tpu.train.wavenet_step import WaveNetTrainer as JaxTrainer
from tacotron2_tpu.train.wavenet_step import WaveNetTrainState as JaxState
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.config import MeshConfig
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.parallel import partition
from tacotron2_tpu_torch.parallel.dist import DataParallel
from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer

DP, MP = 2, 2
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
ONE_PROCESS_ATOL = 1e-6
STEPS = 2
CASES = {
    "loop": {},
    "fused": dict(use_fused_train_stack=True),
    "gin": dict(use_fused_train_stack=True, gin_channels=4,
                use_speaker_embedding=True, n_speakers=3,
                weight_normalization=True),
}


def jax_cfg(name):
    cfg = mp_config(**CASES[name])
    return cfg.replace(train=dataclasses.replace(
        cfg.train, wavenet_gradient_max_norm=1.0))


def global_wn_batch(name):
    b = {k: np.asarray(v) for k, v in make_batch(jax_cfg(name)).items()}
    if CASES[name].get("gin_channels", -1) > 0:
        b["g"] = np.array([0, 2, 1, 2], np.int32)
    return b


def shards(b):
    n = len(b["x"]) // DP
    return [{k: v[d * n:(d + 1) * n] for k, v in b.items()}
            for d in range(DP)]


def weights(name):
    tcfg = port_cfg(jax_cfg(name))
    return convert.wavenet_to_flax(convert.init_wavenet(
        tcfg, torch.Generator().manual_seed(0), "cpu",
        global_conditioning="g" in global_wn_batch(name)))


def ddi_cfg():
    cfg = port_cfg(jax_cfg("loop"))
    return cfg.replace(wavenet=dataclasses.replace(
        cfg.wavenet, weight_normalization=True, data_dependent_init=True))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    spec = dict(mesh=MeshConfig(model_parallelism=MP), cases=[])
    for name in CASES:
        spec[name] = dict(cfg=port_cfg(jax_cfg(name)), params=weights(name),
                          steps=STEPS, batches=shards(global_wn_batch(name)))
        spec["cases"].append((name, "tp_wavenet"))
    spec["ddi"] = dict(cfg=ddi_cfg(), batches=shards(global_wn_batch("loop")))
    spec["cases"].append(("ddi", "tp_init"))
    _, tcfg = case_cfgs(dropout_rate=0.5, zoneout_rate=0.1,
                        tacotron_teacher_forcing_ratio=0.5)
    params, stats = init_weights(tcfg, {})
    b, lengths = global_batch(tcfg)
    spec["taco_dropout"] = dict(
        cfg=tcfg, flags={}, params=params, stats=stats, steps=2,
        global_batch=b,
        batches=rank_batches(b, lengths, tcfg.tacotron.outputs_per_step))
    spec["cases"].append(("taco_dropout", "taco_steps"))
    join = W.launch(spec, str(root), DP * MP, timeout_s=300)
    results = []

    def wait():
        if not results:
            results.extend(join())
        return spec, results
    yield wait
    wait()


# ------------------------------------------------------------ references

def jax_run(name):
    """JAX's unsharded forward (train=False) and STEPS jitted train steps
    on the global batch, from the case's weights."""
    cfg = jax_cfg(name)
    b = global_wn_batch(name)
    params = jax.tree_util.tree_map(jnp.asarray, weights(name))
    y = jax.jit(lambda p, x, c, g: JaxWaveNet(config=cfg).apply(
        {"params": p}, x, c, g, train=False).y_hat)(
            params, b["x"], b["c"], b.get("g"))
    trainer = JaxTrainer(cfg)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     ema_params=params, opt_state=trainer.tx.init(params))
    step = jax.jit(trainer.train_step)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, b, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return np.asarray(y), metrics, W._flat(
        jax.tree_util.tree_map(np.asarray, state.params))


def port_run(name, monkeypatch=None):
    """The port's one-process trainer on the global batch (the fused case
    through the plain stack, as the ranks run it): metrics and the whole
    state's trees."""
    cfg = port_cfg(jax_cfg(name))
    if name == "fused":
        monkeypatch.setattr(WaveNet, "use_fused_stack",
                            lambda self, train, x, c, g: bool(train))
    trainer = WaveNetTrainer(cfg, device="cpu")
    state = trainer.init_state(model=convert.wavenet_from_flax(
        cfg, weights(name), "cpu", trainable=True))
    gen = torch.Generator().manual_seed(0)
    metrics = []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, global_wn_batch(name), gen)
        metrics.append({k: float(v) for k, v in m.items()})
    _, terms = trainer.eval_step(state, global_wn_batch(name))
    return metrics, state, {k: float(v) for k, v in terms.items()}


def _model_groups_agree(results, name):
    """The processes of each model group end with the same results."""
    for d in range(DP):
        a, b = results[d * MP][name], results[d * MP + 1][name]
        assert a["metrics"] == b["metrics"]
        np.testing.assert_array_equal(a["y"], b["y"])
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
    return [results[d * MP][name] for d in range(DP)]


# ------------------------------------------------------------------ tests

def test_tp_layout_matches_jax_addressable_shards():
    """Each (d, m) of a (4, 2) mesh keeps what JAX's device at (d, m) holds:
    parameters, EMA and both Adam moments, after a step (moments not 0)."""
    name = "gin"
    cfg = port_cfg(jax_cfg(name))
    trainer = WaveNetTrainer(cfg, device="cpu")
    whole = trainer.init_state(model=convert.wavenet_from_flax(
        cfg, weights(name), "cpu", trainable=True))
    whole, _ = trainer.train_step(whole, global_wn_batch(name),
                                  torch.Generator().manual_seed(0))
    named = [p for p, _ in convert.wavenet_named_parameters(whole.model)]
    moment = lambda ms: {p: convert.wavenet_flax_array(p, t)
                         for p, t in zip(named, ms)}
    trees = dict(params=convert.wavenet_to_flax(whole.model),
                 ema=convert.wavenet_to_flax(whole.ema))
    jt = JaxTrainer(jax_cfg(name))
    jp = jax.tree_util.tree_map(jnp.asarray, trees["params"])
    mu, nu = moment(whole.opt.mu), moment(whole.opt.nu)

    def unflat(flat):
        tree = {}
        for p, a in flat.items():
            convert.tree_set(tree, p, jnp.asarray(a))
        return tree
    import optax
    opt = jax.tree_util.tree_map(
        lambda n: n._replace(mu=unflat(mu), nu=unflat(nu))
        if isinstance(n, optax.ScaleByAdamState) else n,
        jt.tx.init(jp), is_leaf=lambda n: isinstance(n,
                                                     optax.ScaleByAdamState))
    mesh = make_mesh(MeshConfig(data_parallelism=4, model_parallelism=2))
    with mesh:
        js = jax_shard(JaxState(step=jnp.zeros((), jnp.int32), params=jp,
                                ema_params=jax.tree_util.tree_map(
                                    jnp.asarray, trees["ema"]),
                                opt_state=opt), mesh)
    adam = [n for n in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
        if isinstance(n, optax.ScaleByAdamState)][0]
    jax_trees = dict(params=js.params, ema=js.ema_params, mu=adam.mu,
                     nu=adam.nu)
    pos = {dev.id: divmod(i, 2) for i, dev in enumerate(
        mesh.devices.reshape(-1))}
    split = 0
    for d in range(4):
        for m in range(2):
            st = copy.deepcopy(whole)
            partition.shard_wavenet_state(
                st, DataParallel(d, 4, torch.device("cpu"), None, m, 2))
            mine = dict(
                params=convert.wavenet_named_parameters(st.model),
                ema=convert.wavenet_named_parameters(st.ema),
                mu=list(zip(named, st.opt.mu)),
                nu=list(zip(named, st.opt.nu)))
            for part, pairs in mine.items():
                for path, t in pairs:
                    arr = convert.tree_get(jax_trees[part], path)
                    held = [s for s in arr.addressable_shards
                            if pos[s.device.id] == (d, m)]
                    assert len(held) == 1
                    mine_np = convert.wavenet_flax_array(path, t)
                    np.testing.assert_array_equal(
                        mine_np, np.asarray(held[0].data),
                        err_msg=f"{part} {path} at {(d, m)}")
                    split += mine_np.shape != arr.shape
    sharded = [p for p, ax in partition.wavenet_param_specs(
        whole.model).items() if ax is not None]
    assert len(sharded) == 11 * len(whole.model.residual_blocks)
    assert split == 4 * 2 * 4 * len(sharded)


def test_tp_forward_matches_jax(ranks):
    """The channel-split eval forward (train=False) of each data shard's
    rows, against JAX's unsharded `WaveNet.apply`; with global conditioning
    too."""
    spec, results = ranks()
    for name in ("loop", "gin"):
        got = np.concatenate([r["y"] for r in
                              _model_groups_agree(results, name)])
        y, _, _ = jax_run(name) if name == "gin" else _JAX_LOOP()
        np.testing.assert_allclose(got, y, atol=2e-5, rtol=1e-4,
                                   err_msg=name)


_jax_cache = {}


def _JAX_LOOP():
    if "loop" not in _jax_cache:
        _jax_cache["loop"] = jax_run("loop")
    return _jax_cache["loop"]


@pytest.mark.parametrize("name", ["loop", "fused", "gin"])
def test_tp_train_step_matches_jax(ranks, name, monkeypatch):
    """STEPS steps under the (2, 2) group: loss and the clipped global norm
    of each against JAX's unsharded step (the fused case runs JAX's
    unsharded layer loop, the same function); the weights against JAX's
    (loop, gin) or the port's one-process plain stack (fused); the gathered
    whole state (weights, EMA, moments) and the eval terms against the
    port's one-process step; the fused case launched the plain stack's
    forward and backward once a step, the others never."""
    spec, results = ranks()
    got = _model_groups_agree(results, name)
    _, jm, jparams = _JAX_LOOP() if name != "gin" else jax_run(name)
    if name == "fused":
        jparams = None
    metrics, state, terms = port_run(name, monkeypatch)
    want_calls = STEPS if name == "fused" else 0
    for r in results:
        assert r[name]["calls"] == {"fwd": want_calls, "bwd": want_calls}
    for i in range(STEPS):
        _close(got[0]["metrics"][i]["loss"], jm[i]["loss"], rtol=1e-5,
               atol=0, msg=f"{name} step {i} loss")
        _close(got[0]["metrics"][i]["grad_norm"], jm[i]["grad_norm"],
               rtol=1e-4, atol=0, msg=f"{name} step {i} grad_norm")
        for k, v in metrics[i].items():
            _close(got[0]["metrics"][i][k], v, rtol=1e-6, atol=0,
                   msg=f"{name} step {i} {k} (one process)")
    for k, v in terms.items():
        _close(got[0]["eval"][k], v, rtol=1e-6, atol=0, msg=f"eval {k}")
    whole = dict(params=W._flat(convert.wavenet_to_flax(state.model)),
                 ema=W._flat(convert.wavenet_to_flax(state.ema)))
    for part, tree in whole.items():
        assert got[0][part].keys() == tree.keys()
        for k, v in tree.items():
            _close(got[0][part][k], v, rtol=0, atol=ONE_PROCESS_ATOL,
                   msg=f"{name} {part} {k} (one process)")
            if part == "params" and jparams is not None:
                _close(got[0][part][k], jparams[k], rtol=PARAM_RTOL,
                       atol=PARAM_ATOL, msg=f"{name} {k} (JAX)")
    for i in range(len(state.opt.mu)):
        _close(got[0]["mu"][i], state.opt.mu[i].numpy(), rtol=0,
               atol=ONE_PROCESS_ATOL, msg=f"mu {i}")
        _close(got[0]["nu"][i], state.opt.nu[i].numpy(), rtol=1e-5,
               atol=1e-12, msg=f"nu {i}")
    # what each process stored is its slice of the gathered whole
    for r, res in enumerate(results):
        m = r % MP
        for path, t in res[name]["stored"].items():
            ax = partition.param_axis(path, t.ndim)
            full = got[0]["params"][path]
            want = full if ax is None else np.asarray(partition.local_block(
                torch.from_numpy(full), ax, m, MP))
            np.testing.assert_array_equal(t, want, err_msg=path)


def test_tp_data_dependent_init_gathers_to_one_process(ranks):
    """A fresh WaveNet under the group: the data-dependent init on the
    global batch, sharded, gathers to the one-process init."""
    spec, results = ranks()
    trainer = WaveNetTrainer(spec["ddi"]["cfg"], device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0),
                               global_wn_batch("loop"))
    want = W._flat(convert.wavenet_to_flax(state.model))
    for r in results:
        got = r["ddi"]["params"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            _close(got[k], v, rtol=1e-5, atol=1e-6, msg=k)


def test_tp_tacotron_step_matches_one_process(ranks):
    """Tacotron under the (2, 2) group: nothing of it is sharded over
    'model', so each model group steps on its data shard as the data-
    parallel trainer does, and two steps with dropout, zoneout and coins
    equal the one-process steps on the global batch."""
    spec, results = ranks()
    for d in range(DP):
        a, b = (results[d * MP + m]["taco_dropout"] for m in range(MP))
        assert a["metrics"] == b["metrics"]
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
    got = results[0]["taco_dropout"]
    metrics, params, stats, terms, grad_of = port_one_process(
        "taco_dropout", spec)
    for i, (mg, mw) in enumerate(zip(got["metrics"], metrics)):
        for k, v in mw.items():
            _close(mg[k], v, rtol=1e-6, atol=1e-7, msg=f"step {i} {k}")
    noise_atol = noise_bound("taco_dropout", spec, grad_of)
    for k, v in params.items():
        _close(got["params"][k], v, rtol=0,
               atol=noise_atol.get(k, 1e-6), msg=k)
    for r in results:
        assert not r["modules"], r["modules"]
