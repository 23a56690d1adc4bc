"""The port's data parallelism (`tacotron2_tpu_torch/parallel/`) in
Tacotron training, on the CPU: two gloo ranks, spawned once for the file
with torch.multiprocessing (`torch_parallel_worker.py`, which imports the
port alone), step on their rows of one global batch while this process
runs the JAX package and the port's one-process steps on the whole batch.

A data-parallel step is the step over the global batch, as the JAX
trainer's under a mesh is (tests/test_train_step.py:73-91 holds that mesh
step to JAX's one-device step). The global batch has four rows of unequal
lengths, so that each rank's own longest text, mel and references differ
from the other's (mask_decoder=False: the mel and stop means count the
padding, so the ranks must pad to the global batch's length). Each rank is
fed its rows padded to its own longest, as a feeder pads them.

Tolerances: against JAX those of tests/test_torch_train_step.py (loss
terms 1e-5 relative, 1e-6 absolute; grad_norm 1e-4; parameters after the
steps PARAM_ATOL; BatchNorm statistics 1e-5 / 1e-6), at dropout and
zoneout 0 (the packages' random draws differ). Against the port's
one-process step on the global batch with dropout, zoneout and scheduled
coins on, ONE_PROCESS_RTOL: the same function, the group's sums taken in
another order; the parameters within ONE_PROCESS_ATOL. A conv bias right
before train-mode BatchNorm has a gradient of rounding noise (zero in
exact arithmetic, |g| below NOISE_GRAD on the port's first step), which
Adam turns into steps of lr·g/(|g| + eps) in either run, each its own:
after n steps such a leaf is held to 2·n·lr·NOISE_GRAD/eps, as
tests/test_torch_train_variants.py holds it, in both comparisons. The
two ranks end every step with the same parameters bit for bit: no
broadcast keeps them so.
"""

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
from test_torch_train_step import (PARAM_ATOL, _close, cfgs,  # noqa: E402
                                   tiny_corpus)

from tacotron2_tpu.train.tacotron_step import TacotronTrainer as JaxTrainer
from tacotron2_tpu.train.tacotron_step import TrainState as JaxState
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.config import MeshConfig
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.parallel import dist
from tacotron2_tpu_torch.train.tacotron_step import (MODEL_FLAGS,
                                                     TacotronTrainer)

WORLD = 2
ONE_PROCESS_RTOL = 1e-6
ONE_PROCESS_ATOL = 1e-6
NOISE_GRAD = 1e-7
FORK_FLAGS = dict(use_unpaired=True, adv_emb_disc=True)
# rows' lengths: rank 0 holds rows 0-1, rank 1 rows 2-3; every rank's
# longest of each padded axis differs from the other's
IN_LEN = np.array([10, 7, 6, 5])
OUT_LEN = np.array([8, 6, 12, 10])
REF_LEN = {"ref_mel_emt": np.array([9, 5, 7, 4]),
           "ref_mel_spk": np.array([6, 9, 5, 3]),
           "ref_mel_up_emt": np.array([4, 8, 9, 6]),
           "ref_mel_up_spk": np.array([7, 3, 5, 8])}


def global_batch(cfg, unpaired=False, seed=0):
    """Four rows padded to their longest as the feeder pads them (text 0,
    mels -max_abs_value, stop tokens 1 from the last frame), and each
    padded key's row lengths."""
    rng = np.random.default_rng(seed)
    B, M, pad = 4, cfg.audio.num_mels, -cfg.audio.max_abs_value
    T_in, T_out = IN_LEN.max(), OUT_LEN.max()

    def padded(T, lengths, draw, value):
        t = np.arange(T).reshape((1, T) + (1,) * (draw.ndim - 2))
        keep = t < lengths.reshape((B,) + (1,) * (draw.ndim - 1))
        return np.where(keep, draw, value)

    b = dict(
        inputs=padded(T_in, IN_LEN, rng.integers(2, 60, (B, T_in)),
                      0).astype(np.int32),
        input_lengths=IN_LEN.astype(np.int32),
        mel_targets=padded(T_out, OUT_LEN, rng.uniform(-4, 4, (B, T_out, M)),
                           pad).astype(np.float32),
        stop_token_targets=(np.arange(T_out)[None] >= OUT_LEN[:, None] - 1
                            ).astype(np.float32),
        targets_lengths=OUT_LEN.astype(np.int32),
        emt_labels=rng.integers(0, 4, B).astype(np.int32),
        spk_labels=rng.integers(0, 3, B).astype(np.int32))
    lengths = dict(inputs=IN_LEN, mel_targets=OUT_LEN,
                   stop_token_targets=OUT_LEN)
    keys = list(REF_LEN)[:4 if unpaired else 2]
    for k in keys:
        T_ref = REF_LEN[k].max()
        b[k] = padded(T_ref, REF_LEN[k], rng.uniform(-4, 4, (B, T_ref, M)),
                      pad).astype(np.float32)
        lengths[k] = REF_LEN[k]
    if unpaired:
        b["emt_up_labels"] = rng.integers(0, 4, B).astype(np.int32)
        b["spk_up_labels"] = rng.integers(0, 3, B).astype(np.int32)
    return b, lengths


def rank_batches(b, lengths, r_out):
    """Each rank's rows, padded to its own longest (mels and stop tokens
    to a multiple of the reduction factor)."""
    n = len(b["inputs"]) // WORLD
    out = []
    for r in range(WORLD):
        rows = slice(r * n, (r + 1) * n)
        local = {k: v[rows] for k, v in b.items()}
        for k, L in lengths.items():
            m = int(L[rows].max())
            if k in ("mel_targets", "stop_token_targets"):
                m = -(-m // r_out) * r_out
            local[k] = local[k][:, :m]
        out.append(local)
    return out


def case_cfgs(**over):
    """(JAX config, port config) at the tiny widths, decode weights f32;
    `over` sets tacotron fields, and the train fields named tacotron_*, in
    both."""
    train = {k: over.pop(k) for k in list(over) if k.startswith("tacotron_")}
    jcfg, tcfg = cfgs(**over)
    if train:
        jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, **train))
        tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, **train))
    return jcfg, tcfg


def init_weights(tcfg, flags):
    m = convert.init_tacotron(tcfg, torch.Generator().manual_seed(0), "cpu",
                              **{k: v for k, v in flags.items()
                                 if k in MODEL_FLAGS})
    return convert.tacotron_to_flax(m)


CASES = {
    # name: (config overrides, trainer flags, steps)
    "taco": ({}, {}, 2),
    "taco_fork": ({}, FORK_FLAGS, 1),
    "taco_dropout": (dict(dropout_rate=0.5, zoneout_rate=0.1,
                          tacotron_teacher_forcing_ratio=0.5), {}, 2),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two ranks on every case; the fixture's value waits for
    them and returns (spec, [rank 0's results, rank 1's])."""
    root = tmp_path_factory.mktemp("dp")
    spec = {"cases": []}
    for name, (over, flags, steps) in CASES.items():
        _, tcfg = case_cfgs(**dict(over))
        params, stats = init_weights(tcfg, flags)
        b, lengths = global_batch(tcfg, unpaired="use_unpaired" in flags)
        spec[name] = dict(cfg=tcfg, flags=flags, params=params, stats=stats,
                          steps=steps, global_batch=b,
                          batches=rank_batches(
                              b, lengths, tcfg.tacotron.outputs_per_step))
        spec["cases"].append((name, "taco_steps"))
    corpus = tiny_corpus(str(root / "data"))
    _, tcfg = case_cfgs()
    tcfg = tcfg.replace(
        tacotron=dataclasses.replace(tcfg.tacotron, max_iters=6),
        audio=dataclasses.replace(tcfg.audio, griffin_lim_iters=2),
        train=dataclasses.replace(tcfg.train, eval_num_sentences=1,
                                  tacotron_batch_size=4,
                                  tacotron_test_size=0.25))
    spec["cli"] = dict(cfg=tcfg, argv=[
        "--model", "Tacotron", "--input-path", corpus, "--train-steps", "1",
        "--batch-size", "4", "--eval-interval", "1"],
        base_dirs=[str(root / f"base{r}") for r in range(WORLD)])
    spec["cases"].append(("cli", "cli_train"))
    join = W.launch(spec, str(root), WORLD, timeout_s=300)
    results = []

    def wait():
        if not results:
            results.extend(join())
        return spec, results
    yield wait
    wait()


# ------------------------------------------------------- the JAX side

def jax_steps(name, spec):
    """JAX `TacotronTrainer.train_step` (jitted) on the global batch, from
    the same weights: each step's metrics and the final state."""
    over, flags, steps = CASES[name]
    jcfg, _ = case_cfgs(**dict(over))
    s = spec[name]
    trainer = JaxTrainer(jcfg, **flags)
    params = jax.tree_util.tree_map(jnp.asarray, s["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, s["stats"])
    tx_main, tx_r, tx_n = trainer.ensure_tx(params)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=stats, opt_state_main=tx_main.init(params),
                     opt_state_refnet=tx_r.init(params) if tx_r else None,
                     opt_state_nat=tx_n.init(params) if tx_n else None)
    step = jax.jit(trainer.train_step)
    metrics = []
    for i in range(steps):
        state, m = step(state, s["global_batch"], jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, W._flat(jax.tree_util.tree_map(np.asarray, state.params)), \
        W._flat(jax.tree_util.tree_map(np.asarray, state.batch_stats))


def port_one_process(name, spec):
    """The port's one-process trainer on the global batch, as the ranks'
    steps (the same generator seeds): metrics, parameters, statistics,
    the eval terms and the first step's gradients by flax path."""
    over, flags, steps = CASES[name]
    _, tcfg = case_cfgs(**dict(over))
    s = spec[name]
    model = convert.load_tacotron(
        Tacotron(tcfg, **{k: v for k, v in flags.items()
                          if k in MODEL_FLAGS}), s["params"], s["stats"])
    trainer = TacotronTrainer(tcfg, device="cpu", **flags)
    state = trainer.init_state(model=model)
    b = s["global_batch"]
    _, params, grads, _ = trainer.step_gradients(
        state, b, torch.Generator().manual_seed(0), targets=["loss"])
    grad_of = {convert.flax_path(n): float(g.abs().max()) for (n, _), g in
               zip(state.model.named_parameters(), grads["loss"])}
    state = trainer.init_state(model=convert.load_tacotron(
        Tacotron(tcfg, **{k: v for k, v in flags.items()
                          if k in MODEL_FLAGS}), s["params"], s["stats"]))
    metrics = []
    for i in range(steps):
        state, m = trainer.train_step(state, b,
                                      torch.Generator().manual_seed(i))
        metrics.append({k: float(v) for k, v in m.items()})
    params, stats = convert.tacotron_to_flax(state.model)
    _, terms = trainer.eval_step(state, b, torch.Generator().manual_seed(9))
    return (metrics, W._flat(params), W._flat(stats),
            {k: float(v) for k, v in terms.items()}, grad_of)


def noise_bound(name, spec, grad_of=None):
    """{flax path: atol} of the leaves whose first gradient on the port is
    rounding noise (each a bias, of a conv before BatchNorm)."""
    if grad_of is None:
        grad_of = port_one_process(name, spec)[-1]
    _, tcfg = case_cfgs(**dict(CASES[name][0]))
    t = tcfg.train
    atol = (2 * CASES[name][2] * t.tacotron_initial_learning_rate
            * NOISE_GRAD / t.tacotron_adam_epsilon)
    out = {k: atol for k, g in grad_of.items() if g < NOISE_GRAD}
    assert all(k.endswith("bias") for k in out), out
    return out


def _ranks_agree(results, name):
    r0, r1 = (r[name] for r in results)
    assert r0["metrics"] == r1["metrics"]
    for part in ("params", "stats"):
        assert r0[part].keys() == r1[part].keys()
        for k in r0[part]:
            assert np.array_equal(r0[part][k], r1[part][k]), (part, k)
    return r0


@pytest.mark.parametrize("name", ["taco", "taco_fork"])
def test_dp_tacotron_step_matches_jax(ranks, name):
    """World 2, rows of unequal lengths: every loss term and grad_norm of
    each step, then every parameter and statistic, against the JAX step on
    the global batch; "taco_fork" with the unpaired pass and the
    adversarial heads."""
    spec, results = ranks()
    got = _ranks_agree(results, name)
    want, params, stats = jax_steps(name, spec)
    noise_atol = noise_bound(name, spec)
    for i, (mg, mw) in enumerate(zip(got["metrics"], want)):
        for k, v in mw.items():
            if k not in ("grad_norm", "teacher_forcing_ratio"):
                _close(mg[k], v, msg=f"step {i} {k}")
        _close(mg["grad_norm"], mw["grad_norm"], rtol=1e-4,
               msg=f"step {i} grad_norm")
    assert got["params"].keys() == params.keys()
    for k, v in params.items():
        _close(got["params"][k], v, rtol=0,
               atol=noise_atol.get(k, PARAM_ATOL), msg=k)
    for k, v in stats.items():
        _close(got["stats"][k], v, rtol=1e-5, atol=1e-6, msg=k)


def test_dp_tacotron_step_with_dropout_matches_one_process(ranks):
    """Dropout 0.5, zoneout 0.1 and coins at ratio 0.5: the masks of each
    rank are its rows of the one-process step's draw, so two data-parallel
    steps (and an eval step) equal the port's one-process steps on the
    global batch."""
    spec, results = ranks()
    got = _ranks_agree(results, "taco_dropout")
    metrics, params, stats, terms, grad_of = port_one_process(
        "taco_dropout", spec)
    assert metrics[0]["teacher_forcing_ratio"] == 0.5
    for i, (mg, mw) in enumerate(zip(got["metrics"], metrics)):
        assert mg.keys() == mw.keys()
        for k, v in mw.items():
            _close(mg[k], v, rtol=ONE_PROCESS_RTOL, atol=1e-7,
                   msg=f"step {i} {k}")
    for k, v in terms.items():
        _close(got["eval"][k], v, rtol=ONE_PROCESS_RTOL, atol=1e-7,
               msg=f"eval {k}")
    noise_atol = noise_bound("taco_dropout", spec, grad_of)
    for k, v in params.items():
        _close(got["params"][k], v, rtol=0,
               atol=noise_atol.get(k, ONE_PROCESS_ATOL), msg=k)
    for k, v in stats.items():
        _close(got["stats"][k], v, rtol=ONE_PROCESS_RTOL, atol=1e-7, msg=k)


def test_cli_train_two_ranks(ranks):
    """`cli train --model Tacotron` under the group, one step with the
    eval: rank 0 writes the checkpoint, the curve (with the held-out
    metrics of the whole test batch) and train.log; rank 1, given a base
    directory of its own, writes no file; each rank returns the same
    checkpoint directory name; the ranks imported nothing of JAX."""
    spec, results = ranks()
    base0, base1 = spec["cli"]["base_dirs"]
    ckpt = os.path.join(base0, "logs-Tacotron", "taco_pretrained")
    assert results[0]["cli"] == ckpt
    assert results[1]["cli"] == os.path.join(base1, "logs-Tacotron",
                                             "taco_pretrained")
    assert os.listdir(ckpt) == ["ckpt-1.msgpack"]
    import json
    rec = [json.loads(x) for x in open(os.path.join(
        base0, "logs-Tacotron", "taco_curve.jsonl"))]
    assert [r["step"] for r in rec] == [1]
    assert np.isfinite(rec[0]["loss"]) and "held_mel_mae" in rec[0]
    assert os.path.exists(os.path.join(base0, "logs-Tacotron", "train.log"))
    files1 = [os.path.join(d, f) for d, _, fs in os.walk(base1) for f in fs]
    assert files1 == [], files1
    for r in results:
        assert r["modules"] == []


# ------------------------------------------ the group's start, in process

ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT")


def test_maybe_initialize_distributed_env_paths(monkeypatch):
    """The JAX function's single code path (tests/test_model_parallel.py:
    156): without the env a no-op (as JAX's is without its own); with
    torchrun's env a world-1 gloo group on the CPU, returned again by a
    second call; two ranks on one card under nccl raise before any group
    starts (ranks on their own cards, or sharing one under gloo, do not);
    model parallelism raises NotImplementedError."""
    from tacotron2_tpu.parallel import mesh as jax_mesh
    for k in ENV_KEYS + ("JAX_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES",
                         "MEGASCALE_COORDINATOR_ADDRESS", "CLOUD_TPU_TASK_ID",
                         "TPU_WORKER_ID"):
        monkeypatch.delenv(k, raising=False)
    assert dist.maybe_initialize_distributed() is None
    assert dist.current() is None and dist.rank_world() == (0, 1)
    assert jax_mesh.maybe_initialize_distributed() is False

    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(W.free_port()))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        dist.maybe_initialize_distributed()
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        dist.maybe_initialize_distributed("nccl", "cuda:0")
    assert not torch.distributed.is_initialized()
    assert dist.rank_device("cuda", "gloo", 1, 2) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dist.rank_device("cuda", "nccl", 1, 2) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="gloo"):
        dist.maybe_initialize_distributed("nccl", "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dist.maybe_initialize_distributed(
            "gloo", "cpu", MeshConfig(model_parallelism=2))
    with pytest.raises(ValueError, match="data_parallelism"):
        dist.check_mesh(MeshConfig(data_parallelism=4), 2)

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    try:
        dp = dist.maybe_initialize_distributed(device="cpu")
        assert dp == dist.DataParallel(0, 1, torch.device("cpu"))
        assert torch.distributed.get_backend() == "gloo"
        assert dist.maybe_initialize_distributed() is dp
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(dist.all_gather_rows(x, dp), x)
    finally:
        dist.shutdown()
    assert dist.current() is None and not torch.distributed.is_initialized()


def test_shard_batch_and_host_shard_indices():
    """shard_batch takes rank r's block of rows and asserts B % world ==
    0, as the JAX mesh's P('data') sharding; host_shard_indices is the
    stride shard of JAX mesh.py:102; without a group a host loop keeps
    its batch and device."""
    dp = dist.DataParallel(1, 2, torch.device("cpu"))
    b = {"x": np.arange(8).reshape(4, 2), "n": 3}
    assert dist.shard_batch(b, dp)["x"].tolist() == [[4, 5], [6, 7]]
    assert dist.shard_batch(b, dp)["n"] == 3
    with pytest.raises(AssertionError, match="divisible"):
        dist.shard_batch(np.zeros((3, 2)), dp)
    assert dist.host_shard_indices(5).tolist() == [0, 1, 2, 3, 4]
    assert dist.host_rows(6, "cpu") == (None, "cpu", 6)


# --------------------------------------------------------------- feeders

@pytest.mark.parametrize("kind", ["tacotron", "wavenet"])
def test_feeder_shards_match_jax(kind, tmp_path, monkeypatch):
    """Each rank's feeder (rank_world patched to (r, 2)) against the JAX
    feeder with jax.process_count / process_index patched to (2, r): the
    same train shard, test split and first batches; the shards disjoint,
    together the whole train split; the shuffle streams decorrelated."""
    from tacotron2_tpu.data import feeder as jax_feeder_mod
    from tacotron2_tpu.data import wavenet_feeder as jax_wn_mod
    from tacotron2_tpu_torch.data import feeder as feeder_mod
    from tacotron2_tpu_torch.data import wavenet_feeder as wn_mod
    if kind == "tacotron":
        from test_torch_train_step import feeder_cfgs
        path = tiny_corpus(str(tmp_path))
        jcfg, tcfg = feeder_cfgs()
        kw = dict(batches_per_group=2, pad_text_multiple=4,
                  pad_mel_multiple=8, seed=3)
        make_j = lambda: jax_feeder_mod.TacotronFeeder(jcfg, path, **kw)
        make_t = lambda: feeder_mod.TacotronFeeder(tcfg, path, **kw)
        port_mod, n = feeder_mod, 2
    else:
        from test_torch_wavenet_train import loop_cfg, port_cfg, wn_corpus
        from test_wavenet import tiny_wn_config
        path = wn_corpus(str(tmp_path))
        jcfg = loop_cfg(tiny_wn_config())
        tcfg = port_cfg(jcfg)
        kw = dict(gta=False, batches_per_group=2, seed=5)
        make_j = lambda: jax_wn_mod.WaveNetFeeder(jcfg, path, **kw)
        make_t = lambda: wn_mod.WaveNetFeeder(tcfg, path, **kw)
        port_mod, n = wn_mod, 2
    whole = make_t().train_meta
    shards = []
    for r in range(WORLD):
        monkeypatch.setattr(jax, "process_count", lambda: WORLD)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(port_mod, "rank_world", lambda r=r: (r, WORLD))
        fj, ft = make_j(), make_t()
        assert ft.train_meta == fj.train_meta
        assert ft.test_meta == fj.test_meta
        gj, gt = fj.train_batches(n), ft.train_batches(n)
        for _ in range(2):
            bj, bt = next(gj), next(gt)
            assert set(bt) == set(bj)
            for k in bj:
                np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
        shards.append(ft)
    rows = lambda f: {"|".join(m) for m in f.train_meta}
    assert not rows(shards[0]) & rows(shards[1])
    assert rows(shards[0]) | rows(shards[1]) == {"|".join(m) for m in whole}
    assert shards[0].test_meta == shards[1].test_meta
    draws = [f.rng.permutation(64).tolist() for f in shards]
    assert draws[0] != draws[1]
