"""The port's data parallelism in WaveNet training, in the sharded sampler
and in the sharded serving program, on the CPU: two gloo ranks, spawned
once for the file (`torch_parallel_worker.py`, the port alone), against
the JAX package and the port's one-process runs in this process.

- `WaveNetTrainer(dp=)` against the JAX `WaveNetTrainer.train_step` on the
  global batch (rows of unequal lengths, each rank fed its rows padded to
  its own longest), at dropout 0: JAX's stack kernels draw their dropout
  per shard (`seed + axis_index`, models/wavenet/model.py:148-150), so
  JAX's sharded and one-device steps agree only there. Tolerances of
  tests/test_torch_wavenet_train.py: loss 1e-5 relative, grad_norm 1e-4,
  parameters and EMA within PARAM_ATOL.
- `wavenet_kernel.sharded_sample` with the noise suppressed (the Gaussian
  log-scale pinned to -30) against the JAX sampler on the same rows, at
  JAX's own tolerances (tests/test_model_parallel.py:113: 2e-4 absolute,
  1e-3 relative); with the noise on, rank r's rows against the
  one-process sampler at seed + r·9973 (JAX wavenet_kernel.py:671), the
  same computation: SAME_RTOL.
- `TextToWavProgram.sharded_call` against JAX `sharded_call` on a
  2-device CPU mesh, noise suppressed and dropout 0, at JAX's tolerances
  (tests/test_pipeline_program.py:195: wav lengths equal, mel 1e-5,
  samples 1e-4 absolute / 1e-3 relative); with prenet dropout and the
  noise on, each rank's rows against the one-process program whose call
  is seeded as JAX seeds shard r, two calls in a row: SAME_RTOL.
"""

import dataclasses
import inspect
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_worker as W  # noqa: E402
from test_torch_wavenet_train import (PARAM_ATOL, loop_cfg,  # noqa: E402
                                      port_cfg, wn_corpus)
from test_wavenet import tiny_wn_config  # noqa: E402
from torch_port_helpers import MELS, inputs, small_cfg  # noqa: E402

from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.config import Config as TorchConfig
from tacotron2_tpu_torch.models.wavenet.distributions import draw_noise
from tacotron2_tpu_torch.models.wavenet.sampler import extract_sampler_params
from tacotron2_tpu_torch.ops import wavenet_kernel as wk
from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer

WORLD = 2
SAME_RTOL = 1e-5
HOP = 4
WN_LEN = np.array([24, 20, 16, 12])    # samples; rank 0 rows 0-1, 1 rows 2-3
SAMPLE_SEED = 5
PROG = dict(batch=2, steps=6, t_in=24, t_ref=16, seed=11)


def wavenet_batch(tcfg, seed=0):
    """The global batch, padded as the feeder pads it (x and y 0, c the
    rescaled mel pad past each row's frames), and each rank's rows padded
    to its own longest."""
    rng = np.random.default_rng(seed)
    B, T = len(WN_LEN), WN_LEN.max()
    pad_c = WaveNetTrainer(tcfg, device="cpu").pad_values()["c"]
    keep = np.arange(T)[None] < WN_LEN[:, None]
    x = np.where(keep, rng.uniform(-0.5, 0.5, (B, T)), 0.0).astype(np.float32)
    frames = np.arange(T // HOP)[None, :, None] < (WN_LEN // HOP)[:, None,
                                                                  None]
    c = np.where(frames, rng.uniform(0, 1, (B, T // HOP,
                                            tcfg.wavenet.cin_channels)),
                 pad_c).astype(np.float32)
    b = dict(x=x[..., None], y=x.copy(), c=c,
             input_lengths=WN_LEN.astype(np.int32))
    n = B // WORLD
    ranks = []
    for r in range(WORLD):
        rows = slice(r * n, (r + 1) * n)
        m = int(WN_LEN[rows].max())
        ranks.append(dict(x=b["x"][rows, :m], y=b["y"][rows, :m],
                          c=b["c"][rows, :m // HOP],
                          input_lengths=b["input_lengths"][rows]))
    return b, ranks


def quiet(wparams):
    """The sampler's log-scale channel pinned to -30: sample = mean
    (tests/test_pipeline_program.py)."""
    out = {k: dict(v) if isinstance(v, dict) else v
           for k, v in wparams.items()}
    fc2 = {k: np.array(v) for k, v in
           wparams["final_convolution_2"]["Dense_0"].items()}
    fc2["bias"][1] = -30.0
    fc2["kernel"][:, 1] = 0.0
    out["final_convolution_2"] = {"Dense_0": fc2}
    return out


def program_weights(tcfg):
    """Port-initialised Tacotron (stop projection pinned off, so every
    stream runs all steps) and WaveNet trees."""
    m = convert.init_tacotron(tcfg, torch.Generator().manual_seed(0), "cpu")
    tparams, stats = convert.tacotron_to_flax(m)
    tparams["decoder"]["cell"]["stop_projection"]["Dense_0"]["bias"][:] = \
        -30.0
    w = convert.init_wavenet(tcfg, torch.Generator().manual_seed(1), "cpu",
                             global_conditioning=False)
    return tparams, stats, convert.wavenet_to_flax(w)


def global_inputs():
    ids, lengths, refs = inputs()
    g = lambda x: np.concatenate([x[:PROG["batch"]], x[PROG["batch"]:][::-1]])
    return g(ids), g(lengths), g(refs), g(refs[::-1])


def ddi_cfg(tcfg):
    """Weight normalization on, with its data-dependent init."""
    return tcfg.replace(wavenet=dataclasses.replace(
        tcfg.wavenet, weight_normalization=True, data_dependent_init=True))


def noisy_cfg():
    tcfg = small_cfg(TorchConfig)
    return tcfg.replace(tacotron=dataclasses.replace(tcfg.tacotron,
                                                     dropout_rate=0.5))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("dpw")
    jcfg = tiny_wn_config()
    tcfg = port_cfg(jcfg)
    w = convert.init_wavenet(tcfg, torch.Generator().manual_seed(0), "cpu",
                             global_conditioning=False)
    b, rank_b = wavenet_batch(tcfg)
    scfg = small_cfg(TorchConfig)
    tparams, stats, wparams = program_weights(scfg)
    rng = np.random.default_rng(3)
    c_up = rng.uniform(0, 1, (4, 32, MELS)).astype(np.float32)
    spec = dict(
        cases=[("wavenet", "wavenet_steps"), ("ddi", "wavenet_steps"),
               ("sample", "sharded_sample"),
               ("serve", "sharded_call"), ("serve_noisy", "sharded_call"),
               ("cli", "cli_train")],
        cli=dict(cfg=port_cfg(loop_cfg(tiny_wn_config())), argv=[
            "--model", "WaveNet", "--input-path",
            wn_corpus(str(root / "data")), "--no-gta", "--train-steps", "2",
            "--eval-interval", "2"],
            base_dirs=[str(root / f"base{r}") for r in range(WORLD)]),
        wavenet=dict(cfg=tcfg, params=convert.wavenet_to_flax(w), steps=2,
                     batches=rank_b, global_batch=b),
        ddi=dict(cfg=ddi_cfg(tcfg), params=None, steps=0, batches=rank_b,
                 global_batch=b),
        sample=dict(cfg=scfg, c_up=c_up, seed=SAMPLE_SEED,
                    params=dict(quiet=quiet(wparams), noisy=wparams)),
        serve=dict(cfg=scfg, tparams=tparams, tstats=stats,
                   wparams=quiet(wparams), inputs=global_inputs(), **PROG),
        serve_noisy=dict(cfg=noisy_cfg(), tparams=tparams, tstats=stats,
                         wparams=wparams, inputs=global_inputs(), **PROG))
    join = W.launch(spec, str(root), WORLD, timeout_s=300)
    results = []

    def wait():
        if not results:
            results.extend(join())
        return spec, results
    yield wait
    wait()


def test_dp_wavenet_step_matches_jax(ranks):
    """Two steps of WaveNetTrainer(dp=) at world 2 against JAX's jitted
    step on the global batch (the same weights): loss and grad_norm of
    each step, the parameters and the EMA after; both ranks bit for bit
    alike."""
    from tacotron2_tpu.train.wavenet_step import WaveNetTrainer as JaxTrainer
    from tacotron2_tpu.train.wavenet_step import WaveNetTrainState
    spec, results = ranks()
    r0, r1 = (r["wavenet"] for r in results)
    assert r0["metrics"] == r1["metrics"]
    for part in ("params", "ema"):
        for k in r0[part]:
            assert np.array_equal(r0[part][k], r1[part][k]), (part, k)
    s = spec["wavenet"]
    jt = JaxTrainer(tiny_wn_config())
    params = jax.tree_util.tree_map(jnp.asarray, s["params"])
    js = WaveNetTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           ema_params=params, opt_state=jt.tx.init(params))
    step = jax.jit(jt.train_step)
    for i in range(s["steps"]):
        js, mj = step(js, s["global_batch"], jax.random.PRNGKey(i))
        np.testing.assert_allclose(r0["metrics"][i]["loss"],
                                   float(mj["loss"]), rtol=1e-5)
        np.testing.assert_allclose(r0["metrics"][i]["grad_norm"],
                                   float(mj["grad_norm"]), rtol=1e-4)
    for part, tree in (("params", js.params), ("ema", js.ema_params)):
        want = W._flat(jax.tree_util.tree_map(np.asarray, tree))
        assert want.keys() == r0[part].keys()
        for k, v in want.items():
            np.testing.assert_allclose(r0[part][k], v, rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)


def test_dp_data_dependent_init_is_the_global_batchs(ranks):
    """A fresh weight-normed WaveNet under the group: the data-dependent
    init runs on the ranks' first batches gathered, so both ranks start
    from the one-process init on the global batch (the same seed; the
    statistics' sums in another order: SAME_RTOL of each tensor's
    largest value)."""
    spec, results = ranks()
    r0, r1 = (r["ddi"] for r in results)
    for k in r0["params"]:
        assert np.array_equal(r0["params"][k], r1["params"][k]), k
    s = spec["ddi"]
    want = W._flat(convert.wavenet_to_flax(WaveNetTrainer(
        s["cfg"], device="cpu").init_state(
            torch.Generator().manual_seed(0), s["global_batch"]).model))
    assert want.keys() == r0["params"].keys()
    for k, v in want.items():
        np.testing.assert_allclose(r0["params"][k], v, rtol=0,
                                   atol=SAME_RTOL * np.abs(v).max(),
                                   err_msg=k)


def test_sharded_sample_matches_jax_and_rank_seeds(ranks):
    """Noise suppressed: the gathered rows against the JAX sampler
    (`fused_incremental_sample`, interpret mode) on the same rows. Noise
    on: rank r's rows equal the one-process sampler's at seed + r·9973,
    and the ranks' streams differ from one seed's."""
    from tacotron2_tpu.ops.wavenet_kernel import fused_incremental_sample
    spec, results = ranks()
    s = spec["sample"]
    got = [r["sample"] for r in results]
    for name in ("quiet", "noisy"):
        np.testing.assert_array_equal(got[0][name], got[1][name])
    jcfg = small_cfg()
    want = fused_incremental_sample(
        jax.tree_util.tree_map(jnp.asarray, s["params"]["quiet"]), jcfg,
        jnp.asarray(s["c_up"]), seed=SAMPLE_SEED, chunk=16, interpret=True)
    assert got[0]["quiet"].shape == (4, 32)
    np.testing.assert_allclose(got[0]["quiet"], np.asarray(want), atol=2e-4,
                               rtol=1e-3)
    cfg = s["cfg"]
    sp = extract_sampler_params(s["params"]["noisy"], cfg, "cpu")
    c_up = torch.from_numpy(s["c_up"])
    n = 4 // WORLD
    for r in range(WORLD):
        rows = slice(r * n, (r + 1) * n)
        gen = torch.Generator().manual_seed(
            SAMPLE_SEED + r * wk.SHARD_SEED_STRIDE)
        one = wk.sample(sp, cfg, c_up[rows].contiguous(),
                        draw_noise(cfg, n, 32, gen, "cpu")).numpy()
        np.testing.assert_allclose(got[0]["noisy"][rows], one,
                                   rtol=SAME_RTOL, atol=1e-6)
    other = wk.sample(sp, cfg, c_up[n:].contiguous(), draw_noise(
        cfg, n, 32, torch.Generator().manual_seed(SAMPLE_SEED), "cpu"))
    assert np.abs(got[0]["noisy"][n:] - other.numpy()).max() > 1e-3


def test_sharded_call_matches_jax_and_rank_seeds(ranks):
    """The program's sharded call against JAX `sharded_call` on a 2-device
    mesh (noise suppressed, dropout 0); with prenet dropout and noise on,
    each rank's rows of two calls in a row against the one-process
    program's call seeded as shard r's."""
    from jax.sharding import Mesh

    from tacotron2_tpu.synth.pipeline import TextToWavProgram as JaxProgram
    spec, results = ranks()
    for r in results:
        for call_a, call_b in zip(r["serve"], results[0]["serve"]):
            for a, b in zip(call_a, call_b):
                np.testing.assert_array_equal(a, b)
    s = spec["serve"]
    got = results[0]["serve"][0]
    prog = JaxProgram(small_cfg(), s["tparams"], s["tstats"], s["wparams"],
                      batch=s["batch"], steps=s["steps"], t_in=s["t_in"],
                      t_ref=s["t_ref"], taco_chunk=2, upsample_chunk=2,
                      interpret=True)
    mesh = Mesh(np.array(jax.devices("cpu")[:WORLD]).reshape(WORLD),
                ("data",))
    samples, wav_len, mel, _, _ = prog.sharded_call(mesh, *s["inputs"])
    np.testing.assert_array_equal(got[1], np.asarray(wav_len))
    np.testing.assert_allclose(got[2], np.asarray(mel), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got[0], np.asarray(samples), atol=1e-4,
                               rtol=1e-3)

    s = spec["serve_noisy"]
    n = s["batch"]
    for call in range(2):
        for r in range(WORLD):
            # the one-process program's next call seeds seed + 1; shard
            # r of the sharded call k seeds seed + k·world + r
            one = TextToWavProgram(
                s["cfg"], s["tparams"], s["tstats"], s["wparams"], batch=n,
                steps=s["steps"], t_in=s["t_in"], t_ref=s["t_ref"],
                device="cpu", seed=s["seed"] + (call + 1) * WORLD + r - 1)
            rows = slice(r * n, (r + 1) * n)
            want = one(*(x[rows] for x in s["inputs"]))
            for k, (g, w) in enumerate(zip(results[0]["serve_noisy"][call],
                                           want)):
                np.testing.assert_allclose(g[rows], w.numpy(),
                                           rtol=SAME_RTOL, atol=1e-6,
                                           err_msg=f"call {call} rank {r} "
                                                   f"output {k}")
    first, second = results[0]["serve_noisy"]
    assert np.abs(first[2] - second[2]).max() > 1e-3   # dropout moved


def test_cli_train_wavenet_two_ranks(ranks):
    """`cli train --model WaveNet` under the group, 2 steps of the global
    batch of train.wavenet_batch_size rows (one a rank) with the
    data-dependent init on the ranks' first batches gathered and the eval
    at step 2: rank 0 writes the checkpoint, the curve with the held-out
    loss and the eval wav; rank 1, in a base directory of its own, writes
    no file."""
    import json
    spec, results = ranks()
    base0, base1 = spec["cli"]["base_dirs"]
    log0 = os.path.join(base0, "logs-WaveNet")
    assert results[0]["cli"] == os.path.join(log0, "wave_pretrained")
    assert os.listdir(results[0]["cli"]) == ["ckpt-2.msgpack"]
    rec = [json.loads(x) for x in open(os.path.join(
        log0, "wavenet_curve.jsonl"))]
    assert [r["step"] for r in rec] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rec)
    assert np.isfinite(rec[1]["eval_loss"])
    assert "step-2-pred.wav" in os.listdir(os.path.join(log0, "wave_eval"))
    files1 = [os.path.join(d, f) for d, _, fs in os.walk(base1) for f in fs]
    assert files1 == [], files1
    for r in results:
        assert r["modules"] == []


def test_reference_wavenet_train_builds_no_mesh():
    """A fault of the reference: JAX `wavenet_train` (train/
    wavenet_train.py:73) jits the step on the process's own batch and
    builds no mesh, while its feeder takes a per-process shard
    (data/wavenet_feeder.py:69-78): under several processes each steps
    alone with no gradient exchange. The Tacotron loop builds the mesh
    (train/tacotron_train.py:128); the port's WaveNet loop steps on the
    global batch as its Tacotron loop does
    (test_dp_wavenet_step_matches_jax, test_cli_train_wavenet_two_ranks)."""
    from tacotron2_tpu.train import tacotron_train as jax_taco
    from tacotron2_tpu.train import wavenet_train as jax_wn
    src = inspect.getsource(jax_wn)
    assert "jax.jit(trainer.train_step)" in src
    for name in ("make_mesh", "shard_batch"):
        assert name not in src and name in inspect.getsource(jax_taco), name
