"""One rank of the data-parallel tests (tests/test_torch_parallel*.py).

`run(rank, world, port, spec_path, out_dir)` is what
`torch.multiprocessing.spawn` starts in each rank: it sets torchrun's env
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), starts the group
through `parallel.dist.maybe_initialize_distributed(backend="gloo",
device="cpu")`, runs each case the pickled spec names on the port alone
(this module imports neither JAX nor the JAX package) and pickles the
rank's results to <out_dir>/rank<r>.pkl for the parent, which holds them
against the JAX package and the port's one-process runs.
"""

import os
import pickle
import sys
import traceback

import numpy as np
import torch


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        out.update(_flat(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


def _scalars(metrics):
    return {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}


def taco_steps(dp, s):
    """Steps of `TacotronTrainer(dp=)` on this rank's batch: each step's
    metrics, then the parameters and statistics (flax-named, flat)."""
    from tacotron2_tpu_torch import convert
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.train.tacotron_step import (MODEL_FLAGS,
                                                         TacotronTrainer)
    cfg, flags = s["cfg"], s["flags"]
    model = convert.load_tacotron(
        Tacotron(cfg, **{k: v for k, v in flags.items() if k in MODEL_FLAGS}),
        s["params"], s["stats"])
    trainer = TacotronTrainer(cfg, device="cpu", dp=dp, **flags)
    state = trainer.init_state(model=model)
    batch = s["batches"][dp.rank]
    metrics = []
    for i in range(s["steps"]):
        state, m = trainer.train_step(state, batch,
                                      torch.Generator().manual_seed(i))
        metrics.append(_scalars(m))
    params, stats = convert.tacotron_to_flax(state.model)
    _, terms = trainer.eval_step(state, batch,
                                 torch.Generator().manual_seed(9))
    return dict(metrics=metrics, params=_flat(params), stats=_flat(stats),
                eval=_scalars(terms))


def wavenet_steps(dp, s):
    """Steps of `WaveNetTrainer(dp=)` from the spec's weights (or from a
    fresh init on the rank's batch): metrics, parameters and EMA."""
    from tacotron2_tpu_torch import convert
    from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer
    cfg = s["cfg"]
    trainer = WaveNetTrainer(cfg, device="cpu", dp=dp)
    if s.get("params") is None:     # a fresh model, its data-dependent init
        state = trainer.init_state(torch.Generator().manual_seed(0),
                                   s["batches"][dp.rank])
    else:
        state = trainer.init_state(model=convert.wavenet_from_flax(
            cfg, s["params"], "cpu", trainable=True))
    gen = torch.Generator().manual_seed(0)
    metrics = []
    for _ in range(s["steps"]):
        state, m = trainer.train_step(state, s["batches"][dp.rank], gen)
        metrics.append(_scalars(m))
    return dict(metrics=metrics,
                params=_flat(convert.wavenet_to_flax(state.model)),
                ema=_flat(convert.wavenet_to_flax(state.ema)))


def sharded_sample(dp, s):
    """`wavenet_kernel.sharded_sample` of the global conditioning, for
    each set of weights."""
    from tacotron2_tpu_torch.models.wavenet.sampler import \
        extract_sampler_params
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    c_up = torch.from_numpy(s["c_up"])
    return {name: wk.sharded_sample(
        extract_sampler_params(params, s["cfg"], "cpu"), s["cfg"], c_up,
        s["seed"], dp).numpy() for name, params in s["params"].items()}


def sharded_call(dp, s):
    """`TextToWavProgram.sharded_call` of the global batch, twice (the
    call counter's move)."""
    from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
    prog = TextToWavProgram(s["cfg"], s["tparams"], s["tstats"],
                            s["wparams"], batch=s["batch"], steps=s["steps"],
                            t_in=s["t_in"], t_ref=s["t_ref"], device="cpu",
                            seed=s["seed"])
    return [[o.numpy() for o in prog.sharded_call(dp, *s["inputs"])]
            for _ in range(2)]


def cli_train(dp, s):
    """`cli train` with the spec's arguments under the group, on the CPU;
    each rank gets its own base directory."""
    from tacotron2_tpu_torch import cli
    cli.get_config = lambda *a, **k: s["cfg"]
    return cli.main(["train", *s["argv"], "--base-dir",
                     s["base_dirs"][dp.rank], "--device", "cpu",
                     "--dist-backend", "gloo"])


CASES = dict(taco_steps=taco_steps, wavenet_steps=wavenet_steps,
             sharded_sample=sharded_sample, sharded_call=sharded_call,
             cli_train=cli_train)


def run(rank, world, port, spec_path, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(2)
    from tacotron2_tpu_torch.parallel import dist
    dp = dist.maybe_initialize_distributed(backend="gloo", device="cpu",
                                           timeout_s=300)
    assert dp is not None and (dp.rank, dp.world) == (rank, world)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    results = {}
    try:
        for name, case in spec["cases"]:
            results[name] = CASES[case](dp, spec[name])
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        dist.shutdown()
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "flax",
                                                       "tacotron2_tpu"))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(spec, out_dir, world=2, timeout_s=300.0):
    """Start `world` ranks on `spec` (pickled under out_dir) and return a
    function that waits for them and returns each rank's results; a rank
    that raises fails it, one that outlives `timeout_s` is killed."""
    import time

    import torch.multiprocessing as mp
    spec_path = os.path.join(out_dir, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    ctx = mp.spawn(run, args=(world, free_port(), spec_path, out_dir),
                   nprocs=world, join=False)
    deadline = time.time() + timeout_s

    def join():
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() >= deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"ranks still running after {timeout_s} s")
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    return join
