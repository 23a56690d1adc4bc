"""The host loops' extras of the port (the summary writer, the profiler
window, the run log, the output-var dumps, the plots, `overfit`, the fixed
eval set) and `cli train` with the grafted discriminators, on the CPU.

Against the JAX package where it has the function: `_save_output_vars`
(the same files, values within 1e-5 of each file's scale), `overfit` (3
steps, an eval every 2: the same history steps and report keys, values
within 1e-4), `SummaryWriter` rows and `create_fixed_eval_set` (the same
file). Both start from the port's `init_tacotron` weights, at
tests/test_torch_train_step.py's settings
(dropout and zoneout 0, teacher-forcing ratio 1: neither package draws).
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train_step import (batch4, cfgs, feeder_cfgs,  # noqa: E402
                                   port_model, tiny_corpus)

# the modules the tests use, imported at collection (sources compile on
# import where bytecode is not cached: seconds for these)
from tacotron2_tpu.data.feeder import create_fixed_eval_set as jax_fixed
from tacotron2_tpu.eval.convergence import overfit as jax_overfit
from tacotron2_tpu.train.optim import make_tacotron_optimizer
from tacotron2_tpu.train.tacotron_step import TacotronTrainer as JaxTrainer
from tacotron2_tpu.train.tacotron_step import TrainState as JaxTrainState
from tacotron2_tpu.train.tacotron_train import _save_output_vars as jax_dump
from tacotron2_tpu.utils.summary import SummaryWriter as JaxWriter
from tacotron2_tpu_torch import cli, convert
from tacotron2_tpu_torch.data.feeder import create_fixed_eval_set
from tacotron2_tpu_torch.disc.train import load_pretrained_disc
from tacotron2_tpu_torch.eval.analyze import (confusion_matrix,
                                              plot_confusion_matrix,
                                              plot_embedding_clusters)
from tacotron2_tpu_torch.eval.convergence import overfit
from tacotron2_tpu_torch.train.checkpoint import CheckpointManager
from tacotron2_tpu_torch.train.tacotron_step import TacotronTrainer
from tacotron2_tpu_torch.train.tacotron_train import _save_output_vars
from tacotron2_tpu_torch.utils import infolog, plot, summary
from tacotron2_tpu_torch.utils.summary import ProfilerHook, SummaryWriter


@pytest.fixture(scope="module")
def jax_state():
    """The JAX trainer and a TrainState of the port's `init_tacotron`
    weights, built as the JAX `init_state` builds one from its init (its
    own flax init takes ~8 s to compile, ~25 s eagerly)."""
    jcfg, tcfg = cfgs()
    trainer = JaxTrainer(jcfg)
    params, stats = convert.tacotron_to_flax(convert.init_tacotron(
        tcfg, torch.Generator().manual_seed(0), "cpu"))
    tx = make_tacotron_optimizer(jcfg, params)
    trainer._tx = tx
    return trainer, JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state_main=tx[0].init(params), opt_state_refnet=None,
        opt_state_nat=None)


def test_save_output_vars_matches_jax(jax_state, tmp_path):
    trainer_j, state_j = jax_state
    _, tcfg = cfgs()
    trainer = TacotronTrainer(tcfg, device="cpu")
    state = trainer.init_state(model=port_model(state_j, tcfg))
    b = batch4()
    jax_dump(trainer_j, state_j, b, str(tmp_path / "j"), 1)
    _save_output_vars(trainer, state, b, str(tmp_path / "t"), 1)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert {"mels-1.csv", "stop-1.csv", "align-1.csv", "emb-1.csv",
            "inp_len-1.csv", "stop_targ-1.csv"} <= set(names)
    for n in names:
        want = np.loadtxt(tmp_path / "j" / n, delimiter=",", ndmin=2)
        got = np.loadtxt(tmp_path / "t" / n, delimiter=",", ndmin=2)
        assert got.shape == want.shape, n
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= 1e-5 * scale, n


@pytest.fixture(scope="module")
def jax_overfit_run(jax_state):
    """JAX `overfit` for 3 steps with an eval every 2 (steps 1, 2, 3), its
    `init_state` handing back the fixture's state (~12 s of tracing and
    compiling its train and eval steps on a cold cache)."""
    _, state_j = jax_state
    jcfg, _ = cfgs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTrainer, "init_state",
                   lambda self, key, batch: state_j)
        return jax_overfit(jcfg, batch4(), 3, seed=0, eval_every=2)


def test_overfit_matches_jax(jax_state, jax_overfit_run):
    """The port's `overfit` from the same weights: the history (step,
    loss, mel MAE, mean diagonality) and every report value within 1e-4;
    then an early stop once both bars are met, at the first eval."""
    _, state_j = jax_state
    rep_j, hist_j = jax_overfit_run
    _, tcfg = cfgs()
    b = batch4()
    rep_t, hist_t, state = overfit(tcfg, b, 3, seed=0, eval_every=2,
                                   device="cpu", return_state=True,
                                   model=port_model(state_j, tcfg))
    assert state.step == 3
    assert [h[0] for h in hist_t] == [h[0] for h in hist_j] == [1, 2, 3]
    np.testing.assert_allclose(np.asarray(hist_t), np.asarray(hist_j),
                               rtol=1e-4, atol=1e-4)
    assert set(rep_t) == set(rep_j)
    for k, v in rep_j.items():
        np.testing.assert_allclose(np.asarray(rep_t[k], np.float64),
                                   np.asarray(v, np.float64), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    rep, hist = overfit(tcfg, b, 5, eval_every=2, stop_diag=-2.0,
                        stop_mae=1e9, device="cpu",
                        model=port_model(state_j, tcfg))
    assert rep["steps"] == 1 and len(hist) == 1


def test_summary_writer_and_profiler_hook(tmp_path, monkeypatch):
    """metrics.jsonl rows as JAX's writer writes them; the profiler window
    (start, end] exports a Chrome trace of the steps in it, close() stops
    an open one; a hook without a start is inert."""
    monkeypatch.setattr(summary, "_tensorboard_writer", lambda d: None)
    rows = []
    for name, w in (
            ("j", JaxWriter(str(tmp_path / "j"), use_tensorboard=False)),
            ("t", SummaryWriter(str(tmp_path / "t")))):
        w.scalars(10, {"loss": 1.5, "skip": np.zeros(3), "n": 2},
                  prefix="tacotron/")
        w.scalars(20, {"loss": torch.tensor(1.25)}, prefix="eval/")
        w.close()
        rows.append([{k: v for k, v in json.loads(x).items() if k != "time"}
                     for x in open(tmp_path / name / "metrics.jsonl")])
    assert rows[0] == rows[1] == [
        {"step": 10, "tacotron/loss": 1.5, "tacotron/n": 2.0},
        {"step": 20, "eval/loss": 1.25}]

    hook = ProfilerHook(str(tmp_path / "p"), 1, 3)
    x = torch.randn(64, 64)
    for step in range(1, 5):
        x = torch.tanh(x @ x)
        hook.step(step)
    trace = json.load(open(hook.trace_path))
    assert hook.trace_path.endswith(os.path.join("profile", "trace-1.json"))
    assert any("aten::mm" in e.get("name", "") for e in
               trace["traceEvents"])
    open_hook = ProfilerHook(str(tmp_path / "q"), 2)
    assert open_hook.end_step == 7
    open_hook.step(2)
    torch.tanh(x @ x)
    open_hook.close()
    assert os.path.exists(open_hook.trace_path) and open_hook._prof is None
    inert = ProfilerHook(str(tmp_path / "r"))
    inert.step(5)
    inert.close()
    assert inert.trace_path is None


def test_infolog_header_lines_and_webhook(tmp_path, monkeypatch, capsys):
    """train.log's header and timestamped lines; only slack=True lines
    reach the webhook, and only with a URL (urlopen stubbed here)."""
    import re
    import time
    import urllib.request

    posted = []
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda req, timeout=None: posted.append(req))
    path = str(tmp_path / "train.log")
    infolog.init(path, "Tacotron")
    infolog.log("plain")
    infolog.log("milestone", slack=True)
    infolog.init(path, "Tacotron", "http://localhost:9/hook")
    infolog.log("quiet")
    infolog.log("done", slack=True)
    for _ in range(100):
        if posted:
            break
        time.sleep(0.01)
    infolog._close_logfile()
    lines = open(path).read().split("\n")
    assert lines[1:4] == ["-" * 65, "Starting new Tacotron training run",
                          "-" * 65]
    stamped = [x for x in lines if x.startswith("[")]
    assert len(stamped) == 4 and all(re.match(
        r"\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\.\d{3}\] ", x) for x in stamped)
    assert len(posted) == 1
    assert json.loads(posted[0].data) == {"text": "Tacotron: done"}
    assert "[tacotron2_tpu_torch] plain" in capsys.readouterr().out


def test_plots_written_and_skipped(tmp_path, monkeypatch, capsys):
    """Each plot writes a PNG where matplotlib imports; with its import
    blocked each returns without writing and logs one line."""
    rng = np.random.default_rng(0)
    cm = confusion_matrix([0, 1, 2, 1], [0, 2, 2, 1], 3)
    np.testing.assert_array_equal(cm, [[1, 0, 0], [0, 1, 1], [0, 0, 1]])
    calls = {
        "align": lambda p: plot.plot_alignment(rng.random((6, 9)), p,
                                               title="a b c d e f g"),
        "mel": lambda p: plot.plot_spectrogram(
            rng.random((9, 20)), p, target_spectrogram=rng.random((9, 20))),
        "wave": lambda p: plot.waveplot(p, rng.random(50), rng.random(50),
                                        16000),
        "cm": lambda p: plot_confusion_matrix(cm, p),
        "emb": lambda p: plot_embedding_clusters(rng.random((8, 4)),
                                                 [0, 1] * 4, p),
    }
    for name, call in calls.items():
        call(str(tmp_path / f"{name}.png"))
        with open(tmp_path / f"{name}.png", "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", name
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    for name, call in calls.items():
        call(str(tmp_path / f"off-{name}.png"))
        assert not os.path.exists(tmp_path / f"off-{name}.png")
    out = capsys.readouterr().out.strip().split("\n")
    assert len(out) == len(calls)
    assert all("plot skipped, matplotlib is not installed" in x for x in out)


def test_export_style_embeddings_matches_jax(tmp_path):
    """export_style_embeddings_tsv writes JAX's files (classify_mels is in
    tests/test_torch_disc.py, on its discriminator)."""
    from tacotron2_tpu.eval.analyze import \
        export_style_embeddings_tsv as jax_export
    from tacotron2_tpu_torch.eval.analyze import export_style_embeddings_tsv
    emb = np.random.default_rng(0).normal(size=(4, 3))
    meta = [("a", 1), ("b", 2), ("c", 0), ("d", 1)]
    paths = [f(emb, meta, str(tmp_path / d)) for f, d in (
        (jax_export, "j"), (export_style_embeddings_tsv, "t"))]
    for a, b in zip(*paths):
        assert open(a).read() == open(b).read()


def test_fixed_eval_set_matches_jax(tmp_path):
    path = tiny_corpus(str(tmp_path))
    kw = dict(n_texts=3, n_refs_per_class=2, min_frames=12)
    jax_fixed(path, str(tmp_path / "j.txt"), **kw)
    create_fixed_eval_set(path, str(tmp_path / "t.txt"), **kw)
    want = open(tmp_path / "j.txt").read()
    assert open(tmp_path / "t.txt").read() == want
    assert len(want.strip().split("\n")) == 3 * 4 * 2


def test_cli_train_with_grafted_discriminators(tmp_path, monkeypatch):
    """`cli train --unpaired --pretrained-emb-disc --pretrained-disc-emt
    --pretrained-disc-spk --save-output-vars --profile-start 1
    --profile-end 2` for 3 steps on the CPU, from `disc-train`
    checkpoints: the grafted encoders and statistics equal the discs' and
    stay so, train.log, metrics.jsonl (summary every step), the step-1
    output_vars and the trace of step 2."""
    import dataclasses

    path = tiny_corpus(str(tmp_path / "data"))
    _, tcfg = feeder_cfgs()
    tcfg = tcfg.replace(train=dataclasses.replace(
        tcfg.train, summary_interval=1, checkpoint_interval=3))
    monkeypatch.setattr(cli, "get_config", lambda *a, **k: tcfg)
    discs = {}
    for kind in ("emt", "spk"):
        discs[kind] = cli.main([
            "disc-train", "--input-path", path, "--base-dir",
            str(tmp_path / "discs"), "--kind", kind, "--loss-type", "ce",
            "--train-steps", "2", "--n-per-class", "2", "--device", "cpu"])
    ckpt_dir = cli.main([
        "train", "--model", "Tacotron", "--input-path", path, "--base-dir",
        str(tmp_path), "--train-steps", "3", "--batch-size", "2",
        "--device", "cpu", "--eval-interval", "0", "--unpaired",
        "--pretrained-emb-disc", "--pretrained-disc-emt", discs["emt"],
        "--pretrained-disc-spk", discs["spk"], "--save-output-vars",
        "--profile-start", "1", "--profile-end", "2", "--verbose"])
    log_dir = os.path.dirname(ckpt_dir)
    tree = CheckpointManager(ckpt_dir).load()
    for kind, d in discs.items():
        want = load_pretrained_disc(d)
        scope = f"pretrained_ref_enc_{kind}"
        got_p = convert.tree_get(tree["params"], scope)
        got_s = convert.tree_get(tree["batch_stats"], scope)
        for (w, g) in ((want["params"], got_p), (want["batch_stats"], got_s)):
            for k, v in _leaves(w).items():
                np.testing.assert_array_equal(_leaves(g)[k], v, err_msg=k)
    log = open(os.path.join(log_dir, "train.log")).read()
    assert "Starting new Tacotron training run" in log
    assert "Imported pretrained emt discriminator (msgpack)" in log
    assert "outputs_per_step" in log          # --verbose: the config
    rows = [json.loads(x) for x in open(os.path.join(log_dir,
                                                     "metrics.jsonl"))]
    assert sorted({r["step"] for r in rows}) == [1, 2, 3]
    assert any("tacotron/style_emb_loss_mel_out_up_emt" in r for r in rows)
    assert {"mels-1.csv", "inp-1.csv"} <= set(os.listdir(
        os.path.join(log_dir, "output_vars")))
    assert os.listdir(os.path.join(log_dir, "profile")) == ["trace-1.json"]


def _leaves(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v)
    return out
