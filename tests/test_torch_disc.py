"""The port's style discriminators (`tacotron2_tpu_torch/disc/`) against
the JAX package's, on the CPU.

At tests/test_tacotron_model.py's tiny configuration (20 mels, reference
filters (4, 4), depth 8) with numpy inputs from seeds, and the JAX
modules' PRNGKey(0) init handed to the port through `convert.load_disc`:
the models' train and eval forwards and updated BatchNorm statistics
(1e-5 of each output's scale), the GE2E similarity and losses and the CE
loss (1e-6), the feeders' first batches (exactly), 3 steps of
`disc_train` and 4 of `emt_disc_train` (the same rows read, the val
split's included; every parameter within 1e-5 of max(1, its leaf's
scale), 1% of one Adam step at lr 1e-3, and every statistic within 1e-5
of its scale, but for the elements Adam moves on rounding noise, below),
the disc checkpoint's graft into a Tacotron against JAX
`import_pretrained_subtree`, `disc_test` (the same accuracy, confusion
matrix and CSV), the TI-SV preprocessing (1e-5) and `load_wav`, and each
new `cli` sub-command with `--device cpu`.
"""

import dataclasses
import os
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_tacotron_model import tiny_config  # noqa: E402

# the modules the tests use, imported at collection (sources compile on
# import where bytecode is not cached: seconds for orbax and scipy)
from tacotron2_tpu.cli import build_parser as jax_parser  # noqa: E402
from tacotron2_tpu.data import audio as jaudio  # noqa: E402
from tacotron2_tpu.disc import data_preprocess as jdp  # noqa: E402
from tacotron2_tpu.disc import model as jdm  # noqa: E402
from tacotron2_tpu.disc import train as jdt  # noqa: E402
from tacotron2_tpu.train.checkpoint import CheckpointManager as JMgr  # noqa
from tacotron2_tpu.train.checkpoint import \
    import_pretrained_subtree  # noqa: E402
from tacotron2_tpu_torch import cli, convert  # noqa: E402
from tacotron2_tpu_torch.config import Config as TorchConfig  # noqa: E402
from tacotron2_tpu_torch.data import audio as taudio  # noqa: E402
from tacotron2_tpu_torch.disc import data_preprocess as tdp  # noqa: E402
from tacotron2_tpu_torch.disc import model as tdm  # noqa: E402
from tacotron2_tpu_torch.disc import train as tdt  # noqa: E402
from tacotron2_tpu_torch.train.checkpoint import \
    CheckpointManager  # noqa: E402
from tacotron2_tpu_torch.train.tacotron_train import \
    import_pretrained_disc  # noqa: E402

MELS = 20


def cfgs():
    """(JAX config, port config) at tiny_config's widths."""
    jcfg = tiny_config()
    base = TorchConfig()
    tcfg = base.replace(**{
        sec: dataclasses.replace(getattr(base, sec),
                                 **dataclasses.asdict(getattr(jcfg, sec)))
        for sec in ("tacotron", "gst", "audio", "train")})
    return jcfg, tcfg


def np_tree(tree):
    if hasattr(tree, "items"):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


def close_to_scale(got, want, rtol=1e-5, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rtol * scale, f"{msg}: {err:.3e} > {rtol} x {scale:.3e}"


def trees_close(got, want, rtol=1e-5, what=""):
    fg, fw = flat(got), flat(want)
    assert set(fg) == set(fw), (what, set(fg) ^ set(fw))
    for k in fw:
        close_to_scale(fg[k], fw[k], rtol, f"{what} {k}")


def models(kind, jcfg, tcfg):
    if kind == "emt_disc":
        return jdm.EmtDisc(config=jcfg, n_classes=4), tdm.EmtDisc(tcfg, 4)
    ce = kind == "ce"
    return (jdm.DiscriminatorModel(config=jcfg, output_classes=4,
                                   discriminator=ce),
            tdm.DiscriminatorModel(tcfg, 4, discriminator=ce))


@pytest.mark.parametrize("kind", ["ce", "ge2e", "emt_disc"])
def test_disc_models_match_flax(kind):
    """Train and eval forward (embedding, logits) and the train forward's
    updated statistics, from the flax init loaded into the port."""
    jcfg, tcfg = cfgs()
    jm, tm = models(kind, jcfg, tcfg)
    x = np.random.default_rng(1).uniform(-4, 4, (6, 24, MELS)).astype(
        np.float32)
    @jax.jit
    def run(x_):            # one compile: init, train and eval forwards
        v_ = jm.init(dict(params=jax.random.PRNGKey(0)), x_, train=True)
        train_out, upd_ = jm.apply(v_, x_, train=True,
                                   mutable=["batch_stats"])
        eval_out = jm.apply({"params": v_["params"],
                             "batch_stats": upd_["batch_stats"]}, x_,
                            train=False)
        return v_, train_out, upd_, eval_out

    v, (je, jl), upd, eval_out = run(jnp.asarray(x))
    v = {"params": np_tree(v["params"]),
         "batch_stats": np_tree(v["batch_stats"])}
    convert.load_disc(tm, v["params"], v["batch_stats"])
    p, s = convert.disc_to_flax(tm)
    trees_close(p, v["params"], 0, "round trip")
    te, tl = tm(torch.from_numpy(x), train=True)
    close_to_scale(te.detach(), je, msg="train emb")
    if jl is not None:
        close_to_scale(tl.detach(), jl, msg="train logits")
    else:
        assert tl is None
    trees_close(convert.disc_to_flax(tm)[1], np_tree(upd["batch_stats"]),
                what="batch_stats")
    je, jl = eval_out
    with torch.no_grad():
        te, tl = tm(torch.from_numpy(x), train=False)
    close_to_scale(te, je, msg="eval emb")
    if jl is not None:
        close_to_scale(tl, jl, msg="eval logits")


@pytest.mark.parametrize("N,M", [(3, 4), (4, 1)])
@pytest.mark.parametrize("loss_type", ["softmax", "contrast"])
def test_ge2e_and_ce_losses_match_jax(N, M, loss_type):
    rng = np.random.default_rng(N * 10 + M)
    emb = rng.normal(size=(N * M, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    w, b = np.float32([10.0]), np.float32([-5.0])
    Sj = jax.jit(lambda e, w_, b_: jdm.similarity_matrix(e, w_, b_, N, M))(
        jnp.asarray(emb), jnp.asarray(w), jnp.asarray(b))
    St = tdm.similarity_matrix(torch.from_numpy(emb), torch.from_numpy(w),
                               torch.from_numpy(b), N, M)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=1e-6,
                               atol=1e-6)
    lj = float(jax.jit(lambda S: jdm.ge2e_loss(S, N, M, loss_type))(Sj))
    lt = float(tdm.ge2e_loss(St, N, M, loss_type))
    np.testing.assert_allclose(lt, lj, rtol=1e-6, atol=1e-6)
    logits = rng.normal(size=(N * M, 5)).astype(np.float32)
    labels = rng.integers(0, 5, N * M).astype(np.int32)
    (cj, aj), (ct, at) = (jax.jit(lambda lg, lb: jdm.disc_ce_loss(
        lg, lb, 5))(jnp.asarray(logits), jnp.asarray(labels)),
                          tdm.disc_ce_loss(torch.from_numpy(logits),
                                           torch.from_numpy(labels), 5))
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-6)
    assert float(at) == float(aj)
    with pytest.raises(ValueError):
        tdm.ge2e_loss(St, N, M, "other")


def corpus(root, n=14, seed=0):
    """A train.txt over emt4 and vctk rows, emotions 0-3 and speakers 0-2
    (one emotion class of one row), mels of 10-44 frames, one of 600."""
    rng = np.random.default_rng(seed)
    rows = []
    for ds in ("emt4", "vctk"):
        os.makedirs(os.path.join(root, ds, "mels"), exist_ok=True)
    for i in range(n):
        ds = "emt4" if i % 2 == 0 else "vctk"
        frames = 600 if i == 5 else int(rng.integers(10, 45))
        mel = rng.uniform(-4, 4, (frames, MELS)).astype(np.float32)
        np.save(os.path.join(root, ds, "mels", f"mel-{i}.npy"), mel)
        emt = 3 if i == n - 1 else i % 3
        rows.append(f"{ds}|audio-{i}.npy|mel-{i}.npy|l|s|{frames * 4}|"
                    f"{frames}|text {i}|{emt}|{i % 3}|utt{i}.wav|F")
    path = os.path.join(root, "train.txt")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def stacks(root, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i, n in enumerate((3, 5, 2)):
        np.save(os.path.join(root, f"speaker{i}.npy"),
                rng.normal(size=(n, MELS, 16)).astype(np.float32))
    return root


@pytest.mark.parametrize("opts", [dict(kind="emt"), dict(kind="spk"),
                                  dict(kind="accent", keep_top_accents=2),
                                  dict(kind="emt", remove_long_samps=True),
                                  "stacks"])
def test_feeder_batches_match_jax(opts, tmp_path):
    jcfg, tcfg = cfgs()
    if opts == "stacks":
        d = stacks(str(tmp_path / "st"))
        feeders = (jdt.DiscStackFeeder(d, seed=3),
                   tdt.DiscStackFeeder(d, seed=3))
    else:
        path = corpus(str(tmp_path))
        feeders = (jdt.DiscFeeder(jcfg, path, crop_frames=16, seed=3, **opts),
                   tdt.DiscFeeder(tcfg, path, crop_frames=16, seed=3, **opts))
    assert feeders[0].classes == feeders[1].classes
    assert feeders[0].n_classes == feeders[1].n_classes
    its = [f.batches(M=3) for f in feeders]
    for _ in range(3):
        bj, bt = next(its[0]), next(its[1])
        assert (bj["N"], bj["M"]) == (bt["N"], bt["M"])
        np.testing.assert_array_equal(bt["labels"], bj["labels"])
        np.testing.assert_array_equal(bt["mels"], bj["mels"])


# Adam with eps 1e-8 moves an element by about lr·sign(g) a step whatever
# |g| is, so an element whose gradient is rounding noise moves by a random
# sign in each package: the conv biases right before train-mode BatchNorm
# (zero gradient in exact arithmetic), GE2E's b under the softmax loss
# (its gradient sums softmax rows to one) and a few elements whose
# gradient happens to be that small. The two packages' first gradients
# differ by up to ~1.3e-6 (measured at these shapes); an element whose
# first gradient is within NOISE_GRAD of 0 is held to the Adam noise
# bound, 2·steps·lr, and so is the running mean of a BatchNorm after such
# a bias (the bias shifts the batch mean it tracks).
NOISE_GRAD = 2e-5


def first_grads(model, init, batch, loss_type, n_classes):
    """The first step's gradient, a flat {flax path: array}: the port's,
    which is within ~1.3e-6 of JAX's (measured), so it picks the same
    noise elements."""
    convert.load_disc(model, init["params"], init["batch_stats"])
    tr = tdt.DiscTrainer(model, n_classes, use_ce=loss_type == "ce",
                         loss_type=loss_type)
    loss, _, _ = tr.loss(batch["mels"], batch["labels"], batch["N"],
                         batch["M"])
    grads = torch.autograd.grad(loss, tr.params)
    return {convert.flax_path(n): convert.to_flax_array(n, g)
            for (n, _), g in zip(model.named_parameters(), grads)}


def trained_close(got, want, grads, steps, lr, what):
    """Trees {"params", "batch_stats"} after `steps` Adam steps (see
    NOISE_GRAD)."""
    bound = 2 * steps * lr
    fg, fw = flat(got["params"]), flat(want["params"])
    assert set(fg) == set(fw), set(fg) ^ set(fw)
    noisy_bias = set()
    for k, w in fw.items():
        noise = np.abs(grads[k]) <= NOISE_GRAD
        tol = np.where(noise, bound, 1e-5 * max(1.0, float(np.abs(w).max())))
        err = np.abs(fg[k] - w)
        assert (err <= tol).all(), f"{what} {k}: {err.max():.3e}"
        if "/conv2d_" in k and k.endswith("bias") and noise.all():
            noisy_bias.add(k.rsplit("/", 2)[0] + "/BatchNorm_"
                           + k.split("/")[-2].split("_")[1] + "/mean")
    fg, fw = flat(got["batch_stats"]), flat(want["batch_stats"])
    assert set(fg) == set(fw), set(fg) ^ set(fw)
    for k, w in fw.items():
        if k in noisy_bias:
            assert np.abs(fg[k] - w).max() <= bound, f"{what} stats {k}"
        else:
            close_to_scale(fg[k], w, msg=f"{what} stats {k}")


def jit_init(mp, cls, store=None):
    """Patch a flax class's `init` to run jitted (the JAX trainers call it
    eagerly, which compiles each primitive apart: ~10 s on a cold cache)
    and record what it returns in `store`."""
    orig = cls.init

    def init(self, rngs, x, train):
        v = jax.jit(lambda r, x_: orig(self, r, x_, train=train))(rngs, x)
        if store is not None:
            store.append({"params": np_tree(v["params"]),
                          "batch_stats": np_tree(v.get("batch_stats", {}))})
        return v

    mp.setattr(cls, "init", init)


def _jax_init(model, batch):
    """The JAX trainers' init (PRNGKey(0) on the first batch), jitted."""
    v = jax.jit(lambda x: model.init(dict(params=jax.random.PRNGKey(0)), x,
                                     train=True))(jnp.asarray(batch["mels"]))
    return {"params": np_tree(v["params"]),
            "batch_stats": np_tree(v.get("batch_stats", {}))}


def _record_rows(monkeypatch, module):
    """Record every row a module's DiscFeeder crops, in order."""
    seen = []
    orig = module.DiscFeeder._load_crop

    def load_crop(self, row):
        seen.append(row[2])
        return orig(self, row)

    monkeypatch.setattr(module.DiscFeeder, "_load_crop", load_crop)
    return seen


def jax_disc_run(root, loss_type):
    """JAX `disc_train` for 3 steps on `corpus(root)`, with its init, the
    first step's gradient and the rows it read."""
    jcfg, tcfg = cfgs()
    path = corpus(root)
    mp, inits = pytest.MonkeyPatch(), []
    seen = _record_rows(mp, jdt)
    jit_init(mp, jdm.DiscriminatorModel, inits)
    try:
        jdir, jparams = jdt.disc_train(jcfg, path, os.path.join(root, "j"),
                                       kind="emt", train_steps=3,
                                       n_per_class=2, loss_type=loss_type,
                                       checkpoint_interval=3)
    finally:
        mp.undo()
    feeder = tdt.DiscFeeder(tcfg, path, kind="emt")
    it = feeder.batches(M=2)
    next(it)
    init = inits[0]
    grads = first_grads(tdm.DiscriminatorModel(tcfg, feeder.n_classes,
                                               loss_type == "ce"),
                        init, next(it), loss_type, feeder.n_classes)
    return dict(path=path, init=init, grads=grads, jdir=jdir,
                jparams=np_tree(jparams), seen=list(seen),
                n_classes=feeder.n_classes)


@pytest.fixture(scope="module")
def jax_ce_run(tmp_path_factory):
    return jax_disc_run(str(tmp_path_factory.mktemp("ce")), "ce")


@pytest.mark.parametrize("loss_type", ["ce", "softmax"])
def test_disc_train_matches_jax(loss_type, tmp_path, monkeypatch,
                                jax_ce_run):
    """3 steps from JAX's init: the final parameters and (from the JAX
    checkpoint) statistics, and the same rows read."""
    _, tcfg = cfgs()
    run = (jax_ce_run if loss_type == "ce"
           else jax_disc_run(str(tmp_path), loss_type))
    path, init, grads = run["path"], run["init"], run["grads"]
    jdir, jparams, seen_j = run["jdir"], run["jparams"], run["seen"]
    seen_t = _record_rows(monkeypatch, tdt)
    tdir, tparams = tdt.disc_train(tcfg, path, str(tmp_path / "t"),
                                   kind="emt", train_steps=3, n_per_class=2,
                                   loss_type=loss_type,
                                   checkpoint_interval=3, device="cpu",
                                   init=init)
    assert seen_t == seen_j and len(seen_t) == 4 * run["n_classes"] * 2
    jtree = np_tree(JMgr(jdir).restore())
    trees_close(jtree["params"], jparams, 0, "JAX checkpoint")
    mgr = CheckpointManager(tdir)
    assert mgr.steps() == [3]
    ttree = mgr.load()
    trees_close(ttree["params"], tparams, 0, "port checkpoint")
    trained_close(ttree, jtree, grads, 3, 1e-3, loss_type)


def test_emt_disc_train_matches_jax(tmp_path, monkeypatch):
    """4 steps with an eval every 2 from JAX's init: parameters,
    statistics, and every row read (the batches' and the val split's)."""
    jcfg, tcfg = cfgs()
    path = corpus(str(tmp_path))
    kw = dict(train_steps=4, batch_size=4, n_classes=4, eval_interval=2,
              checkpoint_interval=4, test_size=0.3)
    seen_j, inits = _record_rows(monkeypatch, jdt), []
    jit_init(monkeypatch, jdm.EmtDisc, inits)
    jdir, jparams = jdt.emt_disc_train(jcfg, path, str(tmp_path / "j"), **kw)
    init = inits[0]
    feeder = tdt.DiscFeeder(tcfg, path, kind="emt", seed=1234)
    val = tdt.emt_disc_split(feeder, 1234, 0.3)
    assert sum(1 for c in feeder.by_class.values() if len(c) == 1) == 1
    it = feeder.batches(N=4, M=1)
    next(it)
    grads = first_grads(tdm.EmtDisc(tcfg, 4), init, next(it), "ce", 4)
    seen_t = _record_rows(monkeypatch, tdt)
    tdir, tparams = tdt.emt_disc_train(tcfg, path, str(tmp_path / "t"),
                                       device="cpu", init=init, **kw)
    assert seen_t == seen_j
    assert [r[2] for r in val] == seen_t[-len(val):]
    jtree = np_tree(JMgr(jdir).restore())
    trees_close(jtree["params"], np_tree(jparams), 0, "JAX checkpoint")
    trained_close(CheckpointManager(tdir).load(), jtree, grads, 4, 1e-4,
                  "emt_disc")
    import json
    recs = [json.loads(x) for x in open(tmp_path / "t" /
                                        "emt_disc_curve.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert "val_loss" in recs[1] and "val_loss" not in recs[0]


def test_load_pretrained_disc_and_graft_match_jax(tmp_path):
    """A disc checkpoint's encoder subtree and statistics, grafted into a
    Tacotron's pretrained_ref_enc_emt: the port's tree against JAX
    `import_pretrained_subtree`; KeyError without the subtree; a missing
    directory raises FileNotFoundError."""
    _, tcfg = cfgs()
    tm = tdm.DiscriminatorModel(tcfg, 4)
    convert.init_params(tm, tcfg, torch.Generator().manual_seed(5))
    with torch.no_grad():
        for _, b in tm.named_buffers():
            b.uniform_(0.5, 1.5)
    params, stats = convert.disc_to_flax(tm)
    CheckpointManager(str(tmp_path / "d")).save(
        7, {"params": params, "batch_stats": stats})
    got = tdt.load_pretrained_disc(str(tmp_path / "d"))
    trees_close(got["params"], params["pretrained_ref_enc"], 0)
    trees_close(got["batch_stats"], stats["pretrained_ref_enc"], 0)

    taco = convert.init_tacotron(tcfg, torch.Generator().manual_seed(0),
                                 "cpu", pretrained_emb_disc=True,
                                 use_unpaired=True)
    p0, s0 = convert.tacotron_to_flax(taco)
    want = import_pretrained_subtree(p0, got["params"],
                                     "pretrained_ref_enc_emt")
    assert import_pretrained_disc(taco, "emt", str(tmp_path / "d")) == \
        "msgpack"
    p1, s1 = convert.tacotron_to_flax(taco)
    trees_close(p1, want, 0, "grafted params")
    trees_close(s1["pretrained_ref_enc_emt"], got["batch_stats"], 0)
    trees_close(s1["pretrained_ref_enc_spk"], s0["pretrained_ref_enc_spk"], 0)
    plain = convert.init_tacotron(tcfg, torch.Generator().manual_seed(0),
                                  "cpu")
    with pytest.raises(KeyError, match="pretrained_ref_enc_emt"):
        import_pretrained_disc(plain, "emt", str(tmp_path / "d"))
    with pytest.raises(FileNotFoundError):
        tdt.load_pretrained_disc(str(tmp_path / "missing"))


def test_disc_test_matches_jax(tmp_path, jax_ce_run):
    """The JAX CE discriminator after 3 steps, its checkpoint written in
    the port's format: the same accuracy, confusion matrix and CSV rows
    on the train.txt (emotions) and on a synthesis map of its mels
    (speakers)."""
    jcfg, tcfg = cfgs()
    path, jdir = jax_ce_run["path"], jax_ce_run["jdir"]
    CheckpointManager(str(tmp_path / "t")).save(
        3, np_tree(JMgr(jdir).restore()))
    rows = open(path).read().strip().split("\n")
    mp = tmp_path / "map.txt"
    mp.write_text("".join(
        f"{os.path.dirname(path)}/{r.split('|')[0]}/mels/{r.split('|')[2]}"
        f"|text|{i % 3}|{i % 3}\n" for i, r in enumerate(rows)))
    monkeypatch = pytest.MonkeyPatch()
    jit_init(monkeypatch, jdm.DiscriminatorModel)
    for kind, m in (("emt", path), ("spk", str(mp))):
        ja, jc = jdt.disc_test(jcfg, jdir, m, str(tmp_path / "oj"),
                               kind=kind, n_classes=4, crop_frames=16)
        ta, tc = tdt.disc_test(tcfg, str(tmp_path / "t"), m,
                               str(tmp_path / "ot"), kind=kind, n_classes=4,
                               crop_frames=16, device="cpu")
        assert ta == ja
        np.testing.assert_array_equal(tc, jc)
        assert tc.sum() == len(open(m).read().split("\n")) - 1
        assert (open(tmp_path / "ot" / f"disc_test_{kind}.csv").read()
                == open(tmp_path / "oj" / f"disc_test_{kind}.csv").read())
        assert os.path.exists(tmp_path / "ot" / f"confusion_{kind}.png")
    monkeypatch.undo()


def test_classify_mels_matches_jax(jax_ce_run):
    """eval/analyze.classify_mels on the JAX discriminator's init: a mel
    shorter than the crop (padded with -4) and one longer (cropped)."""
    import types

    from tacotron2_tpu.eval.analyze import classify_mels as jax_classify
    from tacotron2_tpu_torch.eval.analyze import classify_mels
    jcfg, tcfg = cfgs()
    init, n = jax_ce_run["init"], jax_ce_run["n_classes"]
    rng = np.random.default_rng(0)
    mels = [rng.uniform(-4, 4, (k, MELS)).astype(np.float32) for k in (9, 40)]
    jm = jdm.DiscriminatorModel(config=jcfg, output_classes=n)
    shim = types.SimpleNamespace(apply=jax.jit(jm.apply,
                                               static_argnames="train"))
    want = jax_classify(shim, init, mels, crop_frames=16)
    tm = tdm.DiscriminatorModel(tcfg, n)
    convert.load_disc(tm, init["params"], init["batch_stats"])
    np.testing.assert_array_equal(classify_mels(tm, mels, crop_frames=16),
                                  want)


def write_wav(path, x, sr):
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def speech_like(rng, sr, seconds):
    """Tones in bursts with silences between (voiced intervals)."""
    t = np.arange(int(sr * seconds)) / sr
    env = (np.sin(2 * np.pi * 0.7 * t) > -0.2).astype(np.float32)
    x = 0.5 * np.sin(2 * np.pi * rng.uniform(150, 400) * t) * env
    return (x + 0.01 * rng.normal(size=t.shape)).astype(np.float32)


def test_tisv_preprocessing_and_load_wav_match_jax(tmp_path):
    """load_wav (with resampling from 22,050 Hz), log_mel_windows (every
    window and edges_only) and build_speaker_stacks on synthetic speakers,
    in one job (the JAX pool forks, which JAX's threads make unsafe; the
    port's spawned workers each compile torch's sources on import here,
    ~8 s: chip_smoke.py phase 27 runs its pool)."""
    jcfg, tcfg = cfgs()
    rng = np.random.default_rng(0)
    sr = tcfg.audio.sample_rate
    corpus_dir = tmp_path / "corpus"
    for s in range(3):
        d = corpus_dir / f"spk{s}" / "sub"
        d.mkdir(parents=True)
        for u in range(2):
            rate = 22050 if u == 1 else sr
            write_wav(d / f"u{u}.wav", speech_like(rng, rate, 2.5), rate)
    p = str(corpus_dir / "spk0" / "sub" / "u1.wav")
    wj, wt = jaudio.load_wav(p, sr), taudio.load_wav(p, sr)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(taudio.split_silence(wt),
                                  jaudio.split_silence(wj))
    for edges in (False, True):
        kw = dict(n_mels=MELS, tisv_frame=24, edges_only=edges)
        a = jdp.log_mel_windows(wj, jcfg.audio, **kw)
        b = tdp.log_mel_windows(wt, tcfg.audio, **kw)
        assert len(a) == len(b) > 0
        for x, y in zip(b, a):
            close_to_scale(x, y)
    outs = {}
    for name, mod, c in (("j", jdp, jcfg), ("t", tdp, tcfg)):
        outs[name] = mod.build_speaker_stacks(
            str(corpus_dir), str(tmp_path / name), c.audio, n_mels=MELS,
            tisv_frame=24, test_fraction=0.34, n_jobs=1)
    for split in ("train", "test"):
        dj, dt_ = outs["j"][split], outs["t"][split]
        assert sorted(os.listdir(dj)) == sorted(os.listdir(dt_))
        assert open(os.path.join(dj, "metadata.csv")).read() == \
            open(os.path.join(dt_, "metadata.csv")).read()
        for f in os.listdir(dj):
            if f.endswith(".npy"):
                close_to_scale(np.load(os.path.join(dt_, f)),
                               np.load(os.path.join(dj, f)), msg=f)


def test_cli_disc_commands_on_cpu(tmp_path, monkeypatch):
    """disc-preprocess, disc-train (CE on a train.txt, GE2E on the
    stacks), emt-disc-train, disc-test and fixed-eval-set through
    `cli.main` with --device cpu; the defaults are JAX's."""
    _, tcfg = cfgs()
    monkeypatch.setattr(cli, "get_config", lambda *a, **k: tcfg)
    path = corpus(str(tmp_path / "data"))
    for cmd in ("disc-train", "emt-disc-train", "disc-preprocess",
                "disc-test", "fixed-eval-set"):
        ours = cli.build_parser()._subparsers._group_actions[0].choices[cmd]
        theirs = jax_parser()._subparsers._group_actions[0].choices[cmd]
        want = {a.dest: a.default for a in theirs._actions
                if a.dest != "help"}
        got = {a.dest: a.default for a in ours._actions
               if a.dest not in ("help", "device", "base_dir")}
        assert got == want, cmd
    base = str(tmp_path / "runs")
    ckpt = cli.main(["disc-train", "--input-path", path, "--base-dir", base,
                     "--kind", "emt", "--loss-type", "ce", "--train-steps",
                     "2", "--n-per-class", "2", "--device", "cpu"])
    assert os.listdir(ckpt) == ["ckpt-2.msgpack"]
    acc, cm = cli.main(["disc-test", "--checkpoint", ckpt, "--map-path",
                        path, "--base-dir", base, "--device", "cpu"])
    assert 0.0 <= acc <= 1.0 and cm.sum() == 14
    assert os.path.exists(os.path.join(base, "disc_test",
                                       "disc_test_emt.csv"))
    e_ckpt = cli.main(["emt-disc-train", "--input-path", path, "--base-dir",
                       base, "--train-steps", "2", "--batch-size", "4",
                       "--device", "cpu"])
    assert os.listdir(e_ckpt) == ["ckpt-2.msgpack"]
    corpus_dir = tmp_path / "wavs"
    rng = np.random.default_rng(1)
    for s in range(2):
        (corpus_dir / f"s{s}").mkdir(parents=True)
        write_wav(corpus_dir / f"s{s}" / "a.wav",
                  speech_like(rng, tcfg.audio.sample_rate, 2.0),
                  tcfg.audio.sample_rate)
    out = cli.main(["disc-preprocess", "--corpus-dir", str(corpus_dir),
                    "--output-dir", str(tmp_path / "tisv"), "--n-mels",
                    str(MELS), "--tisv-frame", "24", "--test-fraction", "0",
                    "--n-jobs", "1"])
    assert sorted(os.listdir(out["train"])) == [
        "metadata.csv", "speaker0.npy", "speaker1.npy"]
    g_ckpt = cli.main(["disc-train", "--stacks-dir", out["train"],
                       "--base-dir", base, "--kind", "spk", "--train-steps",
                       "2", "--n-per-class", "2", "--device", "cpu"])
    assert set(tdt.load_pretrained_disc(g_ckpt)["params"]) == {
        "conv2d_0", "conv2d_1", "BatchNorm_0", "BatchNorm_1", "GRU_0",
        "Dense_0"}
    fe = cli.main(["fixed-eval-set", "--input-path", path, "--out-path",
                   str(tmp_path / "fixed.txt"), "--min-frames", "20",
                   "--n-texts", "2", "--n-refs-per-class", "1"])
    rows = open(fe).read().strip().split("\n")
    assert len(rows) == 2 * 4 and all(len(r.split("|")) == 15 for r in rows)
