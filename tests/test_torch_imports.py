"""The port stands alone: neither `tacotron2_tpu_torch`, `chip_smoke.py`
nor the data-parallel tests' rank module imports JAX, flax, msgpack or
anything of the JAX package, and importing the port pulls none of them
in."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|flax|msgpack|tacotron2_tpu)(?:[.\s]|$)",
    re.M)


def _port_files():
    # the ranks of the data-parallel tests run this module alone
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "torch_parallel_worker.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "tacotron2_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_files_exist():
    files = _port_files()
    assert os.path.exists(files[0]) and len(files) > 30
    csrc = os.path.join(ROOT, "tacotron2_tpu_torch", "csrc")
    for src in ("decoder_bwd.cu", "wavenet_train.cu"):
        assert os.path.exists(os.path.join(csrc, src)), src
    # data parallelism's parity tests; the decode kernels' envelope (bf16 rounding, smoothing, f32 weights),
    # the WaveNet stack kernels' (f32, f32 activations, every width) and
    # the Tacotron variants' parity and routes (HighwayNet, CBHG and
    # ReferenceEncoderAdaIn in models/tacotron/modules.py), the WaveNet
    # variants' (the upsamplers in models/wavenet/modules.py) and the
    # preprocessing's
    for name in ("test_torch_decode_envelope.py",
                 "test_torch_wavenet_stack_envelope.py",
                 "test_torch_model_variants.py",
                 "test_torch_variant_routes.py",
                 "test_torch_wavenet_variants.py",
                 "test_torch_preprocess.py", "test_torch_parallel.py",
                 "test_torch_parallel_wavenet.py"):
        assert os.path.exists(os.path.join(ROOT, "tests", name))
    rel = {os.path.relpath(f, ROOT) for f in files}
    for mod in ("ops/stft.py", "ops/griffin_lim.py",
                "ops/griffin_lim_kernel.py", "data/audio.py",
                "synth/tacotron_synth.py", "ops/mulaw.py",
                "data/wavenet_feeder.py", "models/wavenet/distributions.py",
                "synth/wavenet_synth.py", "ops/tacotron_train_kernel.py",
                "ops/tacotron_decoder_kernel.py", "models/tacotron/model.py",
                "models/tacotron/losses.py", "data/feeder.py",
                "eval/convergence.py", "train/optim.py",
                "train/tacotron_step.py", "train/checkpoint.py",
                "train/eval_guard.py", "train/tacotron_train.py",
                "ops/wavenet_train_kernel.py", "train/wavenet_step.py",
                "train/wavenet_train.py", "disc/model.py", "disc/train.py",
                "disc/data_preprocess.py", "disc/tf_import.py",
                "utils/summary.py", "utils/infolog.py", "utils/plot.py",
                "eval/analyze.py", "models/tacotron/modules.py",
                "models/tacotron/decoder.py", "synth/pipeline.py",
                "data/preprocess.py", "models/wavenet/modules.py",
                "parallel/__init__.py", "parallel/dist.py"):
        assert os.path.join("tacotron2_tpu_torch", mod) in rel, mod


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    with open(path, encoding="utf-8") as f:
        src = f.read()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(src)]
    assert not hits, f"{path}: {hits}"


def test_pattern_catches_forbidden_forms():
    for line in ("import jax", "import jax.numpy as jnp", "from flax import x",
                 "  import msgpack", "from tacotron2_tpu.config import C",
                 "import tacotron2_tpu"):
        assert FORBIDDEN.search(line), line
    for line in ("from tacotron2_tpu_torch.config import C",
                 "import tacotron2_tpu_torch", "# jax.checkpoint is not used"):
        assert not FORBIDDEN.search(line), line


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib, pkgutil, tacotron2_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'msgpack', 'tacotron2_tpu', 'orbax', "
            "'tensorflow', 'matplotlib')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env={**os.environ, "PYTHONPATH": ROOT})


BLOCKED = ("jax", "flax", "msgpack", "orbax", "tensorflow", "matplotlib",
           "tensorboard")


def test_the_port_runs_with_its_optional_modules_blocked(tmp_path):
    """Every module of the port imports with jax, flax, msgpack, orbax,
    tensorflow, matplotlib and tensorboard blocked (an import of any
    raises ImportError, as on a machine without them); then each plot
    returns without writing and logs one line, the summary writer writes
    metrics.jsonl without event files, and a TF discriminator checkpoint
    still reads."""
    code = f"""
import importlib, os, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import tacotron2_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):
    importlib.import_module(m.name)
from tacotron2_tpu_torch.eval.analyze import plot_confusion_matrix
from tacotron2_tpu_torch.utils import plot
from tacotron2_tpu_torch.utils.summary import SummaryWriter
from tacotron2_tpu_torch.disc.tf_import import read_tf_checkpoint
out = {str(tmp_path)!r}
assert not plot.plot_alignment(np.ones((3, 4)), out + "/a.png")
assert not plot.plot_spectrogram(np.ones((4, 3)), out + "/m.png")
assert not plot.waveplot(out + "/w.png", np.ones(9), None, 16000)
plot_confusion_matrix(np.eye(2, dtype=int), out + "/c.png")
w = SummaryWriter(out)
w.scalars(1, {{"loss": 2.0}})
w.close()
assert sorted(os.listdir(out)) == ["metrics.jsonl"], os.listdir(out)
assert len(read_tf_checkpoint(os.path.join(
    {ROOT!r}, "tests", "fixtures", "tf_disc_small"))) == 21
bad = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}]
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stderr
    skipped = [x for x in res.stdout.splitlines() if "plot skipped" in x]
    assert len(skipped) == 4, res.stdout
