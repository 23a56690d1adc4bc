"""The port's reader of TensorFlow discriminator checkpoints
(`tacotron2_tpu_torch/disc/tf_import.py`), without TensorFlow.

tests/fixtures/tf_disc_small/ holds a small TF1 checkpoint in the
reference's layout (filters (4, 4), depth 8, 20 mels, the GE2E w and b,
an int64 global_step) that scripts/make_tf_disc_fixture.py wrote with
TensorFlow, and expected.npz, the JAX package's `read_tf_checkpoint` and
`tf_disc_to_flax` on it (TensorFlow's own reader there). The port's reader
and converter must give the same names, dtypes and values exactly; a
corrupted footer, a compressed block or a sliced entry raise ValueError;
the converted encoder grafts into a port Tacotron and runs.
"""

import os
import shutil
import struct
import sys

import numpy as np
import pytest
import torch

from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.disc import tf_import as tfi

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tf_disc_small")


def expected(group):
    exp = np.load(os.path.join(FIXTURE, "expected.npz"))
    pre = group + "/"
    return {k[len(pre):]: exp[k] for k in exp.files if k.startswith(pre)}


def flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def test_reader_and_converter_match_the_jax_reading():
    assert "tensorflow" not in sys.modules
    got = tfi.read_tf_checkpoint(FIXTURE)
    want = expected("vars")
    assert sorted(got) == sorted(want) and len(got) == 21
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got["global_step"] == 1234
    params, stats, extras = tfi.tf_disc_to_flax(got)
    for group, tree in (("params", params), ("stats", stats),
                        ("extras", extras)):
        g, w = flat(tree), expected(group)
        assert sorted(g) == sorted(w), group
        for k, v in w.items():
            np.testing.assert_array_equal(g[k], v, err_msg=f"{group} {k}")
    prefix = tfi._find_prefix(FIXTURE)
    assert prefix.endswith("model.ckpt-1234")
    for path in (FIXTURE, prefix, prefix + ".index"):
        assert tfi.is_tf_checkpoint(path)
    assert not tfi.is_tf_checkpoint(os.path.dirname(FIXTURE))
    assert "tensorflow" not in sys.modules


def _copy(tmp_path):
    d = tmp_path / "ckpt"
    shutil.copytree(FIXTURE, d)
    return str(d / "model.ckpt-1234.index")


def test_reader_refuses_what_it_cannot_read(tmp_path):
    """ValueError naming the cause: a footer without the table magic, a
    compressed block, a sliced entry, an unknown dtype."""
    index = _copy(tmp_path)
    data = bytearray(open(index, "rb").read())
    bad = bytearray(data)
    bad[-1] ^= 0xFF
    open(index, "wb").write(bytes(bad))
    with pytest.raises(ValueError, match="magic"):
        tfi.read_tf_checkpoint(index)
    # the index block's compression byte (the byte after its contents)
    footer = bytes(data[-tfi.FOOTER_LEN:])
    _, _, pos = tfi._handle(footer)
    off, size, _ = tfi._handle(footer, pos)
    bad = bytearray(data)
    bad[off + size] = 1
    open(index, "wb").write(bytes(bad))
    with pytest.raises(ValueError, match="compressed block"):
        tfi.read_tf_checkpoint(index)
    with pytest.raises(ValueError, match="sliced"):
        tfi._entry(bytes([7 << 3 | 2, 0]), "x")
    with pytest.raises(ValueError, match="dtype 7"):
        entry = bytes([1 << 3, 7])
        open(index, "wb").write(bytes(data))
        table = tfi.read_index(index)
        key = next(k for k in table if k)
        monkey = dict(table)
        monkey[key] = entry
        orig = tfi.read_index
        try:
            tfi.read_index = lambda p: monkey
            tfi.read_tf_checkpoint(index)
        finally:
            tfi.read_index = orig


def test_tf_checkpoint_grafts_into_a_port_tacotron(tmp_path):
    """The converted encoder (and its moving statistics) grafted into
    pretrained_ref_enc_emt of a port Tacotron at the fixture's widths,
    then the unpaired train forward runs through it."""
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_disc import cfgs
    from tacotron2_tpu_torch.train.tacotron_train import \
        import_pretrained_disc
    _, tcfg = cfgs()
    model = convert.init_tacotron(tcfg, torch.Generator().manual_seed(0),
                                  "cpu", pretrained_emb_disc=True,
                                  use_unpaired=True)
    assert import_pretrained_disc(model, "emt", FIXTURE) == "TF"
    params, stats = convert.tacotron_to_flax(model)
    for k, v in expected("params").items():
        np.testing.assert_array_equal(
            convert.tree_get(params, "pretrained_ref_enc_emt/" + k), v)
    for k, v in expected("stats").items():
        np.testing.assert_array_equal(
            convert.tree_get(stats, "pretrained_ref_enc_emt/" + k), v)
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.uniform(-4, 4, (2, 16, 20)).astype(
        np.float32))
    emb = model.pretrained_ref_enc_emt(mel)
    assert emb.shape == (2, 128) and torch.isfinite(emb).all()
