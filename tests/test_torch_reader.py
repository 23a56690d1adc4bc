"""The port's flax msgpack reader (tacotron2_tpu_torch/utils/flax_msgpack.py)
against flax's own `msgpack_restore`: the r5 checkpoints read leaf for
leaf, bit for bit, and anything outside the format raises."""

import os

import flax.serialization as fser
import msgpack
import numpy as np
import pytest

from tacotron2_tpu_torch.utils import flax_msgpack

R5 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "artifacts", "e2e_demo_r5")


@pytest.mark.parametrize("name,n_leaves", [("taco_ckpt.msgpack", 178),
                                           ("wn_ckpt.msgpack", 170)])
def test_reads_checkpoint_bit_equal(name, n_leaves):
    path = os.path.join(R5, name)
    with open(path, "rb") as f:
        blob = f.read()
    got = dict(flax_msgpack.flatten(flax_msgpack.loads(blob)))
    want = dict(flax_msgpack.flatten(fser.msgpack_restore(blob)))
    assert len(got) == n_leaves and got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_roundtrip_small_tree():
    tree = {"a": {"k": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "s": np.asarray(2.5, np.float32)},
            "b": np.asarray([1, -2, 3], np.int32), "n": 7, "f": -1.5,
            "t": "text", "l": [1, 2]}
    got = flax_msgpack.loads(fser.msgpack_serialize(tree))
    np.testing.assert_array_equal(got["a"]["k"], tree["a"]["k"])
    assert got["a"]["s"].shape == () and got["a"]["s"] == 2.5
    np.testing.assert_array_equal(got["b"], tree["b"])
    assert (got["n"], got["f"], got["t"], got["l"]) == (7, -1.5, "text",
                                                        [1, 2])


@pytest.mark.parametrize("blob", [
    msgpack.packb({"x": msgpack.ExtType(2, b"\x00")}),    # unknown ext
    msgpack.packb({"x": 1})[:-1],                         # truncated
    msgpack.packb({"x": 1}) + b"\x00",                    # trailing bytes
    b"\xc1",                                              # reserved byte
])
def test_rejects_what_it_does_not_know(blob):
    with pytest.raises(ValueError):
        flax_msgpack.loads(blob)
