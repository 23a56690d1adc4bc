"""Read the reference's TensorFlow discriminator checkpoints, without
TensorFlow.

Counterpart of tacotron2_tpu/disc/tf_import.py (reference tacotron/
train.py:280-285, 331-340: the pretrained emotion and speaker
discriminators restored into pretrained_ref_enc_{emt,spk}). The JAX module
reads a checkpoint through TensorFlow's reader; the port reads TF's
tensor-bundle format itself, in numpy:

- `<prefix>.index` is a LevelDB-format table: a 48-byte footer (the
  metaindex and index block handles, varints, padded to 40 bytes, then
  the magic 0xdb4775248b80fb57), blocks of prefix-compressed entries
  (shared, unshared and value lengths as varints, then the key's suffix
  and the value; a restart array and its count close the block), each
  block followed by a compression byte and a CRC. The index block maps
  the last key of each data block to its handle. The entry with the empty
  key is the BundleHeaderProto (the shard count); every other entry is a
  tensor's BundleEntryProto (dtype, shape, shard, offset, size).
- `<prefix>.data-<shard>-of-<shards>` holds the tensors' raw little-endian
  bytes at those offsets.

`read_tf_checkpoint` raises ValueError, naming the cause, on a footer
without the magic, a compressed block, a sliced (partitioned) entry, a
big-endian bundle, a size that disagrees with its shape, or a dtype it
does not know. `tf_disc_to_flax` maps the variables to the flax
ReferenceEncoder layout (as the JAX module does):

  <scope>/conv2d_i/conv2d/{kernel,bias}         -> conv2d_i/{kernel,bias}
  <scope>/conv2d_i/batch_normalization/gamma    -> BatchNorm_i/scale
  <scope>/conv2d_i/batch_normalization/beta     -> BatchNorm_i/bias
  .../moving_{mean,variance}    -> batch_stats BatchNorm_i/{mean,var}
  <scope>/rnn/gru_cell/{gates,candidate}/{kernel,bias}
                                -> GRU_0/GRUCell_0/{gates,candidate}_*
  <scope>/dense/{kernel,bias}                   -> Dense_0/{kernel,bias}
  w, b (GE2E scale and bias) and the rest       -> extras
"""

from __future__ import annotations

import glob
import os
import re
import struct
from typing import Any, Dict, Tuple

import numpy as np

TABLE_MAGIC = 0xdb4775248b80fb57
FOOTER_LEN = 48
# TensorFlow's DataType enum (types.proto) -> numpy
DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
          5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_, 17: np.uint16,
          19: np.float16, 22: np.uint32, 23: np.uint64}


def _find_prefix(path: str) -> str:
    """A checkpoint prefix, a .index file, or a directory (its newest
    `*-<step>.index` by step)."""
    if os.path.isdir(path):
        idx = glob.glob(os.path.join(path, "*.index"))
        if not idx:
            raise FileNotFoundError(f"no TF checkpoint *.index under {path}")

        def step_of(p):
            m = re.search(r"-(\d+)\.index$", p)
            return (int(m.group(1)) if m else -1, p)

        return max(idx, key=step_of)[:-len(".index")]
    if path.endswith(".index"):
        return path[:-len(".index")]
    return path


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out, shift = 0, 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in the TF checkpoint index")
        byte = buf[pos]
        pos += 1
        out |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return out, pos
        shift += 7


def _proto_fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message: ints for
    varint / fixed fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"protobuf wire type {wire} in the TF "
                             "checkpoint index")
        yield field, wire, val


def _block(data: bytes, offset: int, size: int) -> bytes:
    """A table block's contents, after checking its compression byte."""
    if offset + size + 5 > len(data):
        raise ValueError("a block handle past the end of the TF checkpoint "
                         "index")
    kind = data[offset + size]
    if kind != 0:
        raise ValueError(f"compressed block (type {kind}) in the TF "
                         "checkpoint index; only uncompressed tables are "
                         "read")
    return data[offset:offset + size]


def _block_entries(block: bytes):
    """(key, value) of each entry of a block (keys prefix-compressed)."""
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * n_restarts
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + vlen]
        pos += vlen


def _handle(buf: bytes, pos: int = 0) -> Tuple[int, int, int]:
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return offset, size, pos


def read_index(index_path: str) -> Dict[bytes, bytes]:
    """Every (key, value) of a TF checkpoint's .index table."""
    with open(index_path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_LEN:
        raise ValueError(f"{index_path}: shorter than a table footer")
    footer = data[-FOOTER_LEN:]
    magic = struct.unpack_from("<Q", footer, FOOTER_LEN - 8)[0]
    if magic != TABLE_MAGIC:
        raise ValueError(f"{index_path}: bad table magic {magic:#x} in the "
                         f"footer (want {TABLE_MAGIC:#x})")
    _, _, pos = _handle(footer)              # the metaindex block
    off, size, _ = _handle(footer, pos)      # the index block
    out = {}
    for _, handle in _block_entries(_block(data, off, size)):
        d_off, d_size, _ = _handle(handle)
        out.update(_block_entries(_block(data, d_off, d_size)))
    return out


def _entry(value: bytes, name: str) -> dict:
    """A BundleEntryProto's dtype, shape, shard, offset and size."""
    e = dict(dtype=0, shape=[], shard=0, offset=0, size=0)
    for field, _, val in _proto_fields(value):
        if field == 1:
            e["dtype"] = val
        elif field == 2:
            for f2, _, dim in _proto_fields(val):
                if f2 == 2:
                    e["shape"].append(next(
                        (v for f3, _, v in _proto_fields(dim) if f3 == 1), 0))
                elif f2 == 3 and dim:
                    raise ValueError(f"{name}: unknown rank")
        elif field == 3:
            e["shard"] = val
        elif field == 4:
            e["offset"] = val
        elif field == 5:
            e["size"] = val
        elif field == 7:
            raise ValueError(f"{name}: a sliced (partitioned) entry; only "
                             "whole tensors are read")
    return e


def read_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Every variable of a TF (V2 bundle) checkpoint as {name: array}."""
    prefix = _find_prefix(path)
    table = read_index(prefix + ".index")
    if b"" not in table:
        raise ValueError(f"{prefix}.index: no bundle header entry")
    n_shards = 1
    for field, _, val in _proto_fields(table[b""]):
        if field == 1:
            n_shards = val
        elif field == 2 and val != 0:
            raise ValueError(f"{prefix}: a big-endian bundle")
    shards = {}
    out = {}
    for key, value in table.items():
        if key == b"":
            continue
        name = key.decode("utf-8")
        e = _entry(value, name)
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{name}: TF dtype {e['dtype']} is not read")
        dt = np.dtype(DTYPES[e["dtype"]]).newbyteorder("<")
        n = int(np.prod(e["shape"], dtype=np.int64))
        if n * dt.itemsize != e["size"]:
            raise ValueError(f"{name}: {e['size']} bytes for shape "
                             f"{e['shape']} of {dt}")
        if e["shard"] not in shards:
            with open(f"{prefix}.data-{e['shard']:05d}-of-{n_shards:05d}",
                      "rb") as f:
                shards[e["shard"]] = f.read()
        raw = shards[e["shard"]][e["offset"]:e["offset"] + e["size"]]
        if len(raw) != e["size"]:
            raise ValueError(f"{name}: data past the end of its shard")
        out[name] = np.frombuffer(raw, dt).reshape(e["shape"]).astype(
            dt.newbyteorder("="))
    return out


def tf_disc_to_flax(tf_vars: Dict[str, np.ndarray]
                    ) -> Tuple[Dict[str, Any], Dict[str, Any],
                               Dict[str, np.ndarray]]:
    """TF discriminator variables -> (params, batch_stats, extras):
    ReferenceEncoder subtrees ready to graft under
    pretrained_ref_enc_{emt,spk}; extras holds the GE2E w/b and anything
    unmapped."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    extras: Dict[str, np.ndarray] = {}

    def put(tree, path, value):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(value, np.float32)

    for name, value in tf_vars.items():
        parts = name.split("/")
        tail = parts[-3:] if len(parts) >= 3 else parts
        if len(parts) >= 3 and parts[-2] == "conv2d" and \
                parts[-3].startswith("conv2d_"):
            put(params, (parts[-3], tail[-1]), value)
        elif len(parts) >= 3 and parts[-2] == "batch_normalization":
            i = parts[-3].split("_")[-1]
            bn = f"BatchNorm_{i}"
            key = {"gamma": ("params", bn, "scale"),
                   "beta": ("params", bn, "bias"),
                   "moving_mean": ("stats", bn, "mean"),
                   "moving_variance": ("stats", bn, "var")}[parts[-1]]
            put(params if key[0] == "params" else stats, key[1:], value)
        elif "gru_cell" in parts:
            kind = parts[-2]            # gates | candidate
            put(params, ("GRU_0", "GRUCell_0", f"{kind}_{parts[-1]}"), value)
        elif parts[-2:-1] == ["dense"] or (len(parts) >= 2
                                           and parts[-2] == "dense"):
            put(params, ("Dense_0", parts[-1]), value)
        else:
            extras[name] = np.asarray(value)
    return params, stats, extras


def load_tf_disc_checkpoint(path: str) -> dict:
    """Read and convert a reference discriminator checkpoint:
    dict(params=..., batch_stats=..., extras=...)."""
    params, stats, extras = tf_disc_to_flax(read_tf_checkpoint(path))
    return dict(params=params, batch_stats=stats, extras=extras)


def is_tf_checkpoint(path: str) -> bool:
    """True where `path` names a TF checkpoint (a directory holding an
    .index, an .index, or a prefix beside one)."""
    if os.path.isdir(path):
        return bool(glob.glob(os.path.join(path, "*.index")))
    return path.endswith(".index") or os.path.exists(path + ".index")
