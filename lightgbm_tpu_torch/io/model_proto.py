"""Protobuf model format — the reference fork's differentiator — with its
own proto3 wire codec.

A copy of ``lightgbm_tpu/io/model_proto.py`` (reference: proto/model.proto
+ src/proto/gbdt_model_proto.cpp, SaveModelToProto / LoadModelFromProto,
boosting.h:194-208), except that the JAX package serialises through the
``model_pb2`` module protoc generated (which needs ``google.protobuf``),
while this module encodes and decodes the wire format of
``proto/model.proto`` itself:

- writing, as protobuf's own serialiser does: fields in field-number
  order; proto3 defaults omitted (0, ``false``, ``""``, an empty repeated
  field; a double is omitted only when its bits are zero, so ``-0.0`` is
  written); varints; zig-zag ``sint32``; little-endian fixed64 doubles;
  repeated scalars packed; strings and sub-messages length-delimited.
  The bytes equal ``model_pb2``'s for the same model
  (``tests/test_torch_model_io.py``);
- reading, as a proto3 parser must: packed and unpacked repeated scalars
  alike, and unknown fields skipped.
"""
from __future__ import annotations

import os
import struct
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..tree import Tree
from .model_text import _feature_infos, _objective_string

# ---------------------------------------------------------------- schema
# field number -> (name, type); "rep_" marks a repeated field. Types:
# uint32, sint32, bool, double, string, and the nested message "tree".

_TREE_FIELDS: Dict[int, Tuple[str, str]] = {
    1: ("num_leaves", "uint32"),
    2: ("num_cat", "uint32"),
    3: ("split_feature", "rep_uint32"),
    4: ("split_gain", "rep_double"),
    5: ("threshold", "rep_double"),
    6: ("decision_type", "rep_uint32"),
    7: ("left_child", "rep_sint32"),
    8: ("right_child", "rep_sint32"),
    9: ("leaf_value", "rep_double"),
    10: ("leaf_count", "rep_uint32"),
    11: ("internal_value", "rep_double"),
    12: ("internal_count", "rep_double"),
    13: ("cat_boundaries", "rep_sint32"),
    14: ("cat_threshold", "rep_uint32"),
    15: ("shrinkage", "double"),
    16: ("is_linear", "bool"),
    17: ("leaf_const", "rep_double"),
    18: ("leaf_num_features", "rep_uint32"),
    19: ("leaf_features", "rep_uint32"),
    20: ("leaf_coeff", "rep_double"),
}

_MODEL_FIELDS: Dict[int, Tuple[str, str]] = {
    1: ("name", "string"),
    2: ("num_class", "uint32"),
    3: ("num_tree_per_iteration", "uint32"),
    4: ("label_index", "uint32"),
    5: ("max_feature_idx", "uint32"),
    6: ("objective", "string"),
    7: ("average_output", "bool"),
    8: ("feature_names", "rep_string"),
    9: ("feature_infos", "rep_string"),
    10: ("trees", "rep_tree"),
}

_SCHEMAS = {"model": _MODEL_FIELDS, "tree": _TREE_FIELDS}
_DEFAULTS = {"uint32": 0, "sint32": 0, "bool": False, "double": 0.0,
             "string": ""}

_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5
_UINT32_MAX = (1 << 32) - 1


def new_message(kind: str) -> SimpleNamespace:
    """A message of ``kind`` ("model" or "tree") with every field at its
    proto3 default."""
    return SimpleNamespace(**{
        name: [] if typ.startswith("rep_") else _DEFAULTS[typ]
        for name, typ in _SCHEMAS[kind].values()})


# ---------------------------------------------------------------- writing

def _varint(v: int, out: bytearray) -> None:
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _uint32(v, field: str) -> int:
    v = int(v)
    if not 0 <= v <= _UINT32_MAX:
        raise ValueError(f"Value out of range for uint32 field {field}: {v}")
    return v


def _zigzag32(v) -> int:
    v = int(v)
    if not -(1 << 31) <= v < (1 << 31):
        raise ValueError(f"Value out of range for sint32: {v}")
    return ((v << 1) ^ (v >> 31)) & _UINT32_MAX


def _encode_scalar(typ: str, v, name: str, out: bytearray) -> None:
    """One value's payload (no key)."""
    if typ == "uint32":
        _varint(_uint32(v, name), out)
    elif typ == "sint32":
        _varint(_zigzag32(v), out)
    elif typ == "bool":
        out.append(1 if v else 0)
    elif typ == "double":
        out += struct.pack("<d", float(v))
    else:
        raise TypeError(typ)


def _is_default(typ: str, v) -> bool:
    if typ == "double":
        # implicit presence: omitted only when the bits are zero
        return struct.pack("<d", float(v)) == b"\0" * 8
    if typ == "string":
        return v == ""
    return not v


def encode(msg, kind: str = "model") -> bytes:
    """Serialise a message (attributes named as in ``proto/model.proto``)."""
    out = bytearray()
    for num in sorted(_SCHEMAS[kind]):
        name, typ = _SCHEMAS[kind][num]
        v = getattr(msg, name)
        if typ == "rep_tree":
            for sub in v:
                body = encode(sub, "tree")
                _varint(num << 3 | _WT_LEN, out)
                _varint(len(body), out)
                out += body
        elif typ == "rep_string":
            for s in v:
                raw = s.encode("utf-8")
                _varint(num << 3 | _WT_LEN, out)
                _varint(len(raw), out)
                out += raw
        elif typ.startswith("rep_"):
            if len(v) == 0:
                continue
            body = bytearray()
            base = typ[4:]
            if base == "double":
                body += np.asarray(v, dtype="<f8").tobytes()
            else:
                for x in v:
                    _encode_scalar(base, x, name, body)
            _varint(num << 3 | _WT_LEN, out)
            _varint(len(body), out)
            out += body
        elif typ == "string":
            if _is_default(typ, v):
                continue
            raw = v.encode("utf-8")
            _varint(num << 3 | _WT_LEN, out)
            _varint(len(raw), out)
            out += raw
        else:
            if _is_default(typ, v):
                continue
            wt = _WT_I64 if typ == "double" else _WT_VARINT
            _varint(num << 3 | wt, out)
            _encode_scalar(typ, v, name, out)
    return bytes(out)


# ---------------------------------------------------------------- reading

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, pos
        shift += 7
        if shift >= 64:
            raise ValueError("varint longer than 10 bytes")


def _from_varint(typ: str, v: int):
    if typ == "uint32":
        return v & _UINT32_MAX
    if typ == "sint32":
        v &= _UINT32_MAX
        return (v >> 1) ^ -(v & 1)
    if typ == "bool":
        return v != 0
    raise ValueError(f"a varint cannot carry a {typ} field")


def _skip(buf: bytes, pos: int, wt: int) -> int:
    if wt == _WT_VARINT:
        return _read_varint(buf, pos)[1]
    if wt == _WT_I64:
        return pos + 8
    if wt == _WT_I32:
        return pos + 4
    if wt == _WT_LEN:
        n, pos = _read_varint(buf, pos)
        return pos + n
    raise ValueError(f"unsupported wire type {wt}")


def decode(buf: bytes, kind: str = "model") -> SimpleNamespace:
    """Parse a message of ``kind``: repeated scalars packed or unpacked,
    unknown fields skipped, a repeated scalar's values appended in the
    order they come."""
    schema = _SCHEMAS[kind]
    msg = new_message(kind)
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        num, wt = key >> 3, key & 7
        if num not in schema:
            pos = _skip(buf, pos, wt)
            continue
        name, typ = schema[num]
        base = typ[4:] if typ.startswith("rep_") else typ
        if wt == _WT_LEN:
            n, pos = _read_varint(buf, pos)
            chunk = buf[pos:pos + n]
            if len(chunk) != n:
                raise ValueError("truncated length-delimited field")
            pos += n
            if base == "tree":
                getattr(msg, name).append(decode(chunk, "tree"))
            elif base == "string":
                s = chunk.decode("utf-8")
                if typ.startswith("rep_"):
                    getattr(msg, name).append(s)
                else:
                    setattr(msg, name, s)
            elif base == "double":          # packed doubles
                getattr(msg, name).extend(
                    np.frombuffer(chunk, dtype="<f8").tolist())
            else:                           # packed varints
                vals, p = getattr(msg, name), 0
                while p < n:
                    v, p = _read_varint(chunk, p)
                    vals.append(_from_varint(base, v))
            continue
        if wt == _WT_VARINT:
            v, pos = _read_varint(buf, pos)
            v = _from_varint(base, v)
        elif wt == _WT_I64 and base == "double":
            v = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        else:
            raise ValueError(f"wire type {wt} does not match field {name} "
                             f"({typ})")
        if typ.startswith("rep_"):          # one unpacked element
            getattr(msg, name).append(v)
        else:
            setattr(msg, name, v)
    return msg


# ------------------------------------------------------ model <-> message

def _tree_to_proto(t: Tree, msg) -> None:
    M = t.num_internal
    msg.num_leaves = t.num_leaves
    num_cat = 0 if t.cat_boundaries is None else len(t.cat_boundaries) - 1
    msg.num_cat = num_cat
    msg.split_feature.extend(int(v) for v in t.split_feature[:M])
    msg.split_gain.extend(float(v) for v in t.split_gain[:M])
    msg.threshold.extend(float(v) for v in t.threshold[:M])
    msg.decision_type.extend(int(v) for v in t.decision_type[:M])
    msg.left_child.extend(int(v) for v in t.left_child[:M])
    msg.right_child.extend(int(v) for v in t.right_child[:M])
    msg.leaf_value.extend(float(v) for v in t.leaf_value[: t.num_leaves])
    msg.leaf_count.extend(int(v) for v in t.leaf_count[: t.num_leaves])
    msg.internal_value.extend(float(v) for v in t.internal_value[:M])
    msg.internal_count.extend(float(v) for v in t.internal_count[:M])
    if num_cat > 0:
        msg.cat_boundaries.extend(int(v) for v in t.cat_boundaries)
        msg.cat_threshold.extend(int(v) for v in t.cat_threshold)
    if t.leaf_features is not None:
        # linear leaves: flattened pools + per-leaf counts (proto fields
        # 16-20; doubles are wire-exact, so the round trip is bit-exact)
        msg.is_linear = True
        msg.leaf_const.extend(float(v) for v in t.leaf_const[: t.num_leaves])
        msg.leaf_num_features.extend(
            len(f) for f in t.leaf_features[: t.num_leaves])
        msg.leaf_features.extend(
            int(v) for f in t.leaf_features[: t.num_leaves] for v in f)
        msg.leaf_coeff.extend(
            float(v) for c in t.leaf_coeff[: t.num_leaves] for v in c)
    msg.shrinkage = float(t.shrinkage)


def _tree_from_proto(msg) -> Tree:
    num_leaves = msg.num_leaves
    M = num_leaves - 1
    thresholds = np.array(msg.threshold[:M], dtype=np.float64)
    decision_types = np.array(msg.decision_type[:M], dtype=np.uint8)
    # categorical nodes store their cat_boundaries index in `threshold`
    # (same convention as the text format, tree.cpp ToString) — it must
    # come back as threshold_bin or every categorical split dereferences
    # bitset 0 after a proto round trip
    is_cat_node = (decision_types & 1).astype(bool)
    threshold_bin = np.zeros(M, dtype=np.int32)
    threshold_bin[is_cat_node] = thresholds[is_cat_node].astype(np.int32)
    tree = Tree(
        num_leaves=num_leaves,
        split_feature=np.array(msg.split_feature[:M], dtype=np.int32),
        threshold_bin=threshold_bin,
        threshold=thresholds,
        decision_type=decision_types,
        left_child=np.array(msg.left_child[:M], dtype=np.int32),
        right_child=np.array(msg.right_child[:M], dtype=np.int32),
        split_gain=np.array(msg.split_gain[:M], dtype=np.float64),
        internal_value=np.array(msg.internal_value[:M], dtype=np.float64),
        internal_count=np.array(msg.internal_count[:M], dtype=np.int64),
        leaf_value=np.array(msg.leaf_value[:num_leaves], dtype=np.float64),
        leaf_count=np.array(msg.leaf_count[:num_leaves], dtype=np.int64),
        leaf_parent=np.full(max(num_leaves, 1), -1, dtype=np.int32),
        shrinkage=msg.shrinkage or 1.0,
    )
    if msg.num_cat > 0:
        tree.cat_boundaries = np.array(msg.cat_boundaries, dtype=np.int32)
        tree.cat_threshold = np.array(msg.cat_threshold, dtype=np.uint32)
    if msg.is_linear:
        flat_f = np.array(msg.leaf_features, dtype=np.int32)
        flat_c = np.array(msg.leaf_coeff, dtype=np.float64)
        feats, coeffs, off = [], [], 0
        for k in msg.leaf_num_features:
            feats.append(flat_f[off: off + k])
            coeffs.append(flat_c[off: off + k])
            off += int(k)
        tree.leaf_features = feats
        tree.leaf_coeff = coeffs
        tree.leaf_const = np.array(msg.leaf_const, dtype=np.float64)
    return tree


def model_to_proto_bytes(booster, num_iteration: Optional[int] = None
                         ) -> bytes:
    """The serialised ``Model`` message of ``booster``'s forest."""
    K = max(booster.num_model_per_iteration, 1)
    trees = booster.trees
    if num_iteration is not None and num_iteration > 0:
        trees = trees[: num_iteration * K]
    m = new_message("model")
    m.name = "tree"
    m.num_class = booster.config.num_class
    m.num_tree_per_iteration = K
    m.label_index = 0
    m.max_feature_idx = booster.num_total_features - 1
    m.objective = _objective_string(booster)
    m.average_output = booster.config.boosting_normalized == "rf"
    m.feature_names.extend(booster.feature_names or
                           [f"Column_{i}" for i in range(booster.num_total_features)])
    m.feature_infos.extend(_feature_infos(booster))
    trees_msgs: List[SimpleNamespace] = []
    for t in trees:
        tm = new_message("tree")
        _tree_to_proto(t, tm)
        trees_msgs.append(tm)
    m.trees = trees_msgs
    return encode(m)


def save_model_proto(booster, filename: str, num_iteration: Optional[int] = None) -> None:
    raw = model_to_proto_bytes(booster, num_iteration)
    # atomic, like the text writer: concurrent same-host writers must not
    # interleave into a truncated file
    tmp = f"{filename}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(raw)
    os.replace(tmp, filename)


def load_model_proto(booster, filename: str) -> None:
    with open(filename, "rb") as fh:
        m = decode(fh.read())
    booster.trees = [_tree_from_proto(t) for t in m.trees]
    booster._forest_rev = getattr(booster, "_forest_rev", 0) + 1
    booster.num_model_per_iteration = m.num_tree_per_iteration or 1
    booster.num_total_features = m.max_feature_idx + 1
    booster.feature_names = list(m.feature_names)
    from .model_text import apply_model_header
    apply_model_header(booster, m.objective, m.num_class, m.average_output)
