"""JSON model dump + load — a copy of ``lightgbm_tpu/io/model_json.py``
(reference: GBDT::DumpModel
gbdt_model_text.cpp:13-48, Tree::ToJSON / NodeToJSON src/io/tree.cpp).

The loader re-hydrates the dump into model-space ``Tree`` objects so the
serving engine can ingest JSON artifacts next to text/proto. The
objective serializes as the full parameterized string
(``binary sigmoid:2.5``) exactly like the text/proto writers, so
prediction transforms survive the round trip; the one lossy corner (the
reference's own convention) is infinite thresholds clamping to 1e308 —
prefer protobuf for production round trips."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, Tree
from .model_text import _objective_string

_MISSING_NAMES = {0: "None", 1: "Zero", 2: "NaN"}
_MISSING_CODES = {v: k for k, v in _MISSING_NAMES.items()}


def _node_to_dict(tree: Tree, index: int) -> Dict:
    if index >= 0:
        dt = int(tree.decision_type[index])
        node = {
            "split_index": index,
            "split_feature": int(tree.split_feature[index]),
            "split_gain": float(tree.split_gain[index]),
        }
        if dt & K_CATEGORICAL_MASK:
            cat_idx = int(tree.threshold_bin[index])
            lo, hi = tree.cat_boundaries[cat_idx], tree.cat_boundaries[cat_idx + 1]
            bitset = tree.cat_threshold[lo:hi]
            cats = [i * 32 + j for i in range(len(bitset)) for j in range(32)
                    if (bitset[i] >> j) & 1]
            node["threshold"] = "||".join(str(c) for c in cats)
            node["decision_type"] = "=="
        else:
            thr = float(tree.threshold[index])
            node["threshold"] = 1e308 if np.isinf(thr) else thr
            node["decision_type"] = "<="
        node["default_left"] = bool(dt & K_DEFAULT_LEFT_MASK)
        node["missing_type"] = _MISSING_NAMES[(dt >> 2) & 3]
        node["internal_value"] = float(tree.internal_value[index])
        node["internal_count"] = int(tree.internal_count[index])
        node["left_child"] = _node_to_dict(tree, int(tree.left_child[index]))
        node["right_child"] = _node_to_dict(tree, int(tree.right_child[index]))
        return node
    leaf = ~index
    out = {
        "leaf_index": leaf,
        "leaf_value": float(tree.leaf_value[leaf]),
        "leaf_count": int(tree.leaf_count[leaf]),
    }
    if tree.leaf_features is not None and len(tree.leaf_features[leaf]):
        # linear leaf (later-LightGBM dump_model convention): intercept +
        # per-feature coefficients; leaf_value stays the NaN fallback
        out["leaf_const"] = float(tree.leaf_const[leaf])
        out["leaf_features"] = [int(f) for f in tree.leaf_features[leaf]]
        out["leaf_coeff"] = [float(c) for c in tree.leaf_coeff[leaf]]
    return out


def _tree_to_dict(tree: Tree) -> Dict:
    num_cat = 0 if tree.cat_boundaries is None else len(tree.cat_boundaries) - 1
    out = {"num_leaves": tree.num_leaves, "num_cat": num_cat,
           "shrinkage": tree.shrinkage}
    if tree.num_leaves == 1:
        out["tree_structure"] = {"leaf_value": float(tree.leaf_value[0])}
    else:
        out["tree_structure"] = _node_to_dict(tree, 0)
    return out


def dump_model_dict(booster, num_iteration: Optional[int] = None) -> Dict:
    K = max(booster.num_model_per_iteration, 1)
    trees = booster.trees
    if num_iteration is not None and num_iteration > 0:
        trees = trees[: num_iteration * K]
    names = booster.feature_names or \
        [f"Column_{i}" for i in range(booster.num_total_features)]
    return {
        "name": "tree",
        "version": "v2",
        "num_class": booster.config.num_class,
        "num_tree_per_iteration": K,
        "label_index": 0,
        "max_feature_idx": booster.num_total_features - 1,
        # full objective string WITH params (``binary sigmoid:2.5``), like
        # the text/proto writers — the bare name loses sigmoid/num_class
        # and a reloaded model would transform predictions differently
        "objective": _objective_string(booster),
        "average_output": booster.config.boosting_normalized == "rf",
        "feature_names": names,
        "tree_info": [dict(tree_index=i, **_tree_to_dict(t))
                      for i, t in enumerate(trees)],
    }


# ------------------------------------------------------------------ loading

def _tree_from_dict(d: Dict) -> Tree:
    """Inverse of ``_tree_to_dict``: flatten the nested node dict back into
    model-space arrays (pre-order over split_index/leaf_index)."""
    num_leaves = int(d["num_leaves"])
    M = max(num_leaves - 1, 0)
    split_feature = np.zeros(M, np.int32)
    threshold_bin = np.zeros(M, np.int32)
    threshold = np.zeros(M, np.float64)
    decision_type = np.zeros(M, np.uint8)
    left_child = np.zeros(M, np.int32)
    right_child = np.zeros(M, np.int32)
    split_gain = np.zeros(M, np.float64)
    internal_value = np.zeros(M, np.float64)
    internal_count = np.zeros(M, np.int64)
    leaf_value = np.zeros(max(num_leaves, 1), np.float64)
    leaf_count = np.zeros(max(num_leaves, 1), np.int64)
    cat_boundaries: List[int] = [0]
    cat_words: List[np.ndarray] = []
    leaf_const = np.zeros(max(num_leaves, 1), np.float64)
    leaf_features: List[np.ndarray] = [np.zeros(0, np.int32)
                                       for _ in range(max(num_leaves, 1))]
    leaf_coeff: List[np.ndarray] = [np.zeros(0, np.float64)
                                    for _ in range(max(num_leaves, 1))]
    has_linear = [False]

    def child_index(node: Dict) -> int:
        return int(node["split_index"]) if "split_index" in node \
            else ~int(node.get("leaf_index", 0))

    def walk(node: Dict) -> None:
        if "split_index" not in node:
            leaf = int(node.get("leaf_index", 0))
            leaf_value[leaf] = float(node["leaf_value"])
            leaf_count[leaf] = int(node.get("leaf_count", 0))
            if node.get("leaf_features"):
                has_linear[0] = True
                leaf_const[leaf] = float(node.get("leaf_const", 0.0))
                leaf_features[leaf] = np.asarray(node["leaf_features"],
                                                 np.int32)
                leaf_coeff[leaf] = np.asarray(
                    node.get("leaf_coeff", []), np.float64)
            return
        i = int(node["split_index"])
        split_feature[i] = int(node["split_feature"])
        split_gain[i] = float(node.get("split_gain", 0.0))
        internal_value[i] = float(node.get("internal_value", 0.0))
        internal_count[i] = int(node.get("internal_count", 0))
        dt = 0
        if node.get("decision_type") == "==":
            dt |= K_CATEGORICAL_MASK
            cats = [int(c) for c in str(node["threshold"]).split("||") if c]
            n_words = (max(cats) // 32 + 1) if cats else 1
            words = np.zeros(n_words, np.uint32)
            for c in cats:
                words[c // 32] |= np.uint32(1) << np.uint32(c % 32)
            cat_idx = len(cat_boundaries) - 1
            threshold_bin[i] = cat_idx
            threshold[i] = float(cat_idx)
            cat_boundaries.append(cat_boundaries[-1] + n_words)
            cat_words.append(words)
        else:
            threshold[i] = float(node["threshold"])
        if node.get("default_left"):
            dt |= K_DEFAULT_LEFT_MASK
        dt |= _MISSING_CODES.get(node.get("missing_type", "None"), 0) << 2
        decision_type[i] = dt
        left_child[i] = child_index(node["left_child"])
        right_child[i] = child_index(node["right_child"])
        walk(node["left_child"])
        walk(node["right_child"])

    root = d.get("tree_structure") or {}
    if num_leaves <= 1:
        leaf_value[0] = float(root.get("leaf_value", 0.0))
    else:
        walk(root)
    has_cat = len(cat_words) > 0
    return Tree(
        num_leaves=num_leaves,
        split_feature=split_feature, threshold_bin=threshold_bin,
        threshold=threshold, decision_type=decision_type,
        left_child=left_child, right_child=right_child,
        split_gain=split_gain, internal_value=internal_value,
        internal_count=internal_count, leaf_value=leaf_value,
        leaf_count=leaf_count,
        leaf_parent=np.full(max(num_leaves, 1), -1, np.int32),
        shrinkage=float(d.get("shrinkage", 1.0)),
        cat_boundaries=np.asarray(cat_boundaries, np.int32)
        if has_cat else None,
        cat_threshold=np.concatenate(cat_words).astype(np.uint32)
        if has_cat else None,
        leaf_features=leaf_features if has_linear[0] else None,
        leaf_coeff=leaf_coeff if has_linear[0] else None,
        leaf_const=leaf_const if has_linear[0] else None,
    )


def load_model_dict(booster, doc: Dict) -> None:
    """Re-hydrate a ``dump_model``-shaped dict into ``booster``."""
    from .model_text import apply_model_header
    booster.trees = [_tree_from_dict(t) for t in doc.get("tree_info", [])]
    booster._forest_rev = getattr(booster, "_forest_rev", 0) + 1
    booster.num_model_per_iteration = int(
        doc.get("num_tree_per_iteration", 1)) or 1
    booster.num_total_features = int(doc.get("max_feature_idx", -1)) + 1
    booster.feature_names = list(doc.get("feature_names", []))
    apply_model_header(booster, doc.get("objective"),
                       int(doc.get("num_class", 1)) or 1,
                       doc.get("average_output"))


def save_model_json(booster, filename: str,
                    num_iteration: Optional[int] = None) -> None:
    """Write the ``dump_model`` dict as a .json artifact (atomic, like the
    text/proto writers) — the symmetric half of ``load_model_json`` so
    ``save_model("m.json")`` round-trips through its own loader."""
    from ..observability.export import atomic_write_json
    atomic_write_json(filename, dump_model_dict(booster, num_iteration),
                      trailing_newline=True)


def load_model_json(booster, filename: str) -> None:
    import json
    with open(filename, "r") as fh:
        load_model_dict(booster, json.load(fh))
