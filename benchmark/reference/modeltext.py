"""LightGBM's text model format, read and written in plain Python.

The benchmark reads the program's model only through this format: the
reference judges the trees the program grew and walks the forests it
scores from their text, never from the program's objects. The writer
serves the scoring cell, whose forest the benchmark makes itself.

A tree holds, as numpy arrays: ``split_feature``, ``threshold`` (f64),
``decision_type`` (bit 1: NaN goes left; bits 2-3: missing type, 0 none,
1 zero, 2 NaN), ``left_child`` / ``right_child`` (a child ``>= 0`` is an
internal node, ``~c`` is leaf ``c``), ``leaf_value``, ``leaf_count``,
``internal_value`` and ``internal_count``. Internal node ``i`` is the
``i``-th split of the tree's growth.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

MISSING_NONE, MISSING_ZERO, MISSING_NAN = 0, 1, 2
DEFAULT_LEFT = 2


def _ints(s: str) -> np.ndarray:
    return np.array([int(float(t)) for t in s.split()], dtype=np.int64)


def _floats(s: str) -> np.ndarray:
    return np.array([float(t) for t in s.split()], dtype=np.float64)


def parse(text: str) -> Dict:
    """``{"header": {key: value}, "trees": [tree, ...]}`` of a model text."""
    header: Dict[str, str] = {}
    trees: List[Dict[str, np.ndarray]] = []
    block = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Tree="):
            block = {}
            trees.append(block)
            continue
        if line == "feature importances:":
            break
        if not line:
            block = None
            continue
        if "=" not in line:
            continue
        key, value = line.split("=", 1)
        if block is None:
            header[key] = value
        else:
            block[key] = value
    out = []
    for b in trees:
        n_leaves = int(b["num_leaves"])
        if int(b.get("num_cat", "0")):
            raise ValueError("the reference walks numerical splits only")
        t = {"num_leaves": n_leaves,
             "leaf_value": _floats(b["leaf_value"])[:n_leaves],
             "leaf_count": _ints(b.get("leaf_count", "0 " * n_leaves)),
             "shrinkage": float(b.get("shrinkage", "1"))}
        for key in ("split_feature", "decision_type", "left_child",
                    "right_child", "internal_count"):
            t[key] = _ints(b[key]) if n_leaves > 1 and b.get(key) \
                else np.zeros(0, np.int64)
        for key in ("threshold", "internal_value"):
            t[key] = _floats(b[key]) if n_leaves > 1 and b.get(key) \
                else np.zeros(0, np.float64)
        out.append(t)
    return {"header": header, "trees": out}


def _num(v: float) -> str:
    return repr(float(v))


def write(trees: List[Dict], num_features: int, objective: str,
          feature_infos: List[str]) -> str:
    """The text of a forest of numerical trees, one model per iteration."""
    names = [f"Column_{i}" for i in range(num_features)]
    lines = ["tree", "version=v2", "num_class=1", "num_tree_per_iteration=1",
             "label_index=0", f"max_feature_idx={num_features - 1}",
             f"objective={objective}", "feature_names=" + " ".join(names),
             "feature_infos=" + " ".join(feature_infos), ""]
    for i, t in enumerate(trees):
        lines += [f"Tree={i}", f"num_leaves={t['num_leaves']}", "num_cat=0",
                  "split_feature=" + " ".join(map(str, t["split_feature"])),
                  "split_gain=" + " ".join("1" for _ in t["split_feature"]),
                  "threshold=" + " ".join(map(_num, t["threshold"])),
                  "decision_type=" + " ".join(map(str, t["decision_type"])),
                  "left_child=" + " ".join(map(str, t["left_child"])),
                  "right_child=" + " ".join(map(str, t["right_child"])),
                  "leaf_value=" + " ".join(map(_num, t["leaf_value"])),
                  "leaf_count=" + " ".join(map(str, t["leaf_count"])),
                  "internal_value=" + " ".join(map(_num,
                                                   t["internal_value"])),
                  "internal_count=" + " ".join(map(str,
                                                   t["internal_count"])),
                  f"shrinkage={_num(t['shrinkage'])}", ""]
    lines += ["", "feature importances:", ""]
    return "\n".join(lines)


def depth_of(tree: Dict) -> int:
    """The longest root-to-leaf path of a tree, in splits."""
    if tree["num_leaves"] <= 1:
        return 0
    depth = np.zeros(len(tree["split_feature"]), np.int64)
    best = 0
    for i in range(len(depth)):       # a parent's index is below its child's
        for c in (tree["left_child"][i], tree["right_child"][i]):
            if c >= 0:
                depth[c] = depth[i] + 1
            else:
                best = max(best, int(depth[i]) + 1)
    return best


def parents(tree: Dict):
    """``(parent of each internal node, parent of each leaf)``; -1 at the
    root."""
    m = len(tree["split_feature"])
    p_int = np.full(m, -1, np.int64)
    p_leaf = np.full(tree["num_leaves"], -1, np.int64)
    for i in range(m):
        for c in (tree["left_child"][i], tree["right_child"][i]):
            if c >= 0:
                p_int[c] = i
            else:
                p_leaf[~c] = i
    return p_int, p_leaf
