"""LightGBM text model format, round-trippable with the reference — a copy
of ``lightgbm_tpu/io/model_text.py``, so a model trained by either package
loads in the other. The proto and JSON formats are not ported yet (ROADMAP
A7) and raise.

Writers/readers for the `Tree=i` block format of
src/boosting/gbdt_model_text.cpp:169-239 (SaveModelToString) /
:241-330 (LoadModelFromString) and src/io/tree.cpp Tree::ToString/:414
(parsing constructor). A model saved here loads in the reference C++ and
vice versa (same keys, same array encodings, same decision_type bit packing).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..tree import Tree
from ..utils.log import Log


def _fmt_double(v: float) -> str:
    if not np.isfinite(v):
        return repr(float(v))
    s = np.format_float_positional(v, precision=17, trim="0", unique=True)
    if float(s) == float(v):
        return s
    # positional precision counts FRACTIONAL digits, so small magnitudes
    # with long mantissas (|v| < ~1e-3, e.g. linear-leaf coefficients, or
    # the -1e-20 zero-boundary threshold) silently truncate — fall back to
    # the exact scientific form (the reference's %.17g does the same)
    return np.format_float_scientific(v, trim="0", unique=True)


def _arr_str(arr, fmt=str) -> str:
    return " ".join(fmt(v) for v in arr)


def _tree_to_string(tree: Tree) -> str:
    M = tree.num_internal
    num_cat = 0 if tree.cat_boundaries is None else len(tree.cat_boundaries) - 1
    lines = [
        f"num_leaves={tree.num_leaves}",
        f"num_cat={num_cat}",
        "split_feature=" + _arr_str(tree.split_feature[:M]),
        "split_gain=" + _arr_str(tree.split_gain[:M], _fmt_double),
        "threshold=" + _arr_str(tree.threshold[:M], _fmt_double),
        "decision_type=" + _arr_str(tree.decision_type[:M].astype(np.int64)),
        "left_child=" + _arr_str(tree.left_child[:M]),
        "right_child=" + _arr_str(tree.right_child[:M]),
        "leaf_value=" + _arr_str(tree.leaf_value[: tree.num_leaves], _fmt_double),
        "leaf_count=" + _arr_str(tree.leaf_count[: tree.num_leaves]),
        "internal_value=" + _arr_str(tree.internal_value[:M], _fmt_double),
        "internal_count=" + _arr_str(tree.internal_count[:M]),
    ]
    if num_cat > 0:
        lines.append("cat_boundaries=" + _arr_str(tree.cat_boundaries))
        lines.append("cat_threshold=" + _arr_str(tree.cat_threshold))
    if tree.leaf_features is not None:
        # piecewise-linear leaves — the later-LightGBM linear_tree block
        # (src/io/tree.cpp Tree::ToString is_linear path): per-leaf counts
        # unflatten the feature/coefficient pools; 17-digit doubles keep
        # the round trip bit-exact like every other float field here
        L = tree.num_leaves
        lines.append("is_linear=1")
        lines.append("leaf_const=" + _arr_str(tree.leaf_const[:L],
                                              _fmt_double))
        lines.append("num_features=" + _arr_str(
            [len(f) for f in tree.leaf_features[:L]]))
        lines.append("leaf_features=" + _arr_str(
            [v for f in tree.leaf_features[:L] for v in f]))
        lines.append("leaf_coeff=" + _arr_str(
            [v for c in tree.leaf_coeff[:L] for v in c], _fmt_double))
    lines.append(f"shrinkage={_fmt_double(tree.shrinkage)}")
    lines.append("")
    return "\n".join(lines)


def _objective_string(booster) -> str:
    from ..objectives import OBJECTIVE_ALIASES
    cfg = booster.config
    name = OBJECTIVE_ALIASES.get(cfg.objective, cfg.objective)
    if name == "binary":
        return f"binary sigmoid:{cfg.sigmoid:g}"
    if name == "multiclass":
        return f"multiclass num_class:{cfg.num_class}"
    if name == "multiclassova":
        return f"multiclassova num_class:{cfg.num_class} sigmoid:{cfg.sigmoid:g}"
    if name == "lambdarank":
        return "lambdarank"
    return name


def _feature_infos(booster) -> List[str]:
    """Per-raw-feature info strings (dataset.h:518-530, bin.h:175-184)."""
    out = []
    mapper_of_real: Dict[int, object] = {}
    if booster.mappers:
        # booster.mappers is indexed by inner feature; map back to raw columns
        for inner, m in enumerate(booster.mappers):
            real = int(booster._real_feature_idx[inner]) if hasattr(
                booster, "_real_feature_idx") else inner
            mapper_of_real[real] = m
    for i in range(booster.num_total_features):
        m = mapper_of_real.get(i)
        if m is None:
            out.append("none")
        elif m.bin_type == "categorical":
            out.append(":".join(str(c) for c in m.bin_2_categorical))
        else:
            out.append(f"[{m.min_val:.17g}:{m.max_val:.17g}]")
    return out


def model_to_string(booster, num_iteration: Optional[int] = None) -> str:
    K = max(booster.num_model_per_iteration, 1)
    trees = booster.trees
    if num_iteration is not None and num_iteration > 0:
        trees = trees[: num_iteration * K]
    ss = ["tree"]
    ss.append(f"num_class={booster.config.num_class}")
    ss.append(f"num_tree_per_iteration={K}")
    ss.append("label_index=0")
    ss.append(f"max_feature_idx={booster.num_total_features - 1}")
    ss.append(f"objective={_objective_string(booster)}")
    if booster.config.boosting_normalized == "rf":
        ss.append("average_output")
    names = booster.feature_names or [f"Column_{i}" for i in range(booster.num_total_features)]
    if any(any(c.isspace() for c in n) for n in names):
        # the text format is space-delimited (reference
        # gbdt_model_text.cpp:190 joins with " " and never validates), so
        # whitespace inside a name mis-splits on reload — warn loudly
        Log.warning("feature names contain whitespace; the text model "
                    "format is space-delimited and will mis-split them "
                    "on load — rename features to round-trip names")
    ss.append("feature_names=" + " ".join(names))
    ss.append("feature_infos=" + " ".join(_feature_infos(booster)))
    ss.append("")
    for i, t in enumerate(trees):
        ss.append(f"Tree={i}")
        ss.append(_tree_to_string(t))
    imp = booster.feature_importance("split")
    pairs = sorted(((int(imp[i]), names[i]) for i in range(len(imp)) if imp[i] > 0),
                   reverse=True)
    ss.append("")
    ss.append("feature importances:")
    for cnt, nm in pairs:
        ss.append(f"{nm}={cnt}")
    if getattr(booster, "pandas_categorical", None) is not None:
        # trailing JSON line, the reference python package's convention for
        # persisting pandas category mappings (basic.py:226-268 save path);
        # default= handles numpy scalars / Timestamps like the reference's
        # json_default_with_numpy
        import json

        def _json_default(o):
            return o.item() if hasattr(o, "item") else str(o)

        ss.append("pandas_categorical:"
                  + json.dumps(booster.pandas_categorical, default=_json_default))
    ss.append("")
    return "\n".join(ss)


def _text_format_only(filename: str, params: dict) -> None:
    if (str(filename).endswith((".proto", ".json"))
            or params.get("model_format") == "proto"):
        Log.fatal("proto and JSON model files are not ported to "
                  "lightgbm_tpu_torch yet (ROADMAP A7): %s", filename)


def save_model_file(booster, filename: str, num_iteration: Optional[int] = None) -> None:
    _text_format_only(filename, booster.params)
    # atomic write: every rank of a distributed run saves (the reference's
    # behavior — each machine keeps a local copy), and same-host ranks must
    # not interleave into a truncated file; tmp-per-pid + rename means the
    # last complete writer wins
    import os
    tmp = f"{filename}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(model_to_string(booster, num_iteration))
    os.replace(tmp, filename)


def _parse_tree_block(lines: Dict[str, str]) -> Tree:
    num_leaves = int(lines["num_leaves"])
    num_cat = int(lines.get("num_cat", "0"))
    M = num_leaves - 1

    def ints(key, n, default=0):
        if key not in lines or not lines[key].strip():
            return np.full(n, default, dtype=np.int64)
        return np.array([int(float(t)) for t in lines[key].split()], dtype=np.int64)[:n]

    def floats(key, n):
        if key not in lines or not lines[key].strip():
            return np.zeros(n)
        return np.array([float(t) for t in lines[key].split()], dtype=np.float64)[:n]

    thresholds = floats("threshold", M)
    decision_types = ints("decision_type", M).astype(np.uint8)
    # for categorical nodes `threshold` holds the cat_boundaries index
    # (reference tree.cpp ToString); keep it addressable via threshold_bin.
    # Numerical thresholds may be inf (top bin) — cast only cat nodes.
    is_cat_node = (decision_types & 1).astype(bool)
    threshold_bin = np.zeros(M, dtype=np.int32)
    threshold_bin[is_cat_node] = thresholds[is_cat_node].astype(np.int32)
    tree = Tree(
        num_leaves=num_leaves,
        split_feature=ints("split_feature", M).astype(np.int32),
        threshold_bin=threshold_bin,
        threshold=thresholds,
        decision_type=decision_types,
        left_child=ints("left_child", M).astype(np.int32),
        right_child=ints("right_child", M).astype(np.int32),
        split_gain=floats("split_gain", M),
        internal_value=floats("internal_value", M),
        internal_count=ints("internal_count", M),
        leaf_value=floats("leaf_value", num_leaves),
        leaf_count=ints("leaf_count", num_leaves),
        leaf_parent=np.full(num_leaves, -1, dtype=np.int32),
        shrinkage=float(lines.get("shrinkage", "1")),
    )
    if num_cat > 0:
        tree.cat_boundaries = ints("cat_boundaries", num_cat + 1).astype(np.int32)
        nthr = int(tree.cat_boundaries[-1])
        tree.cat_threshold = ints("cat_threshold", nthr).astype(np.uint32)
    if int(lines.get("is_linear", "0")):
        nf = ints("num_features", num_leaves).astype(np.int64)
        total = int(nf.sum())
        flat_f = ints("leaf_features", total).astype(np.int32)
        flat_c = floats("leaf_coeff", total)
        feats, coeffs, off = [], [], 0
        for k in nf:
            feats.append(flat_f[off: off + k])
            coeffs.append(flat_c[off: off + k])
            off += int(k)
        tree.leaf_features = feats
        tree.leaf_coeff = coeffs
        tree.leaf_const = floats("leaf_const", num_leaves)
    return tree


def apply_model_header(booster, objective_str, num_class, average_output
                       ) -> None:
    """Shared booster-metadata rehydration tail of every model loader
    (text/proto/JSON): split the objective string into its name and
    ``key:value`` params (``binary sigmoid:2.5``), restore num_class, and
    apply the rf/average_output bagging defaults — then rebuild the
    Config so prediction transforms (sigmoid, softmax, rf averaging) match
    the model that was saved. One implementation: the three formats cannot
    drift on what a loaded model's objective means."""
    params = dict(booster.params)
    toks = (objective_str or "regression").split()
    params["objective"] = toks[0]
    for tok in toks[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            params[k] = v
    params["num_class"] = int(num_class or 1)
    if average_output:
        params["boosting_type"] = "rf"
        params.setdefault("bagging_freq", 1)
        params.setdefault("bagging_fraction", 0.5)
    from ..config import Config
    booster.config = Config.from_params(params)
    booster.params = params


def load_model_string(booster, model_str: str) -> None:
    lines = model_str.splitlines()
    header: Dict[str, str] = {}
    i = 0
    trees: List[Tree] = []
    average_output = False
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            block: Dict[str, str] = {}
            i += 1
            while i < len(lines) and lines[i].strip() and "=" in lines[i]:
                k, v = lines[i].split("=", 1)
                block[k.strip()] = v.strip()
                i += 1
            trees.append(_parse_tree_block(block))
            continue
        if line == "average_output":
            average_output = True
        elif "=" in line and not line.startswith("feature importances"):
            k, v = line.split("=", 1)
            header[k.strip()] = v.strip()
        elif line == "feature importances:":
            break
        i += 1

    booster.trees = trees
    booster._forest_rev = getattr(booster, "_forest_rev", 0) + 1
    booster.num_model_per_iteration = int(header.get("num_tree_per_iteration", "1"))
    booster.num_total_features = int(header.get("max_feature_idx", "-1")) + 1
    booster.feature_names = header.get("feature_names", "").split()
    apply_model_header(booster, header.get("objective", "regression"),
                       int(header.get("num_class", "1")), average_output)
    for line in reversed(lines[-5:]):        # trailing JSON convention
        if line.startswith("pandas_categorical:"):
            import json
            try:
                booster.pandas_categorical = json.loads(
                    line[len("pandas_categorical:"):])
            except ValueError:
                pass
            break


def load_model_file(booster, filename: str) -> None:
    _text_format_only(filename, booster.params)
    with open(filename, "r") as fh:
        load_model_string(booster, fh.read())
