"""If-else C++ code generation for a trained forest — a copy of
``lightgbm_tpu/io/codegen.py``, emitting the same text.

Reference counterpart: Tree::ToIfElse (src/io/tree.cpp) +
GBDT::SaveModelToIfElse (src/boosting/gbdt_model_text.cpp), used by the
reference CI as its tree-semantics oracle (train -> convert -> recompile ->
compare predictions bit-for-bit; .travis/test.sh TASK=if-else, SURVEY.md §4).

Emits a standalone translation unit:

    extern "C" void PredictRaw(const double* features, double* out);   // [K]
    extern "C" double PredictRawSingle(const double* features);        // K==1

compilable with plain `g++ -O2 -shared -fPIC`, and used the same way as the
reference's oracle by tests/test_torch_model_io.py (compile via g++, drive
through ctypes, compare against Booster.predict).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..binning import K_ZERO_RANGE
from ..tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, Tree


def _leaf_code(tree: Tree, leaf: int) -> str:
    """Leaf return expression: the constant, or — linear leaves
    (linear_tree=true) — the guarded dot product. Evaluation order is
    ``((const + c0*f0) + c1*f1) ...``, the EXACT left-to-right sequence
    ``Tree.leaf_outputs`` (and therefore Booster.predict and the serving
    engine) accumulates in, so the compiled oracle stays bit-identical."""
    const_v = f"{float(tree.leaf_value[leaf]):.17g}"
    if tree.leaf_features is None or not len(tree.leaf_features[leaf]):
        return f"return {const_v};"
    feats = tree.leaf_features[leaf]
    coeff = tree.leaf_coeff[leaf]
    nan_guard = " || ".join(f"std::isnan(features[{int(f)}])"
                            for f in feats)
    expr = f"{float(tree.leaf_const[leaf]):.17g}"
    for f, c in zip(feats, coeff):
        expr = f"({expr} + {float(c):.17g} * features[{int(f)}])"
    return f"return ({nan_guard}) ? {const_v} : {expr};"


def _node_code(tree: Tree, node: int, indent: str, lines: List[str],
               tree_idx: int) -> None:
    if node < 0:
        lines.append(f"{indent}{_leaf_code(tree, ~node)}")
        return
    dt = int(tree.decision_type[node])
    feat = int(tree.split_feature[node])
    fv = f"features[{feat}]"
    if dt & K_CATEGORICAL_MASK:
        cat_idx = int(tree.threshold_bin[node])
        lo = int(tree.cat_boundaries[cat_idx])
        hi = int(tree.cat_boundaries[cat_idx + 1])
        cond = (f"InBitset(kCatBits{tree_idx} + {lo}, {hi - lo}, {fv})")
    else:
        thr = float(tree.threshold[node])
        missing_type = (dt >> 2) & 3
        default_left = bool(dt & K_DEFAULT_LEFT_MASK)
        le = f"{fv} <= {thr:.17g}"
        if missing_type == 0:          # none: NaN treated as 0 (tree.h:218-232)
            cond = f"(std::isnan({fv}) ? 0.0 : {fv}) <= {thr:.17g}"
        elif missing_type == 1:        # zero as missing
            zero = (f"(std::fabs(std::isnan({fv}) ? 0.0 : {fv}) <= "
                    f"{K_ZERO_RANGE:g})")
            branch = "true" if default_left else "false"
            cond = (f"({zero} ? {branch} : "
                    f"(std::isnan({fv}) ? 0.0 : {fv}) <= {thr:.17g})")
        else:                          # nan as missing
            branch = "true" if default_left else "false"
            cond = f"(std::isnan({fv}) ? {branch} : {le})"
    lines.append(f"{indent}if ({cond}) {{")
    _node_code(tree, int(tree.left_child[node]), indent + "  ", lines, tree_idx)
    lines.append(f"{indent}}} else {{")
    _node_code(tree, int(tree.right_child[node]), indent + "  ", lines, tree_idx)
    lines.append(f"{indent}}}")


def tree_to_cpp(tree: Tree, idx: int) -> str:
    lines: List[str] = []
    if tree.cat_threshold is not None and len(tree.cat_threshold):
        words = ", ".join(f"0x{int(w):08x}u" for w in tree.cat_threshold)
        lines.append(f"static const uint32_t kCatBits{idx}[] = {{{words}}};")
    lines.append(f"static double PredictTree{idx}(const double* features) {{")
    if tree.num_leaves <= 1:
        val = float(tree.leaf_value[0]) if len(tree.leaf_value) else 0.0
        lines.append(f"  return {val:.17g};")
    else:
        _node_code(tree, 0, "  ", lines, idx)
    lines.append("}")
    return "\n".join(lines)


def model_to_cpp(booster) -> str:
    """Whole-forest if-else codegen (SaveModelToIfElse equivalent)."""
    K = max(booster.num_model_per_iteration, 1)
    trees = booster.trees
    parts = [
        "// generated by lightgbm_tpu convert_model "
        "(reference oracle: src/io/tree.cpp Tree::ToIfElse)",
        "#include <cmath>",
        "#include <cstdint>",
        "",
        "static inline bool InBitset(const uint32_t* bits, int n_words, "
        "double fval) {",
        "  if (std::isnan(fval)) return false;",
        "  long iv = (long)fval;",
        "  if (iv < 0 || iv >= n_words * 32) return false;",
        "  return (bits[iv / 32] >> (iv % 32)) & 1u;",
        "}",
        "",
    ]
    for i, t in enumerate(trees):
        parts.append(tree_to_cpp(t, i))
        parts.append("")
    calls = [[] for _ in range(K)]
    for i in range(len(trees)):
        calls[i % K].append(f"PredictTree{i}(features)")
    # rf averages converted tree outputs (gbdt_model_text.cpp:107-109
    # average_output path), so the codegen must divide like predict does
    average = getattr(booster.config, "boosting_normalized", "gbdt") == "rf"
    n_iter = max(len(trees) // K, 1)
    div = f" / {n_iter}.0" if average and n_iter > 1 else ""
    parts.append('extern "C" void PredictRaw(const double* features, double* out) {')
    for k in range(K):
        expr = " + ".join(calls[k]) if calls[k] else "0.0"
        parts.append(f"  out[{k}] = ({expr}){div};")
    parts.append("}")
    parts.append("")
    parts.append('extern "C" double PredictRawSingle(const double* features) {')
    expr = " + ".join(calls[0]) if calls and calls[0] else "0.0"
    parts.append(f"  return ({expr}){div};")
    parts.append("}")
    parts.append("")
    return "\n".join(parts)
