"""Plotting utilities — a copy of ``lightgbm_tpu/plotting.py`` (reference:
python-package/lightgbm/plotting.py).

Same public surface — ``plot_importance``, ``plot_metric``, ``plot_tree``,
``create_tree_digraph`` — re-implemented against this package's Booster
introspection API (``feature_importance``, ``dump_model``, the
``record_evaluation`` callback dict). ``plot_tree`` renders the tree with
pure matplotlib (a recursive in-order layout) instead of shelling out to
graphviz's ``dot`` binary, which keeps it free of that dependency;
``create_tree_digraph`` still returns a ``graphviz.Digraph`` for users who
have graphviz installed.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster


def _check_matplotlib():
    try:
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("You must install matplotlib for plotting") from e


def plot_importance(booster, ax=None, height: float = 0.2, xlim=None, ylim=None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "split",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, grid: bool = True,
                    **kwargs):
    """Horizontal-bar feature importance (reference plotting.py:22)."""
    plt = _check_matplotlib()
    if isinstance(booster, Booster):
        importance = booster.feature_importance(importance_type=importance_type)
        feature_names = booster.feature_name()
    elif hasattr(booster, "booster_"):            # sklearn estimator
        importance = booster.booster_.feature_importance(importance_type=importance_type)
        feature_names = booster.booster_.feature_name()
    else:
        raise TypeError("booster must be Booster or LGBMModel")

    pairs = sorted(zip(feature_names, importance), key=lambda t: t[1])
    if ignore_zero:
        pairs = [p for p in pairs if p[1] != 0]
    if not pairs:
        raise ValueError("Booster's feature_importance is empty")
    if max_num_features is not None and max_num_features > 0:
        pairs = pairs[-max_num_features:]
    labels, values = zip(*pairs)

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, str(x), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    else:
        ax.set_xlim(0, max(values) * 1.1)
    if ylim is not None:
        ax.set_ylim(ylim)
    else:
        ax.set_ylim(-1, len(values))
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None,
                ax=None, xlim=None, ylim=None,
                title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "auto",
                figsize=None, grid: bool = True):
    """Plot one recorded eval metric across training (reference :131).

    ``booster`` is the dict produced by the ``record_evaluation`` callback
    (a Booster itself keeps no eval history, matching the reference which
    raises for Booster input too).
    """
    plt = _check_matplotlib()
    if isinstance(booster, dict):
        eval_results = booster
    elif hasattr(booster, "evals_result_"):       # sklearn estimator
        eval_results = booster.evals_result_
    else:
        raise TypeError(
            "booster must be a dict from record_evaluation or a fitted LGBMModel")
    if not eval_results:
        raise ValueError("eval results cannot be empty")

    if dataset_names is None:
        dataset_names = list(eval_results.keys())
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)

    first = eval_results[dataset_names[0]]
    if metric is None:
        if len(first) > 1:
            raise ValueError("more than one metric available, pick one with metric=")
        metric = next(iter(first))
    elif metric not in first:
        raise ValueError(f"specific metric {metric!r} not recorded")

    num_iters = 0
    for name in dataset_names:
        results = eval_results[name][metric]
        num_iters = max(num_iters, len(results))
        ax.plot(range(len(results)), results, label=name)

    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    else:
        ax.set_xlim(0, num_iters)
    if ylim is not None:
        ax.set_ylim(ylim)
    if ylabel == "auto":
        ylabel = metric
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _tree_dump(booster, tree_index: int) -> Dict[str, Any]:
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    if not isinstance(booster, Booster):
        raise TypeError("booster must be Booster or LGBMModel")
    model = booster.dump_model()
    if tree_index >= len(model["tree_info"]):
        raise IndexError(f"tree_index {tree_index} out of range "
                         f"({len(model['tree_info'])} trees)")
    return model["tree_info"][tree_index]


def _fmt(value, precision: int = 3) -> str:
    # categorical thresholds are "||"-joined strings in the dump
    return value if isinstance(value, str) else f"{value:.{precision}g}"


def _node_label(node: Dict[str, Any], show_info: List[str],
                feature_names: Optional[List[str]], precision: int = 3) -> str:
    if "split_index" in node:
        f = node["split_feature"]
        fname = feature_names[f] if feature_names else f"f{f}"
        lines = [f"{fname} {node['decision_type']} "
                 f"{_fmt(node['threshold'], precision)}"]
        if "split_gain" in show_info:
            lines.append(f"gain: {_fmt(node['split_gain'], precision)}")
        if "internal_value" in show_info:
            lines.append(f"value: {_fmt(node['internal_value'], precision)}")
        if "internal_count" in show_info:
            lines.append(f"count: {node['internal_count']:g}")
    else:
        # a stump iteration dumps bare {'leaf_value': v} with no index
        idx = node.get("leaf_index", 0)
        lines = [f"leaf {idx}: {_fmt(node['leaf_value'], precision)}"]
        if "leaf_count" in show_info and "leaf_count" in node:
            lines.append(f"count: {node['leaf_count']:g}")
    return "\n".join(lines)


def create_tree_digraph(booster, tree_index: int = 0,
                        show_info: Optional[List[str]] = None,
                        name: Optional[str] = None,
                        comment: Optional[str] = None,
                        filename: Optional[str] = None,
                        directory: Optional[str] = None,
                        format: Optional[str] = None,
                        engine: Optional[str] = None,
                        encoding: Optional[str] = None,
                        graph_attr=None, node_attr=None, edge_attr=None,
                        body=None, strict: bool = False):
    """Graphviz Digraph of one tree (reference plotting.py:308)."""
    try:
        from graphviz import Digraph
    except ImportError as e:  # pragma: no cover
        raise ImportError("You must install graphviz for create_tree_digraph") from e
    show_info = show_info or []
    tree = _tree_dump(booster, tree_index)
    b = booster.booster_ if hasattr(booster, "booster_") else booster
    feature_names = b.feature_name()

    graph = Digraph(name=name, comment=comment, filename=filename,
                    directory=directory, format=format, engine=engine,
                    encoding=encoding, graph_attr=graph_attr,
                    node_attr=node_attr, edge_attr=edge_attr, body=body,
                    strict=strict)

    def add(node, parent=None, decision=None):
        if "split_index" in node:
            nid = f"split{node['split_index']}"
            graph.node(nid, label=_node_label(node, show_info, feature_names))
            add(node["left_child"], nid, "yes")
            add(node["right_child"], nid, "no")
        else:
            nid = f"leaf{node.get('leaf_index', 0)}"
            graph.node(nid, label=_node_label(node, show_info, feature_names))
        if parent is not None:
            graph.edge(parent, nid, decision)

    add(tree["tree_structure"])
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None,
              show_info: Optional[List[str]] = None, precision: int = 3,
              **kwargs):
    """Draw one tree with matplotlib (reference plotting.py:387 renders via
    graphviz ``dot``; here a self-contained recursive layout: leaves are
    placed at consecutive x positions in-order, internal nodes centered
    over their children, depth on the y axis)."""
    plt = _check_matplotlib()
    show_info = show_info or []
    tree = _tree_dump(booster, tree_index)
    b = booster.booster_ if hasattr(booster, "booster_") else booster
    feature_names = b.feature_name()

    pos: Dict[int, tuple] = {}
    labels: Dict[int, str] = {}
    edges = []                 # (parent_id, child_id, text)
    next_x = [0.0]
    next_id = [0]

    def layout(node, depth):
        nid = next_id[0]
        next_id[0] += 1
        labels[nid] = _node_label(node, show_info, feature_names, precision)
        if "split_index" in node:
            lid = layout(node["left_child"], depth + 1)
            rid = layout(node["right_child"], depth + 1)
            x = (pos[lid][0] + pos[rid][0]) / 2
            edges.append((nid, lid, "yes"))
            edges.append((nid, rid, "no"))
        else:
            x = next_x[0]
            next_x[0] += 1.0
        pos[nid] = (x, -float(depth))
        return nid

    layout(tree["tree_structure"], 0)

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize or (max(6, next_x[0] * 1.5), 6))
    for p, c, text in edges:
        (x0, y0), (x1, y1) = pos[p], pos[c]
        ax.plot([x0, x1], [y0, y1], "-", color="0.6", zorder=1)
        ax.text((x0 + x1) / 2, (y0 + y1) / 2, text, fontsize=7, color="0.4")
    for nid, (x, y) in pos.items():
        ax.text(x, y, labels[nid], ha="center", va="center", fontsize=8, zorder=2,
                bbox=dict(boxstyle="round", facecolor="lightyellow", edgecolor="0.5"))
    ax.set_axis_off()
    ax.set_title(f"Tree {tree_index}")
    return ax
