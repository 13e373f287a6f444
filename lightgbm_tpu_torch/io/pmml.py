"""Model -> PMML converter — a copy of ``lightgbm_tpu/io/pmml.py``, emitting
the same text (reference capability: pmml/pmml.py, which walks the model
text file and prints per-tree <TreeModel> segments).

Re-designed over this package's in-memory model: the forest renders as a
PMML 4.2 MiningModel with sum-segmentation of TreeModels; each node carries
its score/recordCount and the predicate of the edge from its parent
(SimplePredicate on the real threshold; SimpleSetPredicate for categorical
splits). Usage:

    from lightgbm_tpu_torch.io.pmml import model_to_pmml
    xml_text = model_to_pmml(booster)           # or a model file path
    # CLI parity with the reference script:
    python -m lightgbm_tpu_torch.io.pmml model.txt > model.pmml
"""
from __future__ import annotations

import itertools
import xml.etree.ElementTree as ET
from xml.dom import minidom


def _split_predicates(tree, node_id, feature_names):
    """(left_pred, right_pred) of an internal node's outgoing edges."""
    f = feature_names[int(tree.split_feature[node_id])]
    if int(tree.decision_type[node_id]) & 1:
        cat_idx = int(tree.threshold_bin[node_id])
        lo, hi = tree.cat_boundaries[cat_idx], tree.cat_boundaries[cat_idx + 1]
        bits = tree.cat_threshold[lo:hi]
        values = [str(v) for v in range(32 * len(bits))
                  if (bits[v // 32] >> (v % 32)) & 1]
        preds = []
        for op in ("isIn", "isNotIn"):
            p = ET.Element("SimpleSetPredicate", field=f, booleanOperator=op)
            arr = ET.SubElement(p, "Array", type="int", n=str(len(values)))
            arr.text = " ".join(values)
            preds.append(p)
        return preds[0], preds[1]
    thr = repr(float(tree.threshold[node_id]))
    return (ET.Element("SimplePredicate", field=f, operator="lessOrEqual",
                       value=thr),
            ET.Element("SimplePredicate", field=f, operator="greaterThan",
                       value=thr))


def _emit_node(parent_el, tree, node_id, feature_names, predicate, ids):
    """Emit `node_id` (< 0 encodes leaf ~node_id) under parent_el with the
    predicate of the edge that reaches it; recurse into children."""
    if node_id < 0:
        leaf = ~node_id
        el = ET.SubElement(parent_el, "Node", id=str(next(ids)),
                           score=repr(float(tree.leaf_value[leaf])),
                           recordCount=str(int(tree.leaf_count[leaf])))
        el.append(predicate)
        return
    el = ET.SubElement(parent_el, "Node", id=str(next(ids)),
                       score=repr(float(tree.internal_value[node_id])),
                       recordCount=str(int(tree.internal_count[node_id])))
    el.append(predicate)
    lp, rp = _split_predicates(tree, node_id, feature_names)
    _emit_node(el, tree, int(tree.left_child[node_id]), feature_names, lp, ids)
    _emit_node(el, tree, int(tree.right_child[node_id]), feature_names, rp, ids)


def model_to_pmml(model, name: str = "lightgbm_tpu") -> str:
    """Render a Booster (or model text file path) as a PMML string."""
    from ..basic import Booster
    if isinstance(model, str):
        model = Booster(model_file=model)
    if any(t.is_linear for t in model.trees):
        # PMML TreeModel nodes carry one scalar score: a per-leaf linear
        # model would need a nested RegressionModel per leaf segment —
        # reject LOUDLY rather than export constants that silently drop
        # the linear terms (use protobuf/text/JSON, or codegen, instead)
        raise ValueError(
            "PMML export does not support linear-tree models "
            "(linear_tree=true): TreeModel leaves are scalar scores. "
            "Export via protobuf/text/JSON, or C++ codegen.")

    feature_names = model.feature_name()
    pmml = ET.Element("PMML", version="4.2",
                      xmlns="http://www.dmg.org/PMML-4_2")
    header = ET.SubElement(pmml, "Header", copyright=name)
    ET.SubElement(header, "Application", name=name)

    dd = ET.SubElement(pmml, "DataDictionary",
                       numberOfFields=str(len(feature_names) + 1))
    for f in feature_names:
        ET.SubElement(dd, "DataField", name=f, optype="continuous",
                      dataType="double")
    ET.SubElement(dd, "DataField", name="prediction", optype="continuous",
                  dataType="double")

    mm = ET.SubElement(pmml, "MiningModel", functionName="regression",
                       modelName=name)
    schema = ET.SubElement(mm, "MiningSchema")
    for f in feature_names:
        ET.SubElement(schema, "MiningField", name=f)
    ET.SubElement(schema, "MiningField", name="prediction",
                  usageType="target")

    seg = ET.SubElement(mm, "Segmentation", multipleModelMethod="sum")
    for i, tree in enumerate(model.trees):
        s = ET.SubElement(seg, "Segment", id=str(i + 1))
        ET.SubElement(s, "True")
        tm = ET.SubElement(s, "TreeModel", functionName="regression",
                           modelName=f"tree_{i}",
                           splitCharacteristic="binarySplit")
        ts = ET.SubElement(tm, "MiningSchema")
        for f in feature_names:
            ET.SubElement(ts, "MiningField", name=f)
        ids = itertools.count(1)
        if tree.num_leaves <= 1:
            root = ET.SubElement(
                tm, "Node", id=str(next(ids)),
                score=repr(float(tree.leaf_value[0])
                           if len(tree.leaf_value) else 0.0))
            ET.SubElement(root, "True")
        else:
            _emit_node(tm, tree, 0, feature_names, ET.Element("True"), ids)

    rough = ET.tostring(pmml, encoding="unicode")
    return minidom.parseString(rough).toprettyxml(indent="  ")


def main(argv=None) -> None:
    import sys
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: python -m lightgbm_tpu_torch.io.pmml <model.txt> [out.pmml]",
              file=sys.stderr)
        raise SystemExit(2)
    xml_text = model_to_pmml(args[0])
    if len(args) > 1:
        with open(args[1], "w") as fh:
            fh.write(xml_text)
    else:
        print(xml_text)


if __name__ == "__main__":
    main()
