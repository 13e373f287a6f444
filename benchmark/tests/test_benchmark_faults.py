"""Each fault a cell can have, planted under the timed path, turns
``correct`` false: the harness runs on the CPU at the cell's tiny size
(it skips only the look for a card), with the program broken underneath: its
state, its rows, its answers, its valid scores and its valid metric.
No cell spans chips, so the exchange between chips has no fault here."""
import pytest
import torch

from benchmark.tests.conftest import run_tiny


def _state_unchanged(monkeypatch):
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    monkeypatch.setattr(GBDT, "_score_update",
                        lambda self, old, contrib: old)


def _half_rows(monkeypatch):
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    orig = GBDT._gradients

    def half(self, score):
        g, h = orig(self, score)
        keep = torch.zeros_like(g)
        keep[..., ::2] = 2.0       # every other row left out, the rest x2
        return g * keep, h * keep
    monkeypatch.setattr(GBDT, "_gradients", half)


def _answer_altered(monkeypatch):
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    orig = GBDT._shrink

    def altered(self, tree, shrinkage):
        tree = orig(self, tree, shrinkage)
        lv = tree.leaf_value
        sign = torch.ones_like(lv)
        sign[0] = -1.0                      # leaf 0's value negated
        return tree._replace(leaf_value=lv * sign)
    monkeypatch.setattr(GBDT, "_shrink", altered)


def _valid_stale(monkeypatch):
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    orig = GBDT._score_update

    def train_rows_only(self, old, contrib):
        if old.shape[-1] != self.score.shape[-1]:
            return old                      # a valid set's scores kept
        return orig(self, old, contrib)
    monkeypatch.setattr(GBDT, "_score_update", train_rows_only)


def _metric_on_half_rows(monkeypatch):
    from types import SimpleNamespace
    from lightgbm_tpu_torch import metrics

    def half_of(orig):
        def half(self, score):
            md = self.metadata
            qb = md.query_boundaries
            if qb is None:
                cut, qb_half = len(md.label) // 2, None
            else:
                qb_half = qb[:len(qb) // 2 + 1]
                cut = int(qb_half[-1])
            self.metadata = SimpleNamespace(
                label=md.label[:cut], query_boundaries=qb_half,
                weight=None if md.weight is None else md.weight[:cut],
                query_weights=None if md.query_weights is None
                else md.query_weights[:len(qb_half) - 1])
            try:
                return orig(self, score[..., :cut])
            finally:
                self.metadata = md
        return half
    for cls in (metrics.AUCMetric, metrics.NDCGMetric):
        monkeypatch.setattr(cls, "eval", half_of(cls.eval))


def _scores_altered(monkeypatch):
    from lightgbm_tpu_torch.ops import predict
    orig = predict.forest_predict_raw
    monkeypatch.setattr(predict, "forest_predict_raw",
                        lambda *a, **k: orig(*a, **k) + 1e-3)


def _rows_left_out(monkeypatch):
    from lightgbm_tpu_torch.ops import predict
    orig = predict.forest_predict_raw

    def half(*a, **k):
        out = orig(*a, **k)
        out[len(out) // 2:] = 0.0
        return out
    monkeypatch.setattr(predict, "forest_predict_raw", half)


@pytest.mark.parametrize("cell", ["higgs.train", "mslr.train"])
@pytest.mark.parametrize("fault,number", [
    (_state_unchanged, None), (_half_rows, None), (_answer_altered, None),
    (_valid_stale, "valid_score_gap"),
    (_metric_on_half_rows, "valid_metric_gap")])
def test_a_training_fault_is_not_correct(cell, fault, number, monkeypatch):
    fault(monkeypatch)
    res = run_tiny(cell)
    assert res["correct"] is False
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert failed
    if number is not None:
        assert number in failed


@pytest.mark.parametrize("fault", [_scores_altered, _rows_left_out])
def test_a_scoring_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run_tiny("higgs.score")
    assert res["correct"] is False


@pytest.mark.parametrize("cell", ["higgs.train", "mslr.train",
                                  "higgs.score"])
def test_the_control_reads_above_the_sound_program(cell):
    """At the tiny size the program passes and the reference in the lower
    precision (the control) reads above it in one of the cell's numbers;
    whether the control fails the limits is a question of the cell's own
    size, asked on the card (``test_benchmark_card.py``)."""
    res = run_tiny(cell, control=True)
    assert res["correct"] is True
    name = "control_bf16" if cell.endswith(".train") else "control_f32"
    readings = res["control"][name]
    assert any(readings[k] > 10 * max(c["value"], 1e-300)
               for k, c in res["checks"].items() if k != "count_mismatch")
