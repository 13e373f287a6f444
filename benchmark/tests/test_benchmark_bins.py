"""The training data keeps every value of a feature in a bin of its own
under the port's bin finding at the configuration's ``max_bin``: the
reference bins each distinct value apart (``reference.Bins``), so the two
agree on the bins of every feature only where the port merges none.

HIGGS's 250 values are the most for which that holds with room: a
sign-crossing feature with NaN gets ``int(share * 253)`` bins for its
negative values, and at 250 equal-mass values that is 126.5 against the
125 it needs, some five standard deviations of the sampled share; at 251
an odd middle value leaves half a bin. MS-LTR's 254 positive values fill
the 254 bins beside the zero bin exactly."""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from benchmark.harness import data as datagen
from benchmark.harness import manifest
from benchmark.reference import gbdt as ref

ROWS = {"higgs": {"train_rows": 400_000, "valid_rows": 10},
        "mslr": {"train_rows": 200_000, "valid_rows": 120,
                 "train_queries": 1600, "valid_queries": 1}}


@pytest.mark.parametrize("config", ["higgs", "mslr"])
def test_the_port_keeps_each_value_in_a_bin_of_its_own(config):
    cfg = manifest.config(config)
    d = datagen.training_data(cfg["data"], 2147483659, torch.device("cpu"),
                              ROWS[config])
    X = d["X"]
    params = dict(cfg["params"], device="cpu")
    ds = lgt.Dataset(X.numpy(), label=d["y"].numpy(), group=d.get("group"))
    ds.construct(lgt.Config.from_params(params))
    mappers = ds.constructed.mappers
    assert len(mappers) == X.shape[1]
    bins = ref.Bins(X)
    for f, mapper in enumerate(mappers):
        values = bins.levels[f].numpy()
        assert len(values) == int(cfg["data"]["levels"])
        codes = mapper.value_to_bin(values)
        assert len(np.unique(codes)) == len(values), f
        if bins.has_nan[f]:
            nan_code = int(mapper.value_to_bin(np.array([np.nan]))[0])
            assert nan_code not in set(codes.tolist()), f
        # the port's bins beyond these are empty: the zero bin, NaN's
        assert mapper.num_bin <= len(values) + 2
