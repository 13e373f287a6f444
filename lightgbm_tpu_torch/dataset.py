"""Binned dataset: the host path of ``lightgbm_tpu/dataset.py``.

Reference counterpart: include/LightGBM/dataset.h:280 (Dataset),
dataset.h:36-248 (Metadata), src/io/dataset_loader.cpp (construction flow).

The whole training matrix becomes ONE dense ``[num_data, num_features]``
code matrix — ``uint8``, or ``uint16`` when a feature has more than 256
bins, as the JAX package picks (``lightgbm_tpu/dataset.py:504``) — binned on
the host feature by feature through the copied :mod:`binning` mappers, and
moved to the device once by the booster. Left out of this slice (they
raise): sparse input, categorical features, deferred device ingest and EFB.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN,
                      MISSING_NONE, MISSING_ZERO, BinMapper,
                      sample_for_binning)
from .config import Config
from .utils.log import Log


class Metadata:
    """Labels / weights / init scores (reference: dataset.h:36-248)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label = np.zeros(num_data, dtype=np.float32)
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label: Sequence[float]) -> None:
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            Log.fatal("Length of label (%d) != num_data (%d)", len(label),
                      self.num_data)
        self.label = label

    def set_weight(self, weight: Optional[Sequence[float]]) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.asarray(weight, dtype=np.float32).reshape(-1)
        if len(weight) != self.num_data:
            Log.fatal("Length of weight (%d) != num_data (%d)", len(weight),
                      self.num_data)
        self.weight = weight

    def set_init_score(self, init_score: Optional[Sequence[float]]) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.asarray(init_score, dtype=np.float64).reshape(-1)


@dataclass
class FeatureInfo:
    """Construction-time info for one used (non-trivial) feature."""
    real_index: int            # column in the raw input
    mapper: BinMapper


class ConstructedDataset:
    """The binned dataset (reference Dataset, dataset.h:280).

    ``X_binned`` is the ``uint8`` (or ``uint16``) ``[num_data,
    num_features]`` code matrix of
    the used (non-trivial) features; ``mappers`` holds one BinMapper per
    used feature and ``real_feature_idx`` maps a used feature back to its
    raw column (reference dataset.h:552)."""

    def __init__(self, X_binned: np.ndarray, features: List[FeatureInfo],
                 num_total_features: int, metadata: Metadata,
                 feature_names: List[str], config: Config):
        self.X_binned = X_binned
        self.mappers = [f.mapper for f in features]
        self.real_feature_idx = np.array([f.real_index for f in features],
                                         dtype=np.int32)
        self.num_total_features = num_total_features
        self.metadata = metadata
        self.feature_names = feature_names
        self.config = config
        self.num_bins_per_feature = np.array(
            [m.num_bin for m in self.mappers], dtype=np.int32)

    @property
    def num_data(self) -> int:
        return int(self.X_binned.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.X_binned.shape[1])

    @property
    def max_num_bin(self) -> int:
        return int(self.num_bins_per_feature.max()) if len(self.mappers) \
            else 1

    def feature_meta_arrays(self) -> Dict[str, np.ndarray]:
        """Static per-feature arrays consumed by the split scan."""
        missing_code = np.array(
            [{MISSING_NONE: 0, MISSING_ZERO: 1, MISSING_NAN: 2}[m.missing_type]
             for m in self.mappers], dtype=np.int32)
        default_bin = np.array([m.default_bin for m in self.mappers],
                               dtype=np.int32)
        return {"missing_code": missing_code, "default_bin": default_bin,
                "num_bins": self.num_bins_per_feature}


def _parse_column_spec(spec: str, feature_names: List[str]) -> List[int]:
    """Parse 'name:a,name:b' or '0,1,2' column specs
    (reference: dataset_loader.cpp column resolution)."""
    if not spec:
        return []
    out = []
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok.startswith("name:"):
            name = tok[5:]
            if name not in feature_names:
                Log.fatal("Column name %s not found", name)
            out.append(feature_names.index(name))
        else:
            out.append(int(tok))
    return out


def _map_find_bin(active: List[int], find_one) -> Dict[int, BinMapper]:
    """``find_one`` over every feature in ``active`` on a thread pool (numpy
    releases the GIL in the passes that dominate ``BinMapper.find_bin``);
    the result keeps ``active`` order."""
    workers = min(16, os.cpu_count() or 1, len(active))
    if workers <= 1:
        return {j: find_one(j) for j in active}
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(workers) as pool:
        return dict(zip(active, pool.map(find_one, active)))


def construct_dataset(
    data: np.ndarray,
    label: Optional[Sequence[float]],
    config: Config,
    weight: Optional[Sequence[float]] = None,
    init_score: Optional[Sequence[float]] = None,
    feature_names: Optional[List[str]] = None,
    categorical_features: Optional[Sequence[Union[int, str]]] = None,
) -> ConstructedDataset:
    """Build a ConstructedDataset from a dense raw numpy matrix.

    Mirrors DatasetLoader::ConstructBinMappersFromTextData
    (dataset_loader.cpp:748-903): sample -> FindBin per feature -> drop
    trivial features -> bin codes."""
    if hasattr(data, "tocsc"):
        Log.fatal("sparse input is not ported to lightgbm_tpu_torch yet "
                  "(ROADMAP A1)")
    if categorical_features:
        Log.fatal("categorical features are not ported to lightgbm_tpu_torch "
                  "yet (ROADMAP A9)")
    data = np.ascontiguousarray(data)
    if data.ndim != 2:
        Log.fatal("Training data must be 2-dimensional")
    num_data, num_total_features = data.shape
    if feature_names is None:
        feature_names = [f"Column_{i}" for i in range(num_total_features)]
    ignore_set = set(_parse_column_spec(config.ignore_column, feature_names))

    # sampling (dataset_loader.cpp:688-746)
    _, per_feature_samples = sample_for_binning(
        data, config.bin_construct_sample_cnt, config.data_random_seed)
    total_sample_cnt = min(num_data, config.bin_construct_sample_cnt)
    # reference: filter_cnt = min_data_in_leaf * sample / num_data
    # (dataset_loader.cpp:495)
    filter_cnt = int(config.min_data_in_leaf * total_sample_cnt
                     / max(num_data, 1))

    def _find_one(j: int) -> BinMapper:
        mapper = BinMapper()
        mapper.find_bin(per_feature_samples[j], total_sample_cnt,
                        config.max_bin, config.min_data_in_bin, filter_cnt,
                        BIN_NUMERICAL, config.use_missing,
                        config.zero_as_missing)
        return mapper

    active = [j for j in range(num_total_features) if j not in ignore_set]
    mappers_by_idx = _map_find_bin(active, _find_one)
    features = [FeatureInfo(j, mappers_by_idx[j]) for j in active
                if not mappers_by_idx[j].is_trivial]
    if not features:
        Log.warning("There are no meaningful features, as all feature "
                    "values are constant.")
    assert all(f.mapper.bin_type != BIN_CATEGORICAL for f in features)
    dtype = (np.uint8 if all(f.mapper.num_bin <= 256 for f in features)
             else np.uint16)

    X_binned = bin_dense_host(
        data, [f.mapper for f in features],
        np.array([f.real_index for f in features], np.int64), num_data,
        dtype)

    metadata = Metadata(num_data)
    if label is not None:
        metadata.set_label(label)
    metadata.set_weight(weight)
    metadata.set_init_score(init_score)
    return ConstructedDataset(X_binned, features, num_total_features,
                              metadata, feature_names, config)


def bin_dense_host(data: np.ndarray, mappers, real_indices: np.ndarray,
                   num_data: int, dtype=np.uint8) -> np.ndarray:
    """Dense host binning: one ``value_to_bin`` pass per column, written
    straight into the ``dtype`` output (``out=``), on a thread pool for
    large matrices (numpy releases the GIL in the heavy passes)."""
    F = max(len(real_indices), 1)
    X_binned = np.zeros((num_data, F), dtype=dtype)
    big = num_data * F > 8_000_000

    def _bin_column(inner: int):
        col = data[:, real_indices[inner]]
        if big:
            # one contiguous copy per column: value_to_bin makes several
            # full passes and a stride-F read thrashes cache on each
            col = np.ascontiguousarray(col)
        mappers[inner].value_to_bin(col, out=X_binned[:, inner])

    if big and len(real_indices) > 1:
        from concurrent.futures import ThreadPoolExecutor
        workers = min(16, os.cpu_count() or 1, len(real_indices))
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(_bin_column, range(len(real_indices))))
    else:
        for inner in range(len(real_indices)):
            _bin_column(inner)
    return X_binned
