"""Binned dataset: the host path of ``lightgbm_tpu/dataset.py``.

Reference counterpart: include/LightGBM/dataset.h:280 (Dataset),
dataset.h:36-248 (Metadata), src/io/dataset_loader.cpp (construction flow).

The whole training matrix becomes ONE dense ``[num_data, num_features]``
code matrix — ``uint8``, or ``uint16`` when a feature has more than 256
bins, as the JAX package picks (``lightgbm_tpu/dataset.py:504``) — binned on
the host feature by feature through the copied :mod:`binning` mappers, and
moved to the device once by the booster. Categorical columns (named by
index or name, ``lightgbm_tpu/dataset.py:473-479``) are binned by
descending category count. ``scipy.sparse`` input (CSR or CSC) is binned
column by column from its CSC form, never densified to floats
(``lightgbm_tpu/dataset.py:446-530``): implicit zeros take the zero bin,
which is every mapper's default bin; its code matrix is column-major, so
that each column is written (and read by EFB's planning) contiguously.
With ``linear_tree`` in the config the dataset also keeps the used
features' raw f32 values (NaN kept), the JAX package's ``X_raw``.

Deferred binning (``tpu_ingest=device|auto``,
``lightgbm_tpu/dataset.py:87`` and ``:587-616``): for eligible dense input
(f32-lossless, see ``ops/ingest.device_ingest_blocker``; ``auto`` from
65,536 rows) construction finds the mappers and keeps the raw rows in a
``DeferredBinning`` in place of the code matrix; the booster bins them on
its device (``ops/ingest.py``). ``X_binned`` then bins on the host only if
something reads it, and ``bin_rows`` gives host codes of chosen rows
without doing so. Valid sets are binned on the host. Text files
(``io/file_io.py``) and binary dataset files (``save_binary`` /
``load_binary``, the JAX package's format) come in through ``basic.Dataset``;
a set loaded from a binary file trains from its host codes.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN,
                      MISSING_NONE, MISSING_ZERO, BinMapper,
                      sample_for_binning)
from . import observability as obs
from .config import Config
from .utils.log import Log


class Metadata:
    """Labels / weights / init scores (reference: dataset.h:36-248)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label = np.zeros(num_data, dtype=np.float32)
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.query_weights: Optional[np.ndarray] = None
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

    def set_group(self, group) -> None:
        """``group`` is per-query sizes (python API) -> boundaries
        (reference: metadata.cpp SetQuery)."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).reshape(-1)
        boundaries = np.concatenate([[0], np.cumsum(group)])
        if boundaries[-1] != self.num_data:
            Log.fatal("Sum of query counts (%d) != num_data (%d)",
                      boundaries[-1], self.num_data)
        self.query_boundaries = boundaries.astype(np.int32)

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None \
            else len(self.query_boundaries) - 1


@dataclass
class DeferredBinning:
    """Raw dense rows held in place of a materialised ``X_binned``
    (``tpu_ingest=device|auto``): the booster bins them on its device
    (``ops/ingest.py``) straight into the code matrix it trains on, and the
    host matrix exists only if a consumer reads the ``X_binned`` property
    (EFB materialisation), which bins through the host oracle. ``raw`` stays
    referenced while deferred: the raw f32/f64 matrix in place of the
    codes."""
    raw: np.ndarray            # [num_data, num_total_features] dense
    code_dtype: np.dtype       # uint8 | uint16, decided at construction


class MetadataDuckTyping:
    """The reference Dataset's field getters over ``self.metadata``: custom
    objectives and eval functions (``fobj(preds, train_data)``,
    ``feval(preds, eval_data)``) receive objects with this mixin."""

    def get_label(self):
        return self.metadata.label

    def get_weight(self):
        return self.metadata.weight

    def get_group(self):
        qb = self.metadata.query_boundaries
        return None if qb is None else np.diff(qb)

    def get_init_score(self):
        return self.metadata.init_score


@dataclass
class FeatureInfo:
    """Construction-time info for one used (non-trivial) feature."""
    real_index: int            # column in the raw input
    mapper: BinMapper


class ConstructedDataset(MetadataDuckTyping):
    """The binned dataset (reference Dataset, dataset.h:280).

    ``X_binned`` is the ``uint8`` (or ``uint16``) ``[num_data,
    num_features]`` code matrix of
    the used (non-trivial) features; ``mappers`` holds one BinMapper per
    used feature and ``real_feature_idx`` maps a used feature back to its
    raw column (reference dataset.h:552). ``X_binned=None`` with
    ``deferred`` set defers the codes (``DeferredBinning``): shape and code
    dtype are fixed now, and the property bins lazily."""

    def __init__(self, X_binned: Optional[np.ndarray],
                 features: List[FeatureInfo],
                 num_total_features: int, metadata: Metadata,
                 feature_names: List[str], config: Config,
                 deferred: Optional[DeferredBinning] = None):
        self._X_binned = X_binned
        self._deferred = deferred if X_binned is None else None
        if X_binned is not None:
            self._shape = tuple(X_binned.shape)
            self._code_dtype = X_binned.dtype
        else:
            assert deferred is not None
            self._shape = (metadata.num_data, max(len(features), 1))
            self._code_dtype = np.dtype(deferred.code_dtype)
        self.mappers = [f.mapper for f in features]
        self.real_feature_idx = np.array([f.real_index for f in features],
                                         dtype=np.int32)
        self.num_total_features = num_total_features
        self.metadata = metadata
        self.feature_names = feature_names
        self.config = config
        self.num_bins_per_feature = np.array(
            [m.num_bin for m in self.mappers], dtype=np.int32)
        # raw f32 values of the used features for linear leaves
        # (construct_dataset fills it under linear_tree)
        self.X_raw: Optional[np.ndarray] = None

    # -- the lazy code matrix (tpu_ingest: ops/ingest.py) --------------------

    @property
    def X_binned(self) -> np.ndarray:
        """The host code matrix; under deferred binning the first read
        bins it through the host oracle."""
        if self._X_binned is None:
            self._X_binned = self._materialize_host()
        return self._X_binned

    @X_binned.setter
    def X_binned(self, value: np.ndarray) -> None:
        self._X_binned = value
        self._deferred = None
        self._shape = tuple(value.shape)
        self._code_dtype = value.dtype

    @property
    def deferred(self) -> bool:
        """True while binning is deferred (no host ``X_binned`` exists)."""
        return self._X_binned is None

    def deferred_raw(self) -> Optional[np.ndarray]:
        """The raw matrix of a still-deferred dataset (None once
        materialised): the device ingest's input."""
        return self._deferred.raw if self._deferred is not None else None

    def bin_rows(self, rows: np.ndarray) -> np.ndarray:
        """Host-oracle codes of the given rows, byte-identical to
        ``np.ascontiguousarray(self.X_binned[rows])`` whether or not the
        matrix exists: the data fingerprint and EFB's planning sample read
        through it, so their bytes do not depend on ``tpu_ingest``."""
        if self._X_binned is not None:
            return np.ascontiguousarray(self._X_binned[rows])
        sub = self._deferred.raw[rows]
        out = np.zeros((sub.shape[0], self.num_features), self._code_dtype)
        for inner, real in enumerate(self.real_feature_idx):
            self.mappers[inner].value_to_bin(sub[:, real], out=out[:, inner])
        return out

    def _host_codes(self) -> np.ndarray:
        """The deferred rows binned through the host oracle."""
        return bin_dense_host(self._deferred.raw, self.mappers,
                              np.asarray(self.real_feature_idx, np.int64),
                              self._shape[0], self._code_dtype)

    def _materialize_host(self) -> np.ndarray:
        Log.info("deferred binning: materializing host X_binned "
                 "(%d x %d %s) through the host oracle",
                 self._shape[0], self._shape[1], self._code_dtype)
        X = self._host_codes()
        self._deferred = None
        return X

    @property
    def num_data(self) -> int:
        return int(self._shape[0])

    @property
    def num_features(self) -> int:
        return int(self._shape[1])

    @property
    def code_dtype(self):
        """The code dtype, read without materialising."""
        return self._code_dtype

    def bin_raw(self, data: np.ndarray) -> np.ndarray:
        """Bin a dense raw matrix with THIS dataset's mappers (a valid set
        aligned with its training set; the analog of
        LoadFromFileAlignWithOtherDataset, dataset_loader.cpp:221); CSR or
        CSC input column by column, as the training set."""
        if hasattr(data, "tocsc"):
            return bin_sparse_host(data.tocsc(), self.mappers,
                                   self.real_feature_idx.astype(np.int64),
                                   data.shape[0], self.code_dtype)
        data = np.asarray(data, dtype=np.float64)
        return bin_dense_host(data, self.mappers,
                              self.real_feature_idx.astype(np.int64),
                              data.shape[0], self.code_dtype)

    @property
    def max_num_bin(self) -> int:
        return int(self.num_bins_per_feature.max()) if len(self.mappers) \
            else 1

    # -- binary serialization (reference: Dataset::SaveBinaryFile,
    #    dataset.cpp:496; auto-detect load, dataset_loader.cpp:265) ----------

    def save_binary(self, path: str) -> None:
        """The JAX package's file (``lightgbm_tpu/dataset.py:331-348``): the
        same pickled keys and ``format`` tag. A deferred dataset's codes are
        binned on the host for the file (the codes host binning gives)
        and the dataset stays deferred."""
        codes = self._X_binned if self._X_binned is not None \
            else self._host_codes()
        with open(path, "wb") as fh:
            pickle.dump({
                "format": BINARY_FORMAT,
                "X_binned": codes,
                "mappers": self.mappers,
                "real_feature_idx": self.real_feature_idx,
                "num_total_features": self.num_total_features,
                "feature_names": self.feature_names,
                "label": self.metadata.label,
                "weight": self.metadata.weight,
                "query_boundaries": self.metadata.query_boundaries,
                "init_score": self.metadata.init_score,
                "config": self.config.to_dict(),
                "X_raw": self.X_raw,
            }, fh, protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def load_binary(cls, path: str) -> "ConstructedDataset":
        """Read a binary dataset file written by either package
        (``lightgbm_tpu/dataset.py:350-366``) through
        :class:`_BinaryDatasetUnpickler`: the JAX package's
        ``lightgbm_tpu.binning.BinMapper`` becomes this package's copy, and
        ``lightgbm_tpu`` is never imported."""
        with open(path, "rb") as fh:
            blob = _BinaryDatasetUnpickler(fh).load()
        if not isinstance(blob, dict) or blob.get("format") != BINARY_FORMAT:
            Log.fatal("Not a lightgbm_tpu binary dataset file: %s", path)
        meta = Metadata(blob["X_binned"].shape[0])
        meta.set_label(blob["label"])
        meta.set_weight(blob["weight"])
        meta.query_boundaries = blob["query_boundaries"]
        meta.init_score = blob["init_score"]
        features = [FeatureInfo(int(r), m)
                    for r, m in zip(blob["real_feature_idx"], blob["mappers"])]
        ds = cls(blob["X_binned"], features, blob["num_total_features"], meta,
                 blob["feature_names"], Config.from_params(blob["config"]))
        ds.X_raw = blob.get("X_raw")   # present iff saved under linear_tree
        return ds

    def feature_meta_arrays(self) -> Dict[str, np.ndarray]:
        """Static per-feature arrays consumed by the split scan."""
        missing_code = np.array(
            [{MISSING_NONE: 0, MISSING_ZERO: 1, MISSING_NAN: 2}[m.missing_type]
             for m in self.mappers], dtype=np.int32)
        default_bin = np.array([m.default_bin for m in self.mappers],
                               dtype=np.int32)
        is_categorical = np.array(
            [m.bin_type == BIN_CATEGORICAL for m in self.mappers], dtype=bool)
        return {"is_categorical": is_categorical,
                "missing_code": missing_code, "default_bin": default_bin,
                "num_bins": self.num_bins_per_feature}


BINARY_FORMAT = "lightgbm_tpu.dataset.v1"


class _BinaryDatasetUnpickler(pickle.Unpickler):
    """Unpickler of binary dataset files: builtins and numpy arrays, dtypes
    and scalars (``robustness/checkpoint.py``'s set), plus the bin mapper
    class of either package, which both load as this package's
    :class:`BinMapper` (the two have the same attributes); any other
    global is refused before its module is imported."""

    _MAPPERS = (("lightgbm_tpu.binning", "BinMapper"),
                ("lightgbm_tpu_torch.binning", "BinMapper"))

    def find_class(self, module: str, name: str):
        from .robustness.checkpoint import _SAFE_BUILTINS, _SAFE_NUMPY
        if (module, name) in self._MAPPERS:
            return BinMapper
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        if (module, name) in _SAFE_NUMPY or (
                module in ("numpy", "numpy.dtypes") and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"the binary dataset file holds {module}.{name}: a binary "
            f"dataset holds builtins, numpy arrays and bin mappers only")


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


def _find_bins(active: List[int], find_one,
               config: Optional[Config] = None) -> Dict[int, BinMapper]:
    """FindBin for every active feature, feature-sharded across the ranks
    of a world (``lightgbm_tpu/dataset.py:384``; reference distributed bin
    finding, dataset_loader.cpp:820-899): each rank finds the mappers of
    the features it owns (round-robin by rank), and the pickled shards are
    exchanged through ``parallel.comm.host_allgather``, so that every rank
    ends with the same mappers. Gated on the network config
    (``num_machines > 1``) and a live world, not on ambient state."""
    if config is None or getattr(config, "num_machines", 1) <= 1:
        return _map_find_bin(active, find_one)
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() <= 1:
        return _map_find_bin(active, find_one)
    from .parallel import comm
    rank, world = dist.get_rank(), dist.get_world_size()
    timeout_ms = int(getattr(config, "time_out", 120)) * 60 * 1000
    mine = _map_find_bin([j for j in active if j % world == rank], find_one)
    out: Dict[int, BinMapper] = {}
    for shard in comm.host_allgather(mine, "binmappers",
                                     timeout_ms=timeout_ms):
        out.update(shard)
    return {j: out[j] for j in active}


def construct_dataset(
    data: np.ndarray,
    label: Optional[Sequence[float]],
    config: Config,
    weight: Optional[Sequence[float]] = None,
    group: Optional[Sequence[int]] = None,
    init_score: Optional[Sequence[float]] = None,
    feature_names: Optional[List[str]] = None,
    categorical_features: Optional[Sequence[Union[int, str]]] = None,
) -> ConstructedDataset:
    """Build a ConstructedDataset from a dense numpy matrix or a
    ``scipy.sparse`` one.

    Mirrors DatasetLoader::ConstructBinMappersFromTextData
    (dataset_loader.cpp:748-903): sample -> FindBin per feature -> drop
    trivial features -> bin codes."""
    sparse = hasattr(data, "tocsc")
    if sparse:
        data = data.tocsc()            # columnwise access for binning
    else:
        data = np.ascontiguousarray(data)
    if data.ndim != 2:
        Log.fatal("Training data must be 2-dimensional")
    num_data, num_total_features = data.shape
    if feature_names is None:
        feature_names = [f"Column_{i}" for i in range(num_total_features)]
    # categorical columns by index or name, from the argument and the config
    cat_set = set()
    for c in categorical_features or ():
        cat_set.add(feature_names.index(c) if isinstance(c, str) else int(c))
    cat_set.update(_parse_column_spec(config.categorical_column,
                                      feature_names))
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
        bin_type = BIN_CATEGORICAL if j in cat_set else BIN_NUMERICAL
        mapper.find_bin(per_feature_samples[j], total_sample_cnt,
                        config.max_bin, config.min_data_in_bin, filter_cnt,
                        bin_type, config.use_missing, config.zero_as_missing)
        return mapper

    active = [j for j in range(num_total_features) if j not in ignore_set]
    with obs.span("construct.find_bins", features=len(active)):
        mappers_by_idx = _find_bins(active, _find_one, config)
    features = [FeatureInfo(j, mappers_by_idx[j]) for j in active
                if not mappers_by_idx[j].is_trivial]
    if not features:
        Log.warning("There are no meaningful features, as all feature "
                    "values are constant.")
    dtype = (np.uint8 if all(f.mapper.num_bin <= 256 for f in features)
             else np.uint16)

    # whether the rows are binned on the device (a scan of them all)
    with obs.span("construct.defer"):
        deferred = _maybe_defer(data, features, config, dtype, num_data,
                                sparse)
    if deferred is not None:
        X_binned = None
    else:
        binner = bin_sparse_host if sparse else bin_dense_host
        with obs.span("construct.bin", rows=num_data):
            X_binned = binner(
                data, [f.mapper for f in features],
                np.array([f.real_index for f in features], np.int64),
                num_data, dtype)

    metadata = Metadata(num_data)
    if label is not None:
        metadata.set_label(label)
    metadata.set_weight(weight)
    metadata.set_group(group)
    metadata.set_init_score(init_score)
    ds = ConstructedDataset(X_binned, features, num_total_features,
                            metadata, feature_names, config,
                            deferred=deferred)
    if config.linear_tree:
        ds.X_raw = extract_raw_slice(
            data, [f.real_index for f in features], num_data)
    return ds


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


def _csc_column(csc, j: int) -> Tuple[np.ndarray, np.ndarray]:
    """(row indices, f64 values) of column ``j`` by ``indptr`` slicing (for
    ``csc_matrix`` and ``csc_array`` alike)."""
    lo, hi = csc.indptr[j], csc.indptr[j + 1]
    return csc.indices[lo:hi], np.asarray(csc.data[lo:hi], dtype=np.float64)


def bin_sparse_host(csc, mappers, real_indices: np.ndarray, num_data: int,
                    dtype=np.uint8) -> np.ndarray:
    """Sparse host binning (``lightgbm_tpu/dataset.py:490-514``): each
    column takes its mapper's default bin, the zero bin, and its stored
    values are binned and scattered. The result is ``[num_data, F]`` in
    column-major order, so that every column is one contiguous write."""
    F = max(len(real_indices), 1)
    Xt = np.zeros((F, num_data), dtype=dtype)

    def _bin_column(inner: int):
        m = mappers[inner]
        rows, vals = _csc_column(csc, int(real_indices[inner]))
        Xt[inner] = m.default_bin
        if len(rows):
            Xt[inner, rows] = m.value_to_bin(vals)

    if num_data * F > 8_000_000 and len(real_indices) > 1:
        from concurrent.futures import ThreadPoolExecutor
        workers = min(16, os.cpu_count() or 1, len(real_indices))
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(_bin_column, range(len(real_indices))))
    else:
        for inner in range(len(real_indices)):
            _bin_column(inner)
    return Xt.T


# rows from which tpu_ingest=auto defers to device binning: below this
# the chunk set-up outweighs the host pass (the JAX package's threshold)
_AUTO_DEFER_MIN_ROWS = 65536


def _maybe_defer(data, features, config: Config, dtype, num_data: int,
                 sparse: bool) -> Optional[DeferredBinning]:
    """Decide at construction whether to skip host binning and hand the
    booster raw rows for device ingest (``lightgbm_tpu/dataset.py:
    592-616``): ``device`` defers whenever the input is eligible (else it
    warns and bins on the host); ``auto`` also needs enough rows."""
    mode = getattr(config, "tpu_ingest", "host")
    if mode not in ("device", "auto") or sparse or not features:
        return None
    from .ops.ingest import device_ingest_blocker
    blocker = device_ingest_blocker(data, [f.mapper for f in features])
    if blocker is None and mode == "auto" and num_data < _AUTO_DEFER_MIN_ROWS:
        blocker = (f"tpu_ingest=auto defers only at >= "
                   f"{_AUTO_DEFER_MIN_ROWS} rows (got {num_data})")
    if blocker is not None:
        if mode == "device":
            Log.warning("tpu_ingest=device: falling back to host binning "
                        "(%s)", blocker)
        else:
            Log.debug("tpu_ingest=auto: host binning (%s)", blocker)
        return None
    Log.debug("tpu_ingest=%s: deferring binning to device ingest "
              "(%d rows x %d features)", mode, num_data, len(features))
    return DeferredBinning(raw=data, code_dtype=np.dtype(dtype))


def extract_raw_slice(data, real_indices, num_data: int) -> np.ndarray:
    """``[N, used features]`` f32 raw values (NaN kept) for the linear-leaf
    fit (``lightgbm_tpu/dataset.py:617-635``); a sparse input is densified
    column by column, its implicit zeros numeric 0.0."""
    out = np.zeros((num_data, max(len(real_indices), 1)), np.float32)
    if hasattr(data, "tocsc"):
        csc = data.tocsc()
        for inner, real in enumerate(real_indices):
            rows, vals = _csc_column(csc, real)
            if len(rows):
                out[rows, inner] = vals.astype(np.float32)
        return out
    data = np.asarray(data)
    for inner, real in enumerate(real_indices):
        out[:, inner] = np.asarray(data[:, real], np.float32)
    return out
