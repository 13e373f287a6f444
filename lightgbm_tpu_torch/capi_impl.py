"""Python side of the C API (reference: src/c_api.cpp, 1,448 LoC) — a copy of
``lightgbm_tpu/capi_impl.py`` with the same registry handles and buffer
conventions.

The native shim (``csrc/lgbm_capi.c``, built at first use by
``capi_shim.build_shim``) exposes the reference's ``LGBM_*`` symbols and
proxies every call here. The split keeps the C layer to
argument forwarding: buffers cross the boundary as raw addresses
(int64) + dtype codes, and this module views them with numpy/ctypes —
zero-copy in, explicit memcpy out. Handles given to C are small integers
into a registry (no PyObject lifetime crosses the boundary).

Matches c_api.h semantics: C_API_DTYPE_* codes (c_api.h:22-25),
C_API_PREDICT_* (c_api.h:27-30), 0/-1 return codes with
LGBM_GetLastError() carrying the message. ``LGBM_BoosterCreate`` reads
``device`` from its parameter string like every other entry point: the
card unless ``device=cpu``. ``LGBM_NetworkInit`` with more than one machine
raises (multi-GPU training, ROADMAP A16). The R bridge (``R-package/``)
is not ported: it drives the JAX package through reticulate, and its
smoke test needs ``Rscript``.
"""
from __future__ import annotations

import ctypes
import functools
import json
import threading
from typing import Dict, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import resolve_aliases

# ---- handle registry -------------------------------------------------------
# The registry itself and each handle's object are mutex-guarded like the
# reference (c_api.cpp:29 Booster lock, :67 handle lifetime): the embedded-C
# hosting mode may call in from multiple native threads, and torch/numpy
# release the GIL mid-operation.

_objects: Dict[int, object] = {}
_next_handle = [1]
_registry_lock = threading.RLock()
_handle_locks: Dict[int, threading.RLock] = {}


def _register(obj) -> int:
    with _registry_lock:
        h = _next_handle[0]
        _next_handle[0] += 1
        _objects[h] = obj
        _handle_locks[h] = threading.RLock()
        return h


def _get(h: int):
    with _registry_lock:
        return _objects[int(h)]


def _lock_of(h: int) -> threading.RLock:
    with _registry_lock:
        return _handle_locks.setdefault(int(h), threading.RLock())


def _with_handle_lock(fn):
    """Serialize operations on one handle (first argument)."""
    @functools.wraps(fn)
    def wrapper(handle, *args, **kwargs):
        with _lock_of(handle):
            return fn(handle, *args, **kwargs)
    return wrapper


def free_handle(h: int) -> None:
    with _registry_lock:
        _objects.pop(int(h), None)
        _handle_locks.pop(int(h), None)


# ---- raw-memory views ------------------------------------------------------

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64}


def _view(ptr: int, dtype_code: int, count: int) -> np.ndarray:
    ct = {0: ctypes.c_float, 1: ctypes.c_double,
          2: ctypes.c_int32, 3: ctypes.c_int64}[int(dtype_code)]
    buf = (ct * int(count)).from_address(int(ptr))
    return np.ctypeslib.as_array(buf)


def _write_doubles(ptr: int, values: np.ndarray) -> int:
    arr = np.ascontiguousarray(values, dtype=np.float64)
    ctypes.memmove(int(ptr), arr.ctypes.data, arr.nbytes)
    return arr.size


def _write_string(ptr: int, text: str, buffer_len: int) -> int:
    """Reference out_len contract (c_api.cpp SaveModelToString): report
    len+1 (including NUL) and copy ONLY when the whole string fits, so the
    two-call size-then-fetch protocol never truncates silently."""
    raw = text.encode("utf-8") + b"\0"
    if len(raw) <= int(buffer_len):
        ctypes.memmove(int(ptr), raw, len(raw))
    return len(raw)


def _write_string_array(ptrs_addr: int, strings, each_len: int = 255) -> int:
    """Fill a char** (preallocated buffers, reference basic.py convention)."""
    arr = (ctypes.c_void_p * len(strings)).from_address(int(ptrs_addr))
    for i, s in enumerate(strings):
        raw = s.encode("utf-8")[: each_len - 1] + b"\0"
        ctypes.memmove(arr[i], raw, len(raw))
    return len(strings)


def _params(parameters: Optional[str]) -> dict:
    out = {}
    for tok in (parameters or "").replace("\n", " ").split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k] = v
    return resolve_aliases(out)


# ---- dataset ---------------------------------------------------------------

def dataset_create_from_file(filename: str, parameters: str,
                             reference: int) -> int:
    params = _params(parameters)
    ref = _get(reference) if reference else None
    ds = Dataset(filename, params=params, reference=ref)
    ds.construct()
    return _register(ds)


def dataset_create_from_mat(data_ptr: int, data_type: int, nrow: int,
                            ncol: int, is_row_major: int, parameters: str,
                            reference: int) -> int:
    flat = _view(data_ptr, data_type, nrow * ncol)
    mat = flat.reshape(nrow, ncol) if is_row_major else \
        flat.reshape(ncol, nrow).T
    params = _params(parameters)
    ref = _get(reference) if reference else None
    ds = Dataset(np.array(mat, dtype=np.float64), params=params, reference=ref)
    return _register(ds)


def dataset_create_from_csr(indptr_ptr: int, indptr_type: int,
                            indices_ptr: int, data_ptr: int, data_type: int,
                            nindptr: int, nelem: int, num_col: int,
                            parameters: str, reference: int) -> int:
    import scipy.sparse as sp
    indptr = _view(indptr_ptr, indptr_type, nindptr).astype(np.int64)
    indices = _view(indices_ptr, 2, nelem)
    data = _view(data_ptr, data_type, nelem)
    csr = sp.csr_matrix((np.array(data, np.float64), np.array(indices),
                         np.array(indptr)), shape=(nindptr - 1, num_col))
    ref = _get(reference) if reference else None
    ds = Dataset(csr, params=_params(parameters), reference=ref)
    return _register(ds)


def dataset_create_from_csc(colptr_ptr: int, colptr_type: int,
                            indices_ptr: int, data_ptr: int, data_type: int,
                            ncolptr: int, nelem: int, num_row: int,
                            parameters: str, reference: int) -> int:
    import scipy.sparse as sp
    colptr = _view(colptr_ptr, colptr_type, ncolptr).astype(np.int64)
    indices = _view(indices_ptr, 2, nelem)
    data = _view(data_ptr, data_type, nelem)
    csc = sp.csc_matrix((np.array(data, np.float64), np.array(indices),
                         np.array(colptr)), shape=(num_row, ncolptr - 1))
    ds = Dataset(csc, params=_params(parameters),
                 reference=_get(reference) if reference else None)
    return _register(ds)


class _StreamingDataset:
    """Chunk-streamed dataset creation (reference c_api.h:67-127:
    LGBM_DatasetCreateFromSampledColumn / CreateByReference + PushRows[ByCSR]).

    An inversion of the reference's push path: BinMappers are built
    up-front (from the provided column sample, or borrowed from the reference
    dataset), and every pushed chunk is binned to uint8/16 codes immediately —
    the float matrix never materializes, so ingestion is genuinely
    out-of-core like the reference's PushData → FinishLoad flow."""

    def __init__(self, features, num_total_features, feature_names, config,
                 params, num_total_row: int, ref_basic: Optional[Dataset]):
        self.features = features                    # List[FeatureInfo]
        self.num_total_features = num_total_features
        self.feature_names = feature_names
        self.config = config
        self.params = params
        self.num_total_row = int(num_total_row)
        self.ref_basic = ref_basic
        dtype = np.uint8 if all(f.mapper.num_bin <= 256 for f in features) \
            else np.uint16
        self.X_binned = np.zeros((self.num_total_row, max(len(features), 1)),
                                 dtype=dtype)
        self.fields: Dict[str, np.ndarray] = {}

    @classmethod
    def from_reference(cls, ref_basic: Dataset, num_total_row: int,
                       params: dict) -> "_StreamingDataset":
        from .dataset import FeatureInfo
        ref_basic.construct()
        cd = ref_basic._constructed
        if cd is None:
            raise ValueError("reference dataset has no constructed bin "
                             "mappers (is it itself an aligned valid set?)")
        features = [FeatureInfo(int(r), m)
                    for r, m in zip(cd.real_feature_idx, cd.mappers)]
        return cls(features, cd.num_total_features, cd.feature_names,
                   cd.config, params, num_total_row, ref_basic)

    @classmethod
    def from_samples(cls, samples, num_sample_row: int, num_total_row: int,
                     params: dict) -> "_StreamingDataset":
        """``samples[j]``: sampled NON-ZERO values of column j (zeros implied
        by num_sample_row — the BinMapper::FindBin contract, bin.cpp:232)."""
        from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper
        from .config import Config
        from .dataset import FeatureInfo, _parse_column_spec
        config = Config.from_params(params)
        ncol = len(samples)
        feature_names = [f"Column_{i}" for i in range(ncol)]
        cat_set = set(_parse_column_spec(config.categorical_column,
                                         feature_names))
        filter_cnt = int(config.min_data_in_leaf * num_sample_row
                         / max(num_total_row, 1))
        features = []
        for j in range(ncol):
            mapper = BinMapper()
            mapper.find_bin(
                np.asarray(samples[j], dtype=np.float64), num_sample_row,
                config.max_bin, config.min_data_in_bin, filter_cnt,
                BIN_CATEGORICAL if j in cat_set else BIN_NUMERICAL,
                config.use_missing, config.zero_as_missing)
            if not mapper.is_trivial:
                features.append(FeatureInfo(j, mapper))
        return cls(features, ncol, feature_names, config, params,
                   num_total_row, None)

    def push_dense(self, chunk: np.ndarray, start_row: int) -> bool:
        n = chunk.shape[0]
        if start_row + n > self.num_total_row:
            raise ValueError(f"push beyond num_total_row: {start_row}+{n} > "
                             f"{self.num_total_row}")
        dt = self.X_binned.dtype
        for inner, f in enumerate(self.features):
            self.X_binned[start_row:start_row + n, inner] = \
                f.mapper.value_to_bin(chunk[:, f.real_index]).astype(dt)
        # reference: FinishLoad when nrow + start_row == num_total_row
        return start_row + n == self.num_total_row

    # buffered metadata: the reference allows SetField before FinishLoad
    def set_label(self, v):
        self.fields["label"] = v

    def set_weight(self, v):
        self.fields["weight"] = v

    def set_group(self, v):
        self.fields["group"] = v

    def set_init_score(self, v):
        self.fields["init_score"] = v

    def num_data(self) -> int:
        return self.num_total_row

    def num_feature(self) -> int:
        return self.num_total_features

    def finish(self) -> Dataset:
        """Materialize the real Dataset; the caller swaps it into the
        registry under the same handle (the C side's pointer is unchanged)."""
        from .dataset import ConstructedDataset, Metadata
        meta = Metadata(self.num_total_row)
        if "label" in self.fields:
            meta.set_label(self.fields["label"])
        if "weight" in self.fields:
            meta.set_weight(self.fields["weight"])
        if "group" in self.fields:
            meta.set_group(self.fields["group"])
        if "init_score" in self.fields:
            meta.set_init_score(self.fields["init_score"])
        cd = ConstructedDataset(self.X_binned, self.features,
                                self.num_total_features, meta,
                                self.feature_names, self.config)
        d = Dataset(np.zeros((0, 1)), params=dict(self.params))
        d._constructed = cd
        # mirror buffered fields onto the Dataset attributes too, so
        # LGBM_DatasetGetField sees what was SetField'd before the last push
        d.label = meta.label
        d.weight = self.fields.get("weight")
        d.group = self.fields.get("group")
        d.init_score = self.fields.get("init_score")
        if self.ref_basic is not None:
            # usable as an aligned valid set too (Booster.add_valid contract)
            d.reference = self.ref_basic
            d._binned_aligned = self.X_binned
            d._metadata = meta
        return d


def dataset_create_by_reference(reference: int, num_total_row: int) -> int:
    with _lock_of(reference):            # from_reference constructs the ref
        stream = _StreamingDataset.from_reference(_get(reference),
                                                  int(num_total_row), {})
    return _register(stream)


def dataset_create_from_sampled_column(col_ptrs_addr: int, ind_ptrs_addr: int,
                                       ncol: int, num_per_col_ptr: int,
                                       num_sample_row: int,
                                       num_total_row: int,
                                       parameters: str) -> int:
    npc = np.array(_view(num_per_col_ptr, 2, ncol))
    col_ptrs = (ctypes.c_void_p * int(ncol)).from_address(int(col_ptrs_addr))
    samples = [np.array(_view(col_ptrs[j], 1, int(npc[j])))
               if npc[j] else np.zeros(0) for j in range(int(ncol))]
    stream = _StreamingDataset.from_samples(samples, int(num_sample_row),
                                            int(num_total_row),
                                            _params(parameters))
    return _register(stream)


def _finish_stream(handle: int, stream: _StreamingDataset) -> None:
    with _registry_lock:
        _objects[int(handle)] = stream.finish()


@_with_handle_lock
def dataset_push_rows(handle: int, data_ptr: int, data_type: int, nrow: int,
                      ncol: int, start_row: int) -> None:
    stream: _StreamingDataset = _get(handle)
    chunk = np.array(_view(data_ptr, data_type, nrow * ncol),
                     dtype=np.float64).reshape(nrow, ncol)
    if stream.push_dense(chunk, int(start_row)):
        _finish_stream(handle, stream)


@_with_handle_lock
def dataset_push_rows_by_csr(handle: int, indptr_ptr: int, indptr_type: int,
                             indices_ptr: int, data_ptr: int, data_type: int,
                             nindptr: int, nelem: int, num_col: int,
                             start_row: int) -> None:
    import scipy.sparse as sp
    stream: _StreamingDataset = _get(handle)
    indptr = np.array(_view(indptr_ptr, indptr_type, nindptr), dtype=np.int64)
    indices = np.array(_view(indices_ptr, 2, nelem))
    data = np.array(_view(data_ptr, data_type, nelem), dtype=np.float64)
    chunk = sp.csr_matrix((data, indices, indptr),
                          shape=(int(nindptr) - 1, int(num_col))).toarray()
    if stream.push_dense(chunk, int(start_row)):
        _finish_stream(handle, stream)


def dataset_get_subset(handle: int, indices_ptr: int, num_indices: int,
                       parameters: str) -> int:
    ds: Dataset = _get(handle)
    idx = np.array(_view(indices_ptr, 2, num_indices))
    return _register(ds.subset(idx, params=_params(parameters)))


def dataset_set_feature_names(handle: int, names) -> None:
    _get(handle).feature_name = list(names)


def dataset_get_feature_names(handle: int, ptrs_addr: int) -> int:
    ds: Dataset = _get(handle)
    names = ds.feature_name if isinstance(ds.feature_name, list) else \
        [f"Column_{i}" for i in range(ds.num_feature())]
    return _write_string_array(ptrs_addr, names)


@_with_handle_lock
def dataset_save_binary(handle: int, filename: str) -> None:
    ds: Dataset = _get(handle)
    ds.construct()
    ds._constructed.save_binary(filename)


@_with_handle_lock
def dataset_set_field(handle: int, field: str, ptr: int, n: int,
                      dtype_code: int) -> None:
    ds: Dataset = _get(handle)
    arr = np.array(_view(ptr, dtype_code, n))
    if field == "label":
        ds.set_label(arr.astype(np.float32))
    elif field == "weight":
        ds.set_weight(arr.astype(np.float32))
    elif field in ("group", "query"):
        ds.set_group(arr.astype(np.int32))
    elif field == "init_score":
        ds.set_init_score(arr.astype(np.float64))
    else:
        raise ValueError(f"unknown field {field}")


@_with_handle_lock
def dataset_get_field(handle: int, field: str, out_ptr_addr: int,
                      out_type_addr: int) -> int:
    """Returns length; writes the array pointer + dtype code like
    LGBM_DatasetGetField (c_api.cpp). The array is kept alive on the
    dataset object."""
    ds: Dataset = _get(handle)
    val = ds.get_field(field)
    if val is None:
        return 0
    if field in ("group", "query"):
        arr = np.ascontiguousarray(val, dtype=np.int32)
        code = 2
    else:
        arr = np.ascontiguousarray(val, dtype=np.float32)
        code = 0
    if not hasattr(ds, "_capi_field_refs"):
        ds._capi_field_refs = {}
    ds._capi_field_refs[field] = arr            # keep buffer alive
    ctypes.c_void_p.from_address(int(out_ptr_addr)).value = arr.ctypes.data
    ctypes.c_int32.from_address(int(out_type_addr)).value = code
    return arr.size


def dataset_get_num_data(handle: int) -> int:
    return int(_get(handle).num_data())


def dataset_get_num_feature(handle: int) -> int:
    return int(_get(handle).num_feature())


# ---- booster ---------------------------------------------------------------

def booster_create(train_handle: int, parameters: str) -> int:
    with _lock_of(train_handle):         # construction mutates the dataset
        bst = Booster(params=_params(parameters),
                      train_set=_get(train_handle))
    return _register(bst)


def booster_create_from_modelfile(filename: str) -> int:
    return _register(Booster(model_file=filename))


def booster_load_from_string(model_str: str) -> int:
    return _register(Booster(model_str=model_str))


def booster_add_valid_data(handle: int, valid_handle: int) -> None:
    # two locks in handle order (same protocol as booster_merge): add_valid
    # constructs/aligns the valid dataset, which mutates it
    h1, h2 = sorted((int(handle), int(valid_handle)))
    with _lock_of(h1), _lock_of(h2):
        bst: Booster = _get(handle)
        vs: Dataset = _get(valid_handle)
        if vs.reference is None:
            vs.reference = bst.train_dataset
        bst.add_valid(vs, f"valid_{len(getattr(bst._gbdt, 'valid_sets', []))}")


@_with_handle_lock
def booster_reset_training_data(handle: int, train_handle: int) -> None:
    bst: Booster = _get(handle)
    # update(train_set=...) swaps the data AND trains one iteration;
    # rollback_one_iter fully reverts that extra iteration (trees + score),
    # matching LGBM_BoosterResetTrainingData's swap-only contract
    bst.update(train_set=_get(train_handle))
    bst.rollback_one_iter()


@_with_handle_lock
def booster_reset_parameter(handle: int, parameters: str) -> None:
    _get(handle).reset_parameter(_params(parameters))


def booster_get_num_classes(handle: int) -> int:
    return max(int(_get(handle).params.get("num_class", 1)), 1)


@_with_handle_lock
def booster_update_one_iter(handle: int) -> int:
    bst: Booster = _get(handle)
    before = bst._gbdt.iter_
    bst.update()
    return 1 if bst._gbdt.iter_ == before else 0   # is_finished


def dataset_get_num_data_of_booster(handle: int) -> int:
    """Gradient length for LGBM_BoosterUpdateOneIterCustom: num_data *
    num_models (class-major, reference c_api.cpp UpdateOneIterCustom)."""
    bst: Booster = _get(handle)
    return int(bst.train_dataset.num_data()
               * max(bst.num_model_per_iteration, 1))


@_with_handle_lock
def booster_update_one_iter_custom(handle: int, grad_ptr: int, hess_ptr: int,
                                   n: int) -> int:
    bst: Booster = _get(handle)
    g = np.array(_view(grad_ptr, 0, n), np.float64)
    h = np.array(_view(hess_ptr, 0, n), np.float64)
    bst.update(fobj=lambda preds, ds: (g, h))
    return 0


@_with_handle_lock
def booster_rollback_one_iter(handle: int) -> None:
    _get(handle).rollback_one_iter()


def booster_merge(handle: int, other_handle: int) -> None:
    """LGBM_BoosterMerge (c_api.h:361): append other's trees to handle's
    forest. Device training state of the target is released (resume by
    passing a train_set to the next update, the continued-training path);
    the merged model predicts/saves immediately — the reference's
    worker-train-then-merge usage."""
    import copy
    h1, h2 = sorted((int(handle), int(other_handle)))
    with _lock_of(h1), _lock_of(h2):
        bst: Booster = _sync(_get(handle))
        other: Booster = _sync(_get(other_handle))
        if max(bst.num_model_per_iteration, 1) != \
                max(other.num_model_per_iteration, 1):
            raise ValueError("cannot merge boosters with different "
                             "models-per-iteration")
        if bst._gbdt is not None:
            bst.free_dataset()
        bst.trees = list(bst.trees) + [copy.deepcopy(t) for t in other.trees]
        bst._forest_rev += 1     # keys the stacked forests of the device walk


@_with_handle_lock
def booster_get_num_predict(handle: int, data_idx: int) -> int:
    """LGBM_BoosterGetNumPredict (c_api.h:488): score length for the
    training data (0) or i-th valid set (i+1)."""
    gbdt = _get(handle)._gbdt
    if gbdt is None:
        raise ValueError("booster has no training data attached")
    if int(data_idx) == 0:
        n = gbdt.num_data
    else:
        n = gbdt.valid_sets[int(data_idx) - 1].num_data
    return int(n) * max(gbdt.num_models, 1)


@_with_handle_lock
def booster_get_predict(handle: int, data_idx: int, out_ptr: int) -> int:
    """LGBM_BoosterGetPredict (c_api.h:502): current objective-transformed
    scores of train/valid rows, class-major like GBDT::GetPredictAt
    (gbdt.cpp:683-708)."""
    gbdt = _get(handle)._gbdt
    if gbdt is None:
        raise ValueError("booster has no training data attached")
    if int(data_idx) == 0:
        scores = gbdt._convert(gbdt.score).cpu().numpy()[:, : gbdt.num_data]
    else:
        vs = gbdt.valid_sets[int(data_idx) - 1]
        scores = gbdt._convert(vs.score).cpu().numpy()[:, : vs.num_data]
    return _write_doubles(out_ptr, np.asarray(scores, np.float64).reshape(-1))


def _sync(bst: Booster) -> Booster:
    """Materialize host trees from device state — the C API drives raw
    update() calls, so predict/save/dump must see the current forest
    (engine.train does this once at the end; here it's lazy per call)."""
    bst._ensure_finalized()
    return bst


def booster_get_current_iteration(handle: int) -> int:
    bst: Booster = _get(handle)
    if bst._gbdt is not None:
        return int(bst._gbdt.iter_)
    return int(bst.current_iteration())


def _metric_names(bst: Booster):
    """Per-dataset metric names — the c_api contract counts METRICS, not
    (dataset, metric) pairs (c_api.h GetEvalCounts/GetEvalNames)."""
    gbdt = bst._gbdt
    if gbdt is None:
        return []
    metrics = gbdt.valid_sets[0].metrics if gbdt.valid_sets else \
        getattr(gbdt, "train_metrics", [])
    return [m.name for m in metrics]


def booster_get_eval_counts(handle: int) -> int:
    return len(_metric_names(_get(handle)))


def booster_get_eval_names(handle: int, ptrs_addr: int) -> int:
    return _write_string_array(ptrs_addr, _metric_names(_get(handle)))


@_with_handle_lock
def booster_get_eval(handle: int, data_idx: int, out_ptr: int) -> int:
    """data_idx 0 = training, i+1 = i-th valid set (c_api.h:474)."""
    bst: Booster = _get(handle)
    gbdt = bst._gbdt
    rows = gbdt.eval_all()
    names = {0: "training"}
    for i, vs in enumerate(gbdt.valid_sets):
        names[i + 1] = vs.name
    want = names.get(int(data_idx))
    vals = [v for (d, _m, v, _h) in rows if d == want]
    return _write_doubles(out_ptr, np.array(vals, np.float64))


def booster_get_feature_names(handle: int, ptrs_addr: int) -> int:
    return _write_string_array(ptrs_addr, _get(handle).feature_name())


def booster_get_num_feature(handle: int) -> int:
    return int(_get(handle).num_total_features)


@_with_handle_lock
def booster_calc_num_predict(handle: int, num_row: int, predict_type: int,
                             num_iteration: int) -> int:
    bst: Booster = _sync(_get(handle))
    K = max(bst.num_model_per_iteration, 1)
    n_iter = bst.current_iteration() if num_iteration <= 0 else \
        min(num_iteration, bst.current_iteration())
    if predict_type == 2:       # leaf index
        return num_row * K * n_iter
    if predict_type == 3:       # contrib
        return num_row * K * (bst.num_total_features + 1)
    return num_row * K


def _predict(bst: Booster, X, predict_type: int, num_iteration: int,
             parameter: str, out_ptr: int) -> int:
    _sync(bst)
    kw = {}
    p = _params(parameter)
    if "pred_early_stop" in p:
        kw["pred_early_stop"] = p["pred_early_stop"] in ("1", "true")
    preds = bst.predict(
        X, num_iteration=num_iteration if num_iteration > 0 else None,
        raw_score=predict_type == 1, pred_leaf=predict_type == 2,
        pred_contrib=predict_type == 3, **kw)
    return _write_doubles(out_ptr, np.asarray(preds, np.float64))


@_with_handle_lock
def booster_predict_for_mat(handle: int, data_ptr: int, data_type: int,
                            nrow: int, ncol: int, is_row_major: int,
                            predict_type: int, num_iteration: int,
                            parameter: str, out_ptr: int) -> int:
    flat = _view(data_ptr, data_type, nrow * ncol)
    X = flat.reshape(nrow, ncol) if is_row_major else flat.reshape(ncol, nrow).T
    return _predict(_get(handle), np.array(X, np.float64), predict_type,
                    num_iteration, parameter, out_ptr)


@_with_handle_lock
def booster_predict_for_csr(handle: int, indptr_ptr: int, indptr_type: int,
                            indices_ptr: int, data_ptr: int, data_type: int,
                            nindptr: int, nelem: int, num_col: int,
                            predict_type: int, num_iteration: int,
                            parameter: str, out_ptr: int) -> int:
    import scipy.sparse as sp
    indptr = _view(indptr_ptr, indptr_type, nindptr).astype(np.int64)
    indices = _view(indices_ptr, 2, nelem)
    data = _view(data_ptr, data_type, nelem)
    csr = sp.csr_matrix((np.array(data, np.float64), np.array(indices),
                         np.array(indptr)), shape=(nindptr - 1, num_col))
    return _predict(_get(handle), csr, predict_type, num_iteration,
                    parameter, out_ptr)


@_with_handle_lock
def booster_predict_for_csc(handle: int, colptr_ptr: int, colptr_type: int,
                            indices_ptr: int, data_ptr: int, data_type: int,
                            ncolptr: int, nelem: int, num_row: int,
                            predict_type: int, num_iteration: int,
                            parameter: str, out_ptr: int) -> int:
    import scipy.sparse as sp
    colptr = _view(colptr_ptr, colptr_type, ncolptr).astype(np.int64)
    indices = _view(indices_ptr, 2, nelem)
    data = _view(data_ptr, data_type, nelem)
    csc = sp.csc_matrix((np.array(data, np.float64), np.array(indices),
                         np.array(colptr)), shape=(num_row, ncolptr - 1))
    return _predict(_get(handle), csc.tocsr(), predict_type, num_iteration,
                    parameter, out_ptr)


@_with_handle_lock
def booster_predict_for_file(handle: int, data_filename: str,
                             data_has_header: int, predict_type: int,
                             num_iteration: int, parameter: str,
                             result_filename: str) -> None:
    from .io.file_io import load_data_file
    p = _params(parameter)
    if data_has_header:
        p["has_header"] = "true"
    X, _, _ = load_data_file(data_filename, p)
    bst: Booster = _sync(_get(handle))
    preds = bst.predict(
        X, num_iteration=num_iteration if num_iteration > 0 else None,
        raw_score=predict_type == 1, pred_leaf=predict_type == 2,
        pred_contrib=predict_type == 3)
    preds = np.atleast_2d(preds.T).T if preds.ndim == 1 else preds
    with open(result_filename, "w") as fh:
        for row in (preds if preds.ndim == 2 else preds[:, None]):
            fh.write("\t".join(f"{v:.18g}" for v in np.atleast_1d(row)) + "\n")


@_with_handle_lock
def booster_save_model(handle: int, num_iteration: int, filename: str) -> None:
    _sync(_get(handle)).save_model(filename,
                            num_iteration if num_iteration > 0 else None)


@_with_handle_lock
def booster_save_model_to_string(handle: int, num_iteration: int,
                                 buffer_len: int, out_ptr: int) -> int:
    text = _sync(_get(handle)).model_to_string(
        num_iteration if num_iteration > 0 else None)
    return _write_string(out_ptr, text, buffer_len)


@_with_handle_lock
def booster_dump_model(handle: int, num_iteration: int, buffer_len: int,
                       out_ptr: int) -> int:
    d = _sync(_get(handle)).dump_model(num_iteration if num_iteration > 0 else None)
    return _write_string(out_ptr, json.dumps(d), buffer_len)


@_with_handle_lock
def booster_get_leaf_value(handle: int, tree_idx: int, leaf_idx: int) -> float:
    return float(_sync(_get(handle)).trees[int(tree_idx)].leaf_value[int(leaf_idx)])


@_with_handle_lock
def booster_set_leaf_value(handle: int, tree_idx: int, leaf_idx: int,
                           val: float) -> None:
    bst: Booster = _sync(_get(handle))
    bst.trees[int(tree_idx)].leaf_value[int(leaf_idx)] = val
    bst._forest_rev += 1     # the device walk's stacked forests copy leaf values


@_with_handle_lock
def booster_feature_importance(handle: int, num_iteration: int,
                               importance_type: int, out_ptr: int) -> int:
    imp = _sync(_get(handle)).feature_importance(
        "split" if importance_type == 0 else "gain")
    return _write_doubles(out_ptr, np.asarray(imp, np.float64))


def network_init(machines: str, local_listen_port: int, listen_time_out: int,
                 num_machines: int) -> None:
    """One machine needs no network; more is multi-GPU training, not
    ported yet."""
    if int(num_machines) > 1:
        from .utils.log import Log
        Log.fatal("LGBM_NetworkInit with num_machines=%d: multi-GPU training "
                  "is not ported to lightgbm_tpu_torch yet (ROADMAP A16)",
                  int(num_machines))


def network_free() -> None:
    pass        # one machine: nothing was wired
