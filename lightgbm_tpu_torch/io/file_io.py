"""Text data loading: CSV / TSV / LibSVM with auto-detection, at scale — a
copy of ``lightgbm_tpu/io/file_io.py``.

Reference: src/io/parser.{cpp,hpp} (CreateParser format sniffing) and
src/io/dataset_loader.cpp:
- column specs by index or ``name:`` for label/weight/group/ignore
  (dataset_loader.cpp column resolution, dataset.h:36-248 Metadata columns),
- side files ``<data>.query`` / ``.weight`` / ``.init`` picked up when
  present (metadata.cpp conventions),
- two-round loading for big files (dataset_loader.cpp:159-265): round one
  streams the file to sample rows for bin finding, round two streams again
  pushing bin codes straight into the binned matrix — peak memory is one
  chunk of floats plus the uint8/16 bin matrix, never the full float matrix.

The CSV / TSV reader is pandas' C reader with exactly the JAX package's
arguments, so the parsed floats are the JAX package's bit for bit; text
files need pandas (without it they raise naming it). No other reader is
kept: numpy's parses 17-digit decimals differently (ROADMAP C22), so one
file would give other floats on a machine without pandas.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.log import LightGBMError, Log

_NA_VALUES = ["", "na", "NA", "nan", "NaN", "null", "N/A"]
_CHUNK_ROWS = 1 << 19


def _sniff_format(sample_lines: List[str]) -> str:
    for line in sample_lines:
        line = line.strip()
        if not line:
            continue
        tokens = line.replace("\t", " ").split()
        if any(":" in t for t in tokens[1:]):
            return "libsvm"
        if "\t" in line:
            return "tsv"
        if "," in line:
            return "csv"
    return "tsv"


def _head_lines(path: str, n: int = 20) -> List[str]:
    out = []
    with open(path, "r") as fh:
        for _ in range(n):
            line = fh.readline()
            if not line:
                break
            out.append(line.rstrip("\n"))
    return out


def is_binary_dataset(path: str) -> bool:
    """Binary dataset auto-detect (reference: token check on load,
    dataset_loader.cpp:265)."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(4096)
    except OSError:
        return False
    return head[:1] == b"\x80" and b"lightgbm_tpu.dataset" in head


def _resolve_col(spec: str, header: Optional[List[str]], default: int = -1) -> int:
    spec = str(spec or "").strip()
    if not spec:
        return default
    if spec.startswith("name:"):
        if header is None:
            Log.fatal("Column spec %s requires has_header=true", spec)
        name = spec[5:]
        if name not in header:
            Log.fatal("Column name %s not found in header", name)
        return header.index(name)
    return int(spec)


def _resolve_cols(spec: str, header: Optional[List[str]]) -> List[int]:
    if not spec:
        return []
    return [_resolve_col(tok, header) for tok in str(spec).split(",") if tok.strip()]


def _has_header(params: Dict) -> bool:
    """``has_header`` (or ``header``) as a bool: a string from a conf file
    or the command line is parsed, so ``has_header=false`` keeps the first
    row (the JAX package takes any non-empty string as true)."""
    from ..config import _parse_bool
    v = params.get("has_header") or params.get("header")
    return _parse_bool(v, "has_header") if isinstance(v, str) else bool(v)


def _group_ids_to_sizes(ids: np.ndarray) -> np.ndarray:
    """Query-id column -> per-query sizes (reference metadata.cpp: rows with
    the same consecutive query id form one group)."""
    if len(ids) == 0:
        return np.zeros(0, np.int64)
    change = np.nonzero(np.diff(ids))[0]
    bounds = np.concatenate([[0], change + 1, [len(ids)]])
    return np.diff(bounds)


def _read_chunks(path: str, fmt: str, has_header: bool):
    """Yield float64 [rows, cols] chunks of at most ``_CHUNK_ROWS`` rows."""
    try:
        import pandas as pd
    except ImportError:
        raise LightGBMError("reading CSV or TSV data files needs pandas, "
                            "whose C reader gives the JAX package's floats "
                            "(ROADMAP C22): install pandas, or pass arrays "
                            "or a LibSVM or binary file") from None
    chunks = pd.read_csv(path, sep="\t" if fmt == "tsv" else ",",
                         header=None, skiprows=1 if has_header else 0,
                         na_values=_NA_VALUES, keep_default_na=True,
                         dtype=np.float64, chunksize=_CHUNK_ROWS, engine="c")
    for chunk in chunks:
        yield chunk.to_numpy(dtype=np.float64, copy=False)


def _parse_libsvm_rows(lines) -> Tuple[List[float], List[Dict[int, float]], int]:
    """(labels, per-row {feature: value} dicts, max feature index)."""
    labels: List[float] = []
    rows: List[Dict[int, float]] = []
    max_idx = -1
    for line in lines:
        line = line.strip()
        if not line:
            continue
        toks = line.split()
        labels.append(float(toks[0]))
        feats = {}
        for t in toks[1:]:
            k, v = t.split(":", 1)
            k = int(k)
            feats[k] = float(v)
            max_idx = max(max_idx, k)
        rows.append(feats)
    return labels, rows, max_idx


def _parse_libsvm(lines) -> Tuple[np.ndarray, np.ndarray]:
    labels, rows, max_idx = _parse_libsvm_rows(lines)
    X = np.zeros((len(rows), max_idx + 1), dtype=np.float64)
    for i, feats in enumerate(rows):
        for k, v in feats.items():
            X[i, k] = v
    return X, np.asarray(labels, dtype=np.float64)


def _libsvm_line_chunks(path: str, chunk_lines: int = 100_000):
    with open(path, "r") as fh:
        buf: List[str] = []
        for line in fh:
            buf.append(line)
            if len(buf) >= chunk_lines:
                yield buf
                buf = []
        if buf:
            yield buf


def _split_columns(mat: np.ndarray, header: Optional[List[str]], params: Dict
                   ) -> Tuple[np.ndarray, Optional[np.ndarray], Dict,
                              Optional[List[str]]]:
    """Extract label/weight/group columns (file coordinates) from a parsed
    matrix; returns (features, label, side, feature_names)."""
    label_idx = _resolve_col(params.get("label_column", ""), header, default=0)
    weight_idx = _resolve_col(params.get("weight_column", ""), header)
    group_idx = _resolve_col(params.get("group_column", ""), header)
    ignore = set(_resolve_cols(params.get("ignore_column", ""), header))

    side: Dict = {}
    label = mat[:, label_idx] if label_idx >= 0 else None
    if weight_idx >= 0:
        side["weight"] = mat[:, weight_idx]
    if group_idx >= 0:
        side["group"] = _group_ids_to_sizes(mat[:, group_idx])
    drop = sorted({label_idx} | ({weight_idx} if weight_idx >= 0 else set())
                  | ({group_idx} if group_idx >= 0 else set()) | ignore
                  - {-1})
    drop = [d for d in drop if d >= 0]
    keep = [j for j in range(mat.shape[1]) if j not in drop]
    X = mat[:, keep]
    names = None if header is None else [header[j] for j in keep]
    return X, label, side, names


def load_data_file(path: str, params: Dict
                   ) -> Tuple[np.ndarray, Optional[np.ndarray], Dict]:
    """Returns (features, label, side_metadata).

    Label column handling follows the reference: default column 0, or
    ``label_column`` index / ``name:`` spec; ``weight_column`` /
    ``group_column`` / ``ignore_column`` extract in-file metadata columns
    (reference dataset.h:36-248 Metadata init from columns).
    """
    has_header = _has_header(params)
    head = _head_lines(path)
    fmt = _sniff_format(head[1 if has_header else 0:])

    header_names: Optional[List[str]] = None
    if has_header and fmt != "libsvm":
        sep = "\t" if fmt == "tsv" else ","
        header_names = [t.strip() for t in head[0].split(sep)]

    if fmt == "libsvm":
        with open(path, "r") as fh:
            X, label = _parse_libsvm(fh)
        side: Dict = {}
        names = None
    else:
        chunks = list(_read_chunks(path, fmt, has_header))
        mat = np.vstack(chunks) if len(chunks) != 1 else chunks[0]
        del chunks
        X, label, side, names = _split_columns(mat, header_names, params)

    side.setdefault("feature_names", names)
    for suffix, key in ((".query", "group"), (".weight", "weight"),
                        (".init", "init_score")):
        side_path = path + suffix
        if os.path.exists(side_path) and key not in side:
            side[key] = np.loadtxt(side_path, dtype=np.float64)
    return X, label, side


def stream_construct_dataset(path: str, config, feature_names=None,
                             categorical_features=None):
    """Two-round streaming construction (use_two_round_loading=true;
    reference dataset_loader.cpp:159-265):

    round 1: stream chunks, reservoir-sample rows for bin finding, count rows;
    round 2: stream again, push per-chunk bin codes into the preallocated
    binned matrix. Peak memory = one float chunk + the uint8/16 bin matrix.
    """
    from ..binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper
    from ..dataset import (ConstructedDataset, FeatureInfo, Metadata,
                           _map_find_bin, _parse_column_spec)

    params = config.to_dict() if hasattr(config, "to_dict") else dict(config)
    has_header = bool(params.get("has_header"))
    head = _head_lines(path)
    fmt = _sniff_format(head[1 if has_header else 0:])
    if fmt == "libsvm":
        return _stream_construct_libsvm(path, config, categorical_features)
    header_names: Optional[List[str]] = None
    if has_header:
        sep = "\t" if fmt == "tsv" else ","
        header_names = [t.strip() for t in head[0].split(sep)]

    sample_cnt = int(params.get("bin_construct_sample_cnt", 200000))
    rng = np.random.RandomState(int(params.get("data_random_seed", 1)))

    # ---- round 1: reservoir sample + row count (vectorized algorithm R:
    # each later row replaces a random reservoir slot w.p. sample/t) --------
    reservoir = None
    n_seen = 0
    for mat in _read_chunks(path, fmt, has_header):
        if reservoir is None:
            reservoir = mat[:sample_cnt].copy()
            rest = mat[sample_cnt:]
            n_seen = len(reservoir)
        else:
            rest = mat
        if len(rest):
            t = n_seen + np.arange(1, len(rest) + 1)
            accept = rng.random_sample(len(rest)) < (sample_cnt / t)
            picked = rest[accept]
            if len(picked):
                slots = rng.randint(0, sample_cnt, size=len(picked))
                reservoir[slots] = picked
            n_seen += len(rest)
    if reservoir is None:
        Log.fatal("Empty data file %s", path)
    total_rows = n_seen

    Xs, label_s, side_s, names = _split_columns(reservoir, header_names, params)
    num_total_features = Xs.shape[1]
    if feature_names is None:
        feature_names = names or [f"Column_{i}" for i in range(num_total_features)]

    cat_set = set()
    if categorical_features is not None:
        for c in categorical_features:
            cat_set.add(feature_names.index(c) if isinstance(c, str) else int(c))
    cat_set.update(_parse_column_spec(config.categorical_column, feature_names))

    sample_n = Xs.shape[0]
    filter_cnt = int(config.min_data_in_leaf * sample_n / max(total_rows, 1))

    def _find_one(j: int) -> BinMapper:
        mapper = BinMapper()
        bin_type = BIN_CATEGORICAL if j in cat_set else BIN_NUMERICAL
        mapper.find_bin(Xs[:, j], sample_n, config.max_bin,
                        config.min_data_in_bin, filter_cnt, bin_type,
                        config.use_missing, config.zero_as_missing)
        return mapper

    # one device: the mappers are found here (the JAX package shards this
    # across machines, ROADMAP A16)
    active = list(range(num_total_features))
    mappers_by_idx = _map_find_bin(active, _find_one)
    features: List[FeatureInfo] = [
        FeatureInfo(j, mappers_by_idx[j]) for j in active
        if not mappers_by_idx[j].is_trivial]
    if not features:
        Log.warning("There are no meaningful features in %s", path)

    dtype = np.uint8 if all(f.mapper.num_bin <= 256 for f in features) else np.uint16
    X_binned = np.zeros((total_rows, max(len(features), 1)), dtype=dtype)
    label = np.zeros(total_rows, np.float64)
    weight = np.zeros(total_rows, np.float64) if "weight" in side_s else None
    group_ids = np.zeros(total_rows, np.float64) if "group" in side_s else None

    # ---- round 2: bin per chunk -------------------------------------------
    group_col = _resolve_col(params.get("group_column", ""), header_names)
    row0 = 0
    for mat in _read_chunks(path, fmt, has_header):
        Xc, lab_c, side_c, _ = _split_columns(mat, header_names, params)
        r = slice(row0, row0 + len(Xc))
        for inner, f in enumerate(features):
            X_binned[r, inner] = f.mapper.value_to_bin(
                Xc[:, f.real_index]).astype(dtype)
        if lab_c is not None:
            label[r] = lab_c
        if weight is not None:
            weight[r] = side_c["weight"]
        if group_ids is not None:
            group_ids[r] = mat[:, group_col]
        row0 += len(Xc)

    metadata = Metadata(total_rows)
    metadata.set_label(label)
    if weight is not None:
        metadata.set_weight(weight)
    if group_ids is not None:
        metadata.set_group(_group_ids_to_sizes(group_ids))
    _apply_side_files(metadata, path)

    return ConstructedDataset(X_binned, features, num_total_features, metadata,
                              feature_names, config)


def _stream_construct_libsvm(path: str, config, categorical_features=None):
    """Two-round streaming construction for LibSVM files (the reference's
    two-round loading applies to every Parser format,
    dataset_loader.cpp:159-265; here sparse rows are reservoir-sampled as
    {feature: value} dicts, bin mappers come from the per-feature NON-ZERO
    sample values — exactly BinMapper::FindBin's contract, zeros implied by
    the sample count (bin.cpp:232) — and round two bins each line chunk
    straight into the uint8/16 matrix)."""
    from ..binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper, K_EPSILON
    from ..dataset import (ConstructedDataset, FeatureInfo, Metadata,
                           _map_find_bin, _parse_column_spec)

    sample_cnt = int(getattr(config, "bin_construct_sample_cnt", 200000))
    rng = np.random.RandomState(int(getattr(config, "data_random_seed", 1)))

    # ---- round 1: reservoir-sample sparse rows + count + max feature -----
    reservoir_rows: List[Dict[int, float]] = []
    n_seen = 0
    max_idx = -1
    for lines in _libsvm_line_chunks(path):
        _, rows, mi = _parse_libsvm_rows(lines)
        max_idx = max(max_idx, mi)
        for feats in rows:
            if len(reservoir_rows) < sample_cnt:
                reservoir_rows.append(feats)
            else:
                j = rng.randint(0, n_seen + 1)
                if j < sample_cnt:
                    reservoir_rows[j] = feats
            n_seen += 1
    if n_seen == 0:
        Log.fatal("Empty data file %s", path)
    total_rows, num_total_features = n_seen, max_idx + 1
    feature_names = [f"Column_{i}" for i in range(num_total_features)]

    cat_set = set()
    if categorical_features is not None:
        for c in categorical_features:
            cat_set.add(feature_names.index(c) if isinstance(c, str)
                        else int(c))
    cat_set.update(_parse_column_spec(config.categorical_column, feature_names))

    sample_n = len(reservoir_rows)
    filter_cnt = int(config.min_data_in_leaf * sample_n / max(total_rows, 1))
    # find_bin's contract is the NONZERO sample (zeros implied by sample_n,
    # bin.cpp:232) — an explicitly stored 'j:0' entry must be filtered like
    # sample_for_binning does, or the zero bin double-counts
    per_feature: Dict[int, List[float]] = {}
    for feats in reservoir_rows:
        for k, v in feats.items():
            if abs(v) > K_EPSILON or np.isnan(v):
                per_feature.setdefault(k, []).append(v)

    def _find_one(j: int) -> BinMapper:
        mapper = BinMapper()
        mapper.find_bin(np.asarray(per_feature.get(j, []), np.float64),
                        sample_n, config.max_bin, config.min_data_in_bin,
                        filter_cnt,
                        BIN_CATEGORICAL if j in cat_set else BIN_NUMERICAL,
                        config.use_missing, config.zero_as_missing)
        return mapper

    mappers_by_idx = _map_find_bin(list(range(num_total_features)), _find_one)
    features = [FeatureInfo(j, mappers_by_idx[j])
                for j in range(num_total_features)
                if not mappers_by_idx[j].is_trivial]
    if not features:
        Log.warning("There are no meaningful features in %s", path)

    dtype = np.uint8 if all(f.mapper.num_bin <= 256 for f in features) \
        else np.uint16
    X_binned = np.zeros((total_rows, max(len(features), 1)), dtype=dtype)
    label = np.zeros(total_rows, np.float64)

    # zero-bin per used feature (find_bin caches value_to_bin(0) as
    # default_bin, binning.py:215) — most entries are implicit zeros
    zero_bins = np.array([f.mapper.default_bin for f in features],
                         dtype=dtype)

    # ---- round 2: bin each chunk ----------------------------------------
    row0 = 0
    inner_of = {f.real_index: i for i, f in enumerate(features)}
    for lines in _libsvm_line_chunks(path):
        labs, rows, _ = _parse_libsvm_rows(lines)
        n = len(rows)
        if features:
            block = np.tile(zero_bins, (n, 1))
            # bin stored values column-wise: group (row, value) by feature
            cols: Dict[int, Tuple[List[int], List[float]]] = {}
            for i, feats in enumerate(rows):
                for k, v in feats.items():
                    inner = inner_of.get(k)
                    if inner is not None:
                        cols.setdefault(inner, ([], []))[0].append(i)
                        cols[inner][1].append(v)
            for inner, (ridx, vals) in cols.items():
                block[np.asarray(ridx), inner] = features[inner].mapper \
                    .value_to_bin(np.asarray(vals, np.float64)).astype(dtype)
            X_binned[row0:row0 + n] = block
        label[row0:row0 + n] = labs
        row0 += n

    metadata = Metadata(total_rows)
    metadata.set_label(label)
    _apply_side_files(metadata, path)

    return ConstructedDataset(X_binned, features, num_total_features,
                              metadata, feature_names, config)


def _apply_side_files(metadata, path: str) -> None:
    """Pick up <data>.query / .weight / .init side files (reference
    metadata.cpp conventions) — shared by both two-round paths."""
    qpath = path + ".query"
    if os.path.exists(qpath) and metadata.query_boundaries is None:
        metadata.set_group(np.loadtxt(qpath, dtype=np.int64))
    wpath = path + ".weight"
    if os.path.exists(wpath) and metadata.weight is None:
        metadata.set_weight(np.loadtxt(wpath, dtype=np.float64))
    ipath = path + ".init"
    if os.path.exists(ipath) and metadata.init_score is None:
        metadata.set_init_score(np.loadtxt(ipath, dtype=np.float64))
