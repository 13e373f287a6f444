"""Feature binning: value -> bin mapping built from sampled data.

Reimplements the reference's BinMapper semantics (src/io/bin.cpp:206-383,
include/LightGBM/bin.h:451-487) in NumPy:

- numerical features: zero gets its own bin (FindBinWithZeroAsOneBin,
  bin.cpp:146-204), the remaining range is split by greedy equal-count binning
  over sampled distinct values (GreedyFindBin, bin.cpp:71-144);
- missing handling: MissingType None / Zero (zero_as_missing) / NaN, with the
  NaN bin appended last (bin.cpp:271-276, bin.h:452-458);
- categorical features: bins ordered by descending category count, capped at
  max_bin and 99% mass, negative values -> NaN bin (bin.cpp:293-361);
- trivial-feature filtering via the same NeedFilter rule (bin.cpp:48-69).

This is host-side preprocessing (the reference runs it once per feature at
load time too); the produced bin edges feed the device-resident binned matrix
built in dataset.py.

The PyTorch port keeps this host-numpy copy of ``lightgbm_tpu/binning.py`` so that it
never imports the JAX package; tests/test_torch_host.py pins the two equal.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .utils.log import Log

# reference: meta.h:20-22
K_EPSILON = 1e-15
K_ZERO_RANGE = 1e-20  # kZeroAsMissingValueRange

MISSING_NONE = "none"
MISSING_ZERO = "zero"
MISSING_NAN = "nan"

BIN_NUMERICAL = "numerical"
BIN_CATEGORICAL = "categorical"


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray, max_bin: int,
                    total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Greedy equal-count bin boundaries over distinct values (bin.cpp:71-144)."""
    assert max_bin > 0
    num_distinct = len(distinct_values)
    bin_upper_bound: List[float] = []
    if num_distinct <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct - 1):
            cur_cnt_inbin += int(counts[i])
            if cur_cnt_inbin >= min_data_in_bin:
                bin_upper_bound.append((float(distinct_values[i]) + float(distinct_values[i + 1])) / 2.0)
                cur_cnt_inbin = 0
        bin_upper_bound.append(np.inf)
        return bin_upper_bound

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, int(total_cnt // min_data_in_bin)))
    mean_bin_size = total_cnt / max_bin

    # values with count >= mean size get a dedicated bin
    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest_sample_cnt = int(total_cnt - counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / rest_bin_cnt if rest_bin_cnt > 0 else np.inf

    upper_bounds: List[float] = []
    lower_bounds: List[float] = [float(distinct_values[0])]
    cur_cnt_inbin = 0
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= int(counts[i])
        cur_cnt_inbin += int(counts[i])
        if (is_big[i] or cur_cnt_inbin >= mean_bin_size
                or (is_big[i + 1] and cur_cnt_inbin >= max(1.0, mean_bin_size * 0.5))):
            upper_bounds.append(float(distinct_values[i]))
            lower_bounds.append(float(distinct_values[i + 1]))
            if len(upper_bounds) >= max_bin - 1:
                break
            cur_cnt_inbin = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / rest_bin_cnt if rest_bin_cnt > 0 else np.inf

    bin_cnt = len(upper_bounds) + 1
    out = [(upper_bounds[i] + lower_bounds[i + 1]) / 2.0 for i in range(bin_cnt - 1)]
    out.append(np.inf)
    return out


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                                  max_bin: int, total_sample_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """Zero gets a dedicated bin; negative/positive ranges binned separately
    (bin.cpp:146-204)."""
    left_mask = distinct_values <= -K_ZERO_RANGE
    right_mask = distinct_values > K_ZERO_RANGE
    zero_mask = ~left_mask & ~right_mask
    left_cnt_data = int(counts[left_mask].sum())
    cnt_zero = int(counts[zero_mask].sum())
    right_cnt_data = int(counts[right_mask].sum())

    left_cnt = int(np.argmax(distinct_values > -K_ZERO_RANGE)) if (distinct_values > -K_ZERO_RANGE).any() \
        else len(distinct_values)

    bin_upper_bound: List[float] = []
    if left_cnt > 0:
        denom = total_sample_cnt - cnt_zero
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1))) if denom > 0 else 1
        bin_upper_bound = greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                          left_max_bin, left_cnt_data, min_data_in_bin)
        bin_upper_bound[-1] = -K_ZERO_RANGE

    right_positions = np.nonzero(distinct_values > K_ZERO_RANGE)[0]
    if len(right_positions) > 0:
        right_start = int(right_positions[0])
        right_max_bin = max_bin - 1 - len(bin_upper_bound)
        assert right_max_bin > 0
        right_bounds = greedy_find_bin(distinct_values[right_start:], counts[right_start:],
                                       right_max_bin, right_cnt_data, min_data_in_bin)
        bin_upper_bound.append(K_ZERO_RANGE)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(np.inf)
    return bin_upper_bound


def _need_filter(cnt_in_bin: np.ndarray, total_cnt: int, filter_cnt: int, bin_type: str) -> bool:
    """True if no split on this feature could satisfy min_data (bin.cpp:48-69)."""
    if bin_type == BIN_NUMERICAL:
        left = np.cumsum(cnt_in_bin[:-1])
        ok = (left >= filter_cnt) & (total_cnt - left >= filter_cnt)
        return not bool(ok.any())
    if len(cnt_in_bin) <= 2:
        for i in range(len(cnt_in_bin) - 1):
            sum_left = int(cnt_in_bin[i])
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
        return True
    return False


class BinMapper:
    """Per-feature value->bin mapping (reference: include/LightGBM/bin.h:60-216)."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: str = MISSING_NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 0.0
        self.bin_type: str = BIN_NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0

    # -- construction --------------------------------------------------------

    def find_bin(self, sample_values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int, min_split_data: int, bin_type: str = BIN_NUMERICAL,
                 use_missing: bool = True, zero_as_missing: bool = False) -> None:
        """Build the mapping from a (possibly sparse-filtered) sample of values.

        ``sample_values`` are the sampled non-zero values of the feature
        (|v| > kEpsilon or NaN — the reference's sample collection filter,
        dataset_loader.cpp:763); zeros are implied:
        zero_cnt = total_sample_cnt - len(sample) - na_cnt (bin.cpp:232).
        """
        values = np.asarray(sample_values, dtype=np.float64)
        na_mask = np.isnan(values)
        na_cnt = int(na_mask.sum())
        values = values[~na_mask]
        num_sample_values = len(values)

        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE
        if not use_missing:
            na_cnt = 0

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - num_sample_values - na_cnt)

        distinct_values, counts = self._collect_distinct(values, zero_cnt)
        self.min_val = float(distinct_values[0]) if len(distinct_values) else 0.0
        self.max_val = float(distinct_values[-1]) if len(distinct_values) else 0.0
        num_distinct = len(distinct_values)

        if bin_type == BIN_NUMERICAL:
            if self.missing_type in (MISSING_ZERO, MISSING_NONE):
                bounds = find_bin_with_zero_as_one_bin(distinct_values, counts, max_bin,
                                                       total_sample_cnt, min_data_in_bin)
                if self.missing_type == MISSING_ZERO and len(bounds) == 2:
                    self.missing_type = MISSING_NONE
            else:
                bounds = find_bin_with_zero_as_one_bin(distinct_values, counts, max_bin - 1,
                                                       total_sample_cnt - na_cnt, min_data_in_bin)
                bounds.append(np.nan)  # NaN bin last (bin.cpp:275)
            self.bin_upper_bound = np.array(bounds, dtype=np.float64)
            self.num_bin = len(bounds)
            cnt_in_bin = self._count_in_bins(distinct_values, counts, na_cnt)
            assert self.num_bin <= max_bin
        else:
            cnt_in_bin = self._find_bin_categorical(distinct_values, counts, max_bin,
                                                    total_sample_cnt, min_data_in_bin, na_cnt)

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and _need_filter(cnt_in_bin, total_sample_cnt,
                                                min_split_data, self.bin_type):
            self.is_trivial = True
        if not self.is_trivial:
            # the ONE sanctioned zero-bin computation: every consumer
            # (dataset binning loops, bin_raw, EFB, ingest tables) reads
            # .default_bin instead of re-running value_to_bin(0) per
            # column; agreement is asserted here, once, at construction
            self.default_bin = int(self.value_to_bin(np.array([0.0]))[0])
            assert self.default_bin == int(self.value_to_bin(np.zeros(1))[0])
            if self.bin_type == BIN_CATEGORICAL:
                assert self.default_bin > 0
        denom = max(total_sample_cnt, 1)
        self.sparse_rate = float(cnt_in_bin[self.default_bin]) / denom if len(cnt_in_bin) else 0.0

    @staticmethod
    def _collect_distinct(values: np.ndarray, zero_cnt: int) -> Tuple[np.ndarray, np.ndarray]:
        """Distinct values + counts with the implicit zeros spliced into
        sorted position (bin.cpp:236-260). Vectorized: the sample filter
        guarantees |v| > kEpsilon, so 0.0 is never already present and the
        splice is a single sorted insert."""
        if len(values) == 0:
            return np.array([0.0]), np.array([zero_cnt], dtype=np.int64)
        uniq, cnts = np.unique(values, return_counts=True)
        cnts = cnts.astype(np.int64)
        pos = int(np.searchsorted(uniq, 0.0))
        if pos < len(uniq) and uniq[pos] == 0.0:
            cnts[pos] += zero_cnt            # defensive: explicit stored zero
        elif zero_cnt > 0 or 0 < pos < len(uniq):
            # the edge splices (all-positive / all-negative samples,
            # bin.cpp:233,257) only fire when zeros exist, but the interior
            # negative->positive splice (bin.cpp:245-248) is UNGUARDED: a
            # fully-dense sign-crossing column still gets a (0.0, 0) entry
            uniq = np.insert(uniq, pos, 0.0)
            cnts = np.insert(cnts, pos, zero_cnt)
        return uniq, cnts

    def _count_in_bins(self, distinct_values: np.ndarray, counts: np.ndarray,
                       na_cnt: int) -> np.ndarray:
        # first bin whose upper bound >= value (the sequential while-advance,
        # vectorized; a trailing NaN bound compares as +inf in numpy's sort
        # order so no value lands in the NaN bin here)
        idx = np.searchsorted(self.bin_upper_bound, distinct_values,
                              side="left")
        cnt_in_bin = np.bincount(idx, weights=counts,
                                 minlength=self.num_bin).astype(np.int64)
        if self.missing_type == MISSING_NAN:
            cnt_in_bin[self.num_bin - 1] = na_cnt
        return cnt_in_bin

    def _find_bin_categorical(self, distinct_values: np.ndarray, counts: np.ndarray,
                              max_bin: int, total_sample_cnt: int, min_data_in_bin: int,
                              na_cnt: int) -> np.ndarray:
        """Categorical binning by descending count (bin.cpp:293-361)."""
        vals_int: List[int] = []
        cnts_int: List[int] = []
        for v, c in zip(distinct_values, counts):
            iv = int(v)
            if iv < 0:
                na_cnt += int(c)
                Log.warning("Met negative value in categorical features, will convert it to NaN")
            elif vals_int and iv == vals_int[-1]:
                cnts_int[-1] += int(c)
            else:
                vals_int.append(iv)
                cnts_int.append(int(c))
        counts_arr = np.array(cnts_int, dtype=np.int64)
        vals_arr = np.array(vals_int, dtype=np.int64)
        order = np.argsort(-counts_arr, kind="stable")
        counts_arr = counts_arr[order]
        vals_arr = vals_arr[order]
        counts_list = counts_arr.tolist()
        vals_list = vals_arr.tolist()
        # avoid first bin being category 0: bin 0 must stay non-default (bin.cpp:313-321)
        if vals_list and vals_list[0] == 0:
            if len(vals_list) == 1:
                vals_list.append(vals_list[0] + 1)
                counts_list.append(0)
            vals_list[0], vals_list[1] = vals_list[1], vals_list[0]
            counts_list[0], counts_list[1] = counts_list[1], counts_list[0]

        cut_cnt = int((total_sample_cnt - na_cnt) * 0.99)
        self.categorical_2_bin = {}
        self.bin_2_categorical = []
        self.num_bin = 0
        used_cnt = 0
        max_bin = min(len(vals_list), max_bin)
        cnt_in_bin: List[int] = []
        cur_cat = 0
        while cur_cat < len(vals_list) and (used_cnt < cut_cnt or self.num_bin < max_bin):
            if counts_list[cur_cat] < min_data_in_bin and cur_cat > 1:
                break
            self.bin_2_categorical.append(vals_list[cur_cat])
            self.categorical_2_bin[vals_list[cur_cat]] = self.num_bin
            used_cnt += counts_list[cur_cat]
            cnt_in_bin.append(counts_list[cur_cat])
            self.num_bin += 1
            cur_cat += 1
        if cur_cat == len(vals_list) and na_cnt > 0:
            self.bin_2_categorical.append(-1)
            self.categorical_2_bin[-1] = self.num_bin
            cnt_in_bin.append(0)
            self.num_bin += 1
        if cur_cat == len(vals_list) and na_cnt == 0:
            self.missing_type = MISSING_NONE
        elif na_cnt == 0:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NAN
        if cnt_in_bin:
            cnt_in_bin[-1] += int(total_sample_cnt - used_cnt)
        return np.array(cnt_in_bin, dtype=np.int64)

    # -- application ---------------------------------------------------------

    def value_to_bin(self, values: np.ndarray,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized ValueToBin (bin.h:451-487).

        ``out`` writes the codes straight into a preexisting array (any
        integer dtype, unsafe cast) — the dataset binning loop fills
        ``X_binned`` columns in a single pass with no int32 intermediate
        plus ``astype`` plus assignment-copy chain. This host path is the
        ORACLE the device ingest kernel (ops/ingest.py) is tested against
        bit-for-bit."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_NUMERICAL:
            nan_mask = np.isnan(values)
            has_nan = bool(nan_mask.any())
            search_vals = np.where(nan_mask, 0.0, values) if has_nan else values
            ub = self.bin_upper_bound
            r = self.num_bin - 1
            if self.missing_type == MISSING_NAN:
                r -= 1  # NaN bin excluded from the search range (bin.h:463-465)
            bins = np.searchsorted(ub[: r + 1], search_vals, side="left")
            np.minimum(bins, r, out=bins)
            if has_nan and self.missing_type == MISSING_NAN:
                np.copyto(bins, self.num_bin - 1, where=nan_mask)
        else:
            # categorical: negative / unseen -> last bin (bin.h:476-486)
            bins = np.full(values.shape, self.num_bin - 1, dtype=np.int32)
            int_vals = np.where(np.isnan(values), -1, values).astype(np.int64)
            for cat, b in self.categorical_2_bin.items():
                bins[int_vals == cat] = b
            bins[int_vals < 0] = self.num_bin - 1
        if out is not None:
            np.copyto(out, bins, casting="unsafe")
            return out
        return bins.astype(np.int32, copy=False)

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative value for a bin (used in model export thresholds)."""
        if self.bin_type == BIN_CATEGORICAL:
            return float(self.bin_2_categorical[bin_idx])
        return float(self.bin_upper_bound[bin_idx])

    @property
    def has_nan_bin(self) -> bool:
        return self.bin_type == BIN_NUMERICAL and self.missing_type == MISSING_NAN

    def __repr__(self):
        return (f"BinMapper(num_bin={self.num_bin}, type={self.bin_type}, "
                f"missing={self.missing_type}, trivial={self.is_trivial})")


def sample_for_binning(data: np.ndarray, sample_cnt: int, seed: int) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Row-sample the raw matrix and collect per-feature nonzero/NaN values
    (reference: dataset_loader.cpp:688-746 + :763 filter)."""
    num_data = data.shape[0]
    sparse = hasattr(data, "tocsc")
    if num_data > sample_cnt:
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(num_data, size=sample_cnt, replace=False))
        sample = data.tocsr()[idx].tocsc() if sparse else data[idx]
    else:
        idx = np.arange(num_data)
        sample = data.tocsc() if sparse else data
    per_feature = []
    for j in range(sample.shape[1]):
        if sparse:
            # stored entries only — implicit zeros are exactly what the
            # nonzero/NaN filter below drops for dense input (indptr slicing
            # works for csc_matrix and csc_array alike)
            lo, hi = sample.indptr[j], sample.indptr[j + 1]
            col = np.asarray(sample.data[lo:hi], dtype=np.float64)
        else:
            col = np.asarray(sample[:, j], dtype=np.float64)
        keep = (np.abs(col) > K_EPSILON) | np.isnan(col)
        per_feature.append(col[keep])
    return idx, per_feature
