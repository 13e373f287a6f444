"""Carry state between ``lightgbm_tpu`` (JAX) and this package, as numpy.

The two packages share no imports: everything crosses as numpy arrays or
model text, so the tests can feed both the same inputs (made with numpy
from a seed) and compare their outputs field by field. The helpers are
duck-typed over either package's objects:

- :func:`binned_dataset` — a constructed dataset's bin codes, per-feature
  bin metadata and bin upper bounds;
- :func:`port_mappers` — the other package's ``BinMapper`` objects as this
  package's (same fields);
- :func:`to_numpy` / :func:`to_torch` — arrays of either framework (the
  gradients, histograms, leaf ids);
- :func:`tree_arrays_numpy` / :func:`tree_arrays_torch` — the grower's
  ``TreeArrays`` of either package, field by field;
- :func:`booster_from_model` — a finished model of either package, loaded
  here through its model text;
- :func:`prng_key_from_jax` — a ``jax.random`` key as this package's key.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .basic import Booster
from .binning import BinMapper
from .grower import TreeArrays


def to_numpy(x) -> np.ndarray:
    """A torch tensor (any device) or a JAX / numpy array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_torch(x, device="cpu") -> torch.Tensor:
    """An array of either framework as a torch tensor on ``device`` (a copy:
    JAX hands out read-only numpy views)."""
    return torch.as_tensor(np.array(to_numpy(x), order="C"), device=device)


def binned_dataset(constructed) -> Dict[str, object]:
    """Codes and bin metadata of either package's ConstructedDataset."""
    meta = constructed.feature_meta_arrays()
    return {
        "X_binned": np.asarray(constructed.X_binned),
        "num_bins": np.asarray(meta["num_bins"], np.int32),
        "missing_code": np.asarray(meta["missing_code"], np.int32),
        "default_bin": np.asarray(meta["default_bin"], np.int32),
        "bin_upper_bound": [np.asarray(m.bin_upper_bound, np.float64)
                            for m in constructed.mappers],
        "real_feature_idx": np.asarray(constructed.real_feature_idx),
    }


def port_mappers(mappers) -> List[BinMapper]:
    """The other package's BinMappers as this package's (field copy)."""
    out = []
    for m in mappers:
        pm = BinMapper.__new__(BinMapper)
        pm.__dict__.update({k: (v.copy() if isinstance(v, np.ndarray) else v)
                            for k, v in vars(m).items()})
        out.append(pm)
    return out


def tree_arrays_numpy(tree) -> Dict[str, np.ndarray]:
    """Either package's grower ``TreeArrays`` as a dict of numpy arrays
    (the fields both share that are set: the linear-leaf fields are None
    on a constant-leaf tree and left out)."""
    return {name: to_numpy(getattr(tree, name))
            for name in TreeArrays._fields
            if getattr(tree, name, None) is not None}


def tree_arrays_torch(arrays: Dict[str, np.ndarray], device="cpu"
                      ) -> TreeArrays:
    """Numpy tree arrays as this package's ``TreeArrays`` (a field missing
    from ``arrays`` is None)."""
    return TreeArrays(*[None if arrays.get(name) is None
                        else to_torch(arrays[name], device)
                        for name in TreeArrays._fields])


def booster_from_model(booster_or_text,
                       params: Optional[dict] = None) -> Booster:
    """This package's Booster for a model of either package (or its text)."""
    text = booster_or_text if isinstance(booster_or_text, str) \
        else booster_or_text.model_to_string()
    return Booster(params=params, model_str=text)


def prng_key_from_jax(key_data: np.ndarray):
    """A JAX raw key (its two uint32 words, ``np.asarray(PRNGKey(s))``) as
    this package's key (``utils/prng.py``)."""
    k = np.asarray(key_data, dtype=np.uint32).reshape(-1)
    if k.shape != (2,):
        raise ValueError(f"a threefry key has two uint32 words, got {k!r}")
    return (int(k[0]), int(k[1]))
