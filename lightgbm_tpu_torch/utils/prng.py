"""Threefry-2x32 counter-based random numbers, bit-compatible with
``jax.random`` (default ``threefry2x32`` implementation, partitionable
draws, 32-bit mode).

The JAX package draws its bagging mask, GOSS sample and feature_fraction
mask with ``jax.random``; this module reproduces those bits so that a
sampled booster of this package grows the JAX package's trees:

- a key is a pair of uint32 words ``(k1, k2)``, held as Python ints on the
  host: ``prng_key(seed)`` is ``(0, seed mod 2**32)``, as ``PRNGKey``
  gives it with 64-bit types off;
- ``fold_in(key, d)`` hashes the counter pair ``(0, d)``;
- ``split(key, n)`` hashes the pairs ``(0, i)`` for ``i < n``;
- ``random_bits(key, shape)`` hashes the 64-bit flat index of every element
  as ``(index >> 32, index & 0xFFFFFFFF)`` and XORs the two output words, so
  a draw is prefix-stable: the first ``n`` values of a longer draw are the
  draw of ``n``;
- ``uniform(key, shape)`` puts the top 23 bits of each word under the
  exponent of 1.0 and subtracts 1.0 (JAX's ``_uniform`` for f32).

Keys are derived on the host, so a key costs no device work; a draw is
plain PyTorch on the device it is asked for, with uint32 words held in
``int64`` and masked after every add. This is XLA-level device work in the
JAX package, not a Pallas kernel, so it stays plain torch ops.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
# rotation schedule and key-schedule parity of Threefry-2x32 (20 rounds)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: Key, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash of the counter words ``(x1, x2)`` under
    ``key``: Python ints or ``int64`` tensors holding uint32 values."""
    k1, k2 = int(key[0]) & MASK32, int(key[1]) & MASK32
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x1, x2


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` (a 32-bit seed: the high word is 0)."""
    return (0, int(seed) & MASK32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, int(data) & MASK32)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)`` as a tuple of ``num`` keys."""
    return tuple(threefry2x32(key, 0, i) for i in range(num))


def random_bits(key: Key, shape: Union[int, Sequence[int]],
                device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as an ``int64`` tensor."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key, idx >> 32, idx & MASK32)
    return (b1 ^ b2).reshape(shape)


def uniform(key: Key, shape: Union[int, Sequence[int]],
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: f32 in [0, 1)."""
    bits = random_bits(key, shape, device)
    one_bits = (bits >> 9) | 0x3F800000          # below 2**31: fits int32
    return one_bits.to(torch.int32).view(torch.float32) - 1.0


def top_k_indices(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of a 1-D tensor in ``lax.top_k``'s
    order: descending, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    return torch.sort(values, descending=True, stable=True).indices[:k]
