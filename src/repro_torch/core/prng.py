"""JAX's threefry2x32 key discipline as plain functions, so the port draws
the reference's random bits exactly (``jax.random`` with
``jax_threefry_partitionable``, the default since JAX 0.5).

* ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)``: the key ``(0, seed mod
  2^32)`` (with 64-bit mode off, JAX keeps the low 32 bits of the seed);
* ``fold_in(key, data)`` is ``threefry2x32(key, (0, data mod 2^32))``;
* ``random_bits(key, shape)``: element i of the flat shape takes
  ``threefry2x32(key, (i >> 32, i mod 2^32))`` and keeps ``out0 ^ out1``;
* ``uniform`` puts the top 23 bits of each word under the exponent of 1.0
  (``(bits >> 9) | 0x3F800000`` as float32, minus 1): a float32 in [0, 1);
* ``bernoulli(key, p, shape)`` is ``uniform < p`` with p a float32.

Keys are pairs of Python ints, derived on the host. :func:`threefry2x32`
takes Python ints or int64 tensors (words in [0, 2^32)): torch 2.13 on the
CPU has no ``>>`` / ``<<`` for ``uint32``, so the arithmetic is int64 with
each result masked to 32 bits. ``random_bits(..., offset)`` starts the
element counter at `offset`, so a window of a long row draws what the whole
row would draw there. The CUDA kernel ``csrc/byzantine.cu`` runs the same
rounds on the card.

The counter map (:func:`mapped_counters`, :func:`counter_map`): a model
rank's block of a row-major leaf, cut along one dim into equal parts, draws
at the whole leaf's counters. Local element l of the block takes counter
``offset + l + (l // block) * gap``: runs of ``block`` elements, each
followed in the whole leaf by the other ranks' ``gap``. ``block = 0`` is no
cut.

JAX's normals are not here: ``jax.random.normal`` is ``sqrt(2) *
erfinv(u)`` with XLA's float32 ``erfinv``, which ``torch.erfinv`` does not
reproduce bit for bit (see ``sim/runner.py``).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
#: threefry's key-schedule parity constant
PARITY = 0x1BD11BDA
#: the rotation distances of the two alternating groups of four rounds
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: Key, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The 20-round threefry2x32 block cipher of the counter ``(x0, x1)``
    under `key`, as ``jax._src.prng.threefry2x32`` computes it."""
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` (any Python int; seeds past 2^31 keep
    their low 32 bits, as JAX's do with 64-bit mode off)."""
    return (0, int(seed) & MASK32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    out = threefry2x32(key, 0, int(data) & MASK32)
    return (int(out[0]), int(out[1]))


def counter_map(shape: Sequence[int], dim: int, parts: int, index: int,
                offset: int = 0) -> Tuple[int, int, int]:
    """``(offset, block, gap)`` of the counter map for model rank `index`'s
    block of local `shape` (the leaf cut along `dim` into `parts`), the
    whole leaf starting at counter `offset`: the block's runs of
    ``prod(shape[dim:])`` elements start ``index`` runs into the leaf's, and
    ``parts - 1`` runs of the other ranks follow each. A cut on the leading
    dims (nothing before `dim`) leaves one contiguous window: block 0."""
    run = 1
    for d in shape[dim:]:
        run *= int(d)
    base = offset + index * run
    if all(int(d) == 1 for d in shape[:dim]) or parts == 1:
        return base, 0, 0
    return base, run, (parts - 1) * run


def mapped_counters(n: int, offset: int = 0, start: int = 0, block: int = 0,
                    gap: int = 0, device=None) -> torch.Tensor:
    """The int64 counters of local elements ``start .. start + n - 1``
    under the map ``offset + l + (l // block) * gap`` (``offset + l`` for
    block 0)."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    if block:
        idx = idx + torch.div(idx, block, rounding_mode="floor") * gap
    return idx + offset


def random_bits(key: Key, shape: Sequence[int], offset: int = 0,
                device=None, *, start: int = 0, block: int = 0,
                gap: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` as int64 words in [0, 2^32): element
    i (row-major) is ``out0 ^ out1`` of the counter ``offset + i``, or,
    with a counter map, of :func:`mapped_counters`' counter of local
    element ``start + i``."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = mapped_counters(n, offset, start, block, gap, device)
    out0, out1 = threefry2x32(key, idx >> 32, idx & MASK32)
    return (out0 ^ out1).view(tuple(shape))


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) -> float32 uniforms in [0, 1), as JAX maps
    them: 23 mantissa bits under 1.0's exponent, minus 1."""
    word = (bits >> 9) | 0x3F800000
    return word.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: Key, shape: Sequence[int], offset: int = 0,
            device=None, **cut) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)); `cut` is
    :func:`random_bits`' counter map."""
    return bits_to_uniform(random_bits(key, shape, offset, device, **cut))


def as_float32(p: float) -> float:
    """`p` rounded to float32, as JAX rounds a weakly typed Python float
    compared with a float32 array."""
    return float(torch.tensor(p, dtype=torch.float32))


def bernoulli(key: Key, p: float, shape: Sequence[int], offset: int = 0,
              device=None, **cut) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: bool, ``uniform < p`` with
    p rounded to float32; `cut` is :func:`random_bits`' counter map."""
    return uniform(key, shape, offset, device, **cut) < as_float32(p)


__all__ = ["Key", "MASK32", "as_float32", "bernoulli", "bits_to_uniform",
           "counter_map", "fold_in", "mapped_counters", "prng_key",
           "random_bits", "threefry2x32", "uniform"]
