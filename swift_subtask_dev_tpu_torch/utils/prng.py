"""Counter-based random draws in torch integer arithmetic.

The reference draws its stochastic decisions with ``jax.random``
(``subgrid/star_formation.py:25 unit_interval_traced``: a Threefry-2x32
key ``PRNGKey(purpose)`` folded in by the step's tick and the particle's
id, then ``uniform``).  The port has no JAX, so this module implements
Threefry-2x32 (20 rounds, Salmon et al. 2011, as JAX lowers it), JAX's key
derivation (``fold_in(key, d)`` = threefry(key, (0, d))), its partitionable
32-bit draw (the two output words of threefry(key, (0, 0)) xor-ed) and its
float conversion (the top 23 bits as the mantissa of a number in [1, 2),
minus 1), so every draw equals the reference's bit for bit.

torch has little unsigned 32-bit support: the words live in int64 tensors
masked to 32 bits.  ``mul32`` multiplies two such words modulo 2^32 by
16-bit halves, so no product leaves int64.
"""

from __future__ import annotations

import json
import os

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def as_u32(x) -> torch.Tensor:
    """Integers (any int dtype; negative ones as their two's complement,
    as ``astype(uint32)``) -> int64 words in [0, 2^32)."""
    return torch.as_tensor(x).to(torch.int64) & M32


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """a * b modulo 2^32 for a word tensor ``a`` and a python word ``b``."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds of the key ``(k0, k1)`` on the counter
    words ``(x0, x1)`` (broadcast word tensors).  Returns two words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def fold_in(key, data):
    """JAX's ``fold_in``: the key (two words) hashed with (0, data)."""
    k0, k1 = key
    zero = torch.zeros_like(data)
    return threefry2x32(k0, k1, zero, data)


def unit_interval(ids, ti_lo: int, ti_hi: int, purpose: int) -> torch.Tensor:
    """f32 draws in [0, 1), one per id (the reference's
    ``unit_interval_traced``): ``PRNGKey(purpose & 0x7FFFFFFF)`` folded in
    by ``ti_lo``, ``ti_hi`` and the id (as uint32), then ``uniform(())``."""
    ids = as_u32(ids)
    dev = ids.device

    def word(v):
        return torch.tensor(int(v) & M32, dtype=torch.int64, device=dev)

    key = (word(0), word(int(purpose) & 0x7FFFFFFF))
    key = fold_in(key, word(ti_lo))
    key = fold_in(key, word(ti_hi))
    k0, k1 = fold_in(key, ids)
    zero = torch.zeros_like(ids)
    b0, b1 = threefry2x32(k0, k1, zero, zero)
    bits = b0 ^ b1
    # the top 23 bits as the mantissa of [1, 2), minus 1: exact in f32
    return (bits >> 9).to(torch.float32) * (1.0 / (1 << 23))


RNG_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "rng_table.json")


def check_table(device, path: str = RNG_TABLE):
    """The committed table of reference draws (``rng_table.json``: ids,
    ticks, purposes or salts and the f32 bits of each draw) against this
    module's draws and ``ops.stencil._pair_hash_uniform`` on ``device``.
    Returns (rows, mismatching rows)."""
    from ..ops.stencil import _pair_hash_uniform
    with open(path) as f:
        table = json.load(f)
    rows = bad = 0
    for i, lo, hi, purpose, bits in table["unit_interval"]["rows"]:
        u = unit_interval(torch.tensor([i], device=device), lo, hi, purpose)
        bad += int(u.view(torch.int32).item() & M32) != bits
        rows += 1
    for a, b, lo, hi, salt, bits in table["pair_hash"]["rows"]:
        u = _pair_hash_uniform(torch.tensor([a], device=device),
                               torch.tensor([b], device=device), lo, hi,
                               salt)
        bad += int(u.view(torch.int32).item() & M32) != bits
        rows += 1
    return rows, bad
