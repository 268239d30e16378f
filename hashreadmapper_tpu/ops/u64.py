"""64-bit unsigned integer arithmetic as pairs of uint32 JAX arrays.

Enabling jax_enable_x64 globally changes default dtypes everywhere, so a u64
tensor is represented explicitly as an (hi, lo) pair of uint32 tensors, with
exactly the operations the MurmurHash3 finalizer needs (reference:
include/hpc_helpers/include/hashers.cuh:128-137).  Whether native 64-bit
integers under scoped x64 are faster on the GPU is open (ROADMAP D7).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

U64 = Tuple[jnp.ndarray, jnp.ndarray]  # (hi, lo), both uint32


def make(hi: int, lo: int) -> Tuple[int, int]:
    return hi, lo


def from_py(x: int) -> Tuple[int, int]:
    """Split a Python int (< 2**64) into (hi, lo) uint32 constants."""
    x &= (1 << 64) - 1
    return (x >> 32) & 0xFFFFFFFF, x & 0xFFFFFFFF


def to_py(hi, lo) -> int:
    return (int(hi) << 32) | int(lo)


def xor(a: U64, b: U64) -> U64:
    return a[0] ^ b[0], a[1] ^ b[1]


def shr(a: U64, n: int) -> U64:
    """Logical right shift by a static amount 0 <= n < 64."""
    hi, lo = a
    if n == 0:
        return hi, lo
    if n < 32:
        new_lo = (lo >> n) | (hi << (32 - n))
        new_hi = hi >> n
        return new_hi, new_lo
    if n == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> (n - 32)


def shl(a: U64, n: int) -> U64:
    """Logical left shift by a static amount 0 <= n < 64."""
    hi, lo = a
    if n == 0:
        return hi, lo
    if n < 32:
        new_hi = (hi << n) | (lo >> (32 - n))
        new_lo = lo << n
        return new_hi, new_lo
    if n == 32:
        return lo, jnp.zeros_like(lo)
    return lo << (n - 32), jnp.zeros_like(lo)


def _umul32_wide(a: jnp.ndarray, b: jnp.ndarray) -> U64:
    """Full 32x32 -> 64 bit product using 16-bit limbs on uint32 lanes."""
    a = a.astype(jnp.uint32)
    b = b.astype(jnp.uint32)
    al = a & jnp.uint32(0xFFFF)
    ah = a >> 16
    bl = b & jnp.uint32(0xFFFF)
    bh = b >> 16

    ll = al * bl                       # < 2**32, exact
    lh = al * bh                       # < 2**32, exact
    hl = ah * bl                       # < 2**32, exact
    hh = ah * bh                       # < 2**32, exact

    # mid = lh + hl, may wrap: each wrap adds 2**32 which is 2**16 in hi units.
    mid = lh + hl
    mid_carry = (mid < lh).astype(jnp.uint32) << 16

    lo = ll + (mid << 16)
    lo_carry = (lo < ll).astype(jnp.uint32)

    hi = hh + (mid >> 16) + mid_carry + lo_carry
    return hi, lo


def mul(a: U64, b: U64) -> U64:
    """(a * b) mod 2**64."""
    ahi, alo = a
    bhi, blo = b
    hi, lo = _umul32_wide(alo, blo)
    hi = hi + alo * bhi + ahi * blo  # cross terms only affect the hi word
    return hi, lo


def mul_const(a: U64, c: int) -> U64:
    chi, clo = from_py(c)
    ahi, alo = a
    chi = jnp.uint32(chi)
    clo = jnp.uint32(clo)
    hi, lo = _umul32_wide(alo, clo)
    hi = hi + alo * chi + ahi * clo
    return hi, lo


def add_u32(a: U64, b: jnp.ndarray) -> U64:
    """a + b where b is a uint32 tensor (zero-extended to 64 bits)."""
    hi, lo = a
    new_lo = lo + b
    carry = (new_lo < lo).astype(jnp.uint32)
    return hi + carry, new_lo


def less(a: U64, b: U64) -> jnp.ndarray:
    """a < b (unsigned)."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def minimum(a: U64, b: U64) -> U64:
    take_a = less(a, b)
    return jnp.where(take_a, a[0], b[0]), jnp.where(take_a, a[1], b[1])


# MurmurHash3 64-bit finalizer constants
# (reference: include/hpc_helpers/include/hashers.cuh:128-137).
_C1 = 0xFF51AFD7ED558CCD
_C2 = 0xC4CEB9FE1A85EC53


def murmur64(x: U64) -> U64:
    """MurmurHash3 fmix64, bit-exact with the reference's MurmurHash<u64>."""
    x = xor(x, shr(x, 33))
    x = mul_const(x, _C1)
    x = xor(x, shr(x, 33))
    x = mul_const(x, _C2)
    x = xor(x, shr(x, 33))
    return x


def murmur64_py(x: int) -> int:
    """Pure-python oracle of murmur64 for tests."""
    mask = (1 << 64) - 1
    x &= mask
    x ^= x >> 33
    x = (x * _C1) & mask
    x ^= x >> 33
    x = (x * _C2) & mask
    x ^= x >> 33
    return x
