"""2-bit HiLo bit planes: the packed base layout of the SHD screen.

The reference stores sequences as 2-bit HiLo planes, which turns a Hamming
distance into a popcount of plane XORs (reference:
include/sequencehelpers.hpp:408-530, src/gpu/hammingdistancekernels.cu).
Here each plane is an int32 word array: bit j of word w is the hi (or lo)
bit of base 32*w + j.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def pack_bitplanes(bases: jnp.ndarray, lengths: jnp.ndarray, nwords: int
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """[N, L] int8 bases -> (hi, lo, mask) [N, nwords] int32 planes.

    Bit j of word w covers position w*32 + j.  mask has 1-bits exactly at
    positions < length (so XOR garbage past the end never counts).
    """
    n, maxlen = bases.shape
    width = nwords * 32
    b = bases.astype(jnp.int32)
    if width > maxlen:
        b = jnp.pad(b, ((0, 0), (0, width - maxlen)))
    else:
        b = b[:, :width]
    pos = jnp.arange(width, dtype=jnp.int32)[None, :]
    in_len = pos < lengths[:, None]
    hi_bits = jnp.where(in_len, (b >> 1) & 1, 0)
    lo_bits = jnp.where(in_len, b & 1, 0)
    shifts = jnp.arange(32, dtype=jnp.int32)[None, None, :]

    def to_words(bits):
        return jnp.sum(bits.reshape(n, nwords, 32) << shifts, axis=-1,
                       dtype=jnp.int32)

    return to_words(hi_bits), to_words(lo_bits), to_words(
        in_len.astype(jnp.int32))


def pack_genome_planes(concat: jnp.ndarray, chunk: int = 1 << 24):
    """[G] int8 genome -> (hi, lo) plane words [ceil(G/32)] int32.

    Packed once at build; the SHD anchor fetch then gathers aligned WORDS
    (32x fewer elements than a base-wise gather) and the sub-word offset
    folds into the shift range.  This is also the genome's 2-bit storage
    form (4x smaller than int8).
    """
    g = concat.shape[0]
    gw = (g + 31) // 32
    width = gw * 32
    padded = jnp.pad(concat, (0, width - g)).astype(jnp.int32)
    his = []
    los = []
    for s0 in range(0, width, chunk):
        part = jax.lax.dynamic_slice_in_dim(
            padded, s0, min(chunk, width - s0), 0)
        b = part.reshape(-1, 32)
        shifts = jnp.arange(32, dtype=jnp.int32)[None, :]
        his.append(jnp.sum(((b >> 1) & 1) << shifts, axis=1, dtype=jnp.int32))
        los.append(jnp.sum((b & 1) << shifts, axis=1, dtype=jnp.int32))
    return jnp.concatenate(his), jnp.concatenate(los)


def collapse_planes_ct(hi, lo):
    """C(01)->T(11) on bit planes: hi' = hi | lo."""
    return hi | lo, lo


def collapse_planes_ga(hi, lo):
    """G(10)->A(00) on bit planes: hi' = hi & lo."""
    return hi & lo, lo
