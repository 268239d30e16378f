"""Canonical k-mer extraction and minhash signatures (device / JAX).

Bit-exact re-derivation of the reference's GPU hashing pipeline
(reference: include/gpu/gpusequencehasher.cuh:114-169 minhashSignatures3264Kernel,
include/sequencehelpers.hpp:847-935 forEachEncodedCanonicalKmerFromEncodedSequence):

  for each sequence s and hash-function id f:
      sig[s, f] = ( min over all k-mer positions p of
                    murmur64(canonical_kmer(s, p) + f) ) & kmer_mask
  canonical_kmer = min(kmer, revcomp_kmer) over the 2k-bit encodings,
  kmer_mask = 2**(2k) - 1.

Instead of a rolling per-thread scan, all k-mers of a padded batch are
materialized vectorized over (sequence, position) — k static shifted adds on
the VPU — and the 64-bit min is taken as two 32-bit lexicographic reductions.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from . import u64

# Signatures of sequences shorter than k are invalid; the reference writes
# numeric_limits<HashValueType>::max() and valid=false
# (gpusequencehasher.cuh:162-166). We use the same sentinel.
SIG_SENTINEL = 0xFFFFFFFF


def kmer_mask_py(k: int) -> int:
    return (1 << (2 * k)) - 1


def canonical_kmers(bases: jnp.ndarray, lengths: jnp.ndarray, k: int
                    ) -> Tuple[u64.U64, jnp.ndarray]:
    """All canonical k-mers of padded base rows.

    Args:
      bases: [N, L] int8 in 0..3 (padding values are ignored via the mask).
      lengths: [N] int32.
      k: static k-mer length, 1..32.

    Returns:
      ((hi, lo) uint32 [N, P], valid bool [N, P]) with P = L - k + 1.
    """
    n, maxlen = bases.shape
    assert 1 <= k <= 32
    npos = maxlen - k + 1
    assert npos >= 1, "padded length shorter than k"
    b = bases.astype(jnp.uint32)

    fwd_hi = jnp.zeros((n, npos), dtype=jnp.uint32)
    fwd_lo = jnp.zeros((n, npos), dtype=jnp.uint32)
    rc_hi = jnp.zeros((n, npos), dtype=jnp.uint32)
    rc_lo = jnp.zeros((n, npos), dtype=jnp.uint32)

    for i in range(k):
        col = b[:, i:i + npos]
        # forward: base i of the k-mer sits at bit offset 2*(k-1-i)
        fshift = 2 * (k - 1 - i)
        if fshift >= 32:
            fwd_hi = fwd_hi | (col << (fshift - 32))
        else:
            fwd_lo = fwd_lo | (col << fshift)
            if fshift > 0:
                # a 2-bit base never straddles the 32-bit boundary since
                # fshift is even and < 32 here => col << fshift fits in lo
                pass
        # reverse complement: complement base at bit offset 2*i
        rcol = jnp.uint32(3) - col
        rshift = 2 * i
        if rshift >= 32:
            rc_hi = rc_hi | (rcol << (rshift - 32))
        else:
            rc_lo = rc_lo | (rcol << rshift)

    canon = u64.minimum((fwd_hi, fwd_lo), (rc_hi, rc_lo))
    pos = jnp.arange(npos, dtype=jnp.int32)[None, :]
    valid = pos <= (lengths[:, None] - k)
    return canon, valid


def _min_u64_masked(hi: jnp.ndarray, lo: jnp.ndarray, valid: jnp.ndarray,
                    axis: int) -> u64.U64:
    """Lexicographic (hi, lo) min over `axis`, ignoring invalid lanes."""
    big = jnp.uint32(0xFFFFFFFF)
    hi_m = jnp.where(valid, hi, big)
    min_hi = jnp.min(hi_m, axis=axis, keepdims=True)
    lo_m = jnp.where(valid & (hi_m == min_hi), lo, big)
    min_lo = jnp.min(lo_m, axis=axis)
    return jnp.squeeze(min_hi, axis=axis), min_lo


def forward_kmers(bases: jnp.ndarray, lengths: jnp.ndarray, k: int
                  ) -> Tuple[u64.U64, jnp.ndarray]:
    """All forward (non-canonical) k-mers of padded base rows.

    Used by the 3N seeding mode, where the C->T / G->A collapses break
    reverse-complement symmetry and canonicalization would mix spaces.
    """
    n, maxlen = bases.shape
    assert 1 <= k <= 32
    npos = maxlen - k + 1
    b = bases.astype(jnp.uint32)
    hi = jnp.zeros((n, npos), dtype=jnp.uint32)
    lo = jnp.zeros((n, npos), dtype=jnp.uint32)
    for i in range(k):
        col = b[:, i:i + npos]
        fshift = 2 * (k - 1 - i)
        if fshift >= 32:
            hi = hi | (col << (fshift - 32))
        else:
            lo = lo | (col << fshift)
    pos = jnp.arange(npos, dtype=jnp.int32)[None, :]
    valid = pos <= (lengths[:, None] - k)
    return (hi, lo), valid


@partial(jax.jit, static_argnames=("k", "canonical"))
def minhash_signatures(bases: jnp.ndarray, lengths: jnp.ndarray, k: int,
                       hash_ids: jnp.ndarray, canonical: bool = True
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Minhash signatures, bit-exact with minhashSignatures3264Kernel.

    Args:
      bases: [N, L] int8 bases.
      lengths: [N] int32 sequence lengths.
      k: static k, 1..16 (signature then fits in uint32 after masking).
      hash_ids: [F] uint32 hash-function ids (< 64).
      canonical: min(kmer, revcomp) as the reference does; False = forward
        k-mers only (3N seeding mode).

    Returns:
      (sig [N, F] uint32, valid [N] bool).  Invalid rows carry SIG_SENTINEL.
    """
    assert 1 <= k <= 16, "device signatures restricted to k<=16 (uint32)"
    if canonical:
        (chi, clo), kvalid = canonical_kmers(bases, lengths, k)
    else:
        (chi, clo), kvalid = forward_kmers(bases, lengths, k)

    # hash input = canonical kmer + hash id (u64 add with carry)
    f = hash_ids.astype(jnp.uint32)[None, :, None]          # [1, F, 1]
    lo_f = clo[:, None, :] + f                              # [N, F, P]
    carry = (lo_f < clo[:, None, :]).astype(jnp.uint32)
    hi_f = chi[:, None, :] + carry

    hhi, hlo = u64.murmur64((hi_f, lo_f))
    _, min_lo = _min_u64_masked(hhi, hlo, kvalid[:, None, :], axis=2)

    mask = kmer_mask_py(k)
    if k == 16:
        sig = min_lo
    else:
        sig = min_lo & jnp.uint32(mask)
    seq_valid = lengths >= k
    sig = jnp.where(seq_valid[:, None], sig, jnp.uint32(SIG_SENTINEL))
    return sig, seq_valid


@partial(jax.jit, static_argnames=("k", "mirror"))
def signatures_3n_pair(bases: jnp.ndarray, lengths: jnp.ndarray, k: int,
                       hash_ids: jnp.ndarray, mirror: bool = False
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Both 3N signature spaces of a read batch.

    mirror=False (directional): returns ([N, 2F] = [sig_CT(x) |
    sig_GA(RC(x))], valid) — the engine's read-side probe layout.
    mirror=True (undirectional PBAT): [sig_CT(RC(x)) | sig_GA(x)].

    Two minhash_signatures calls over the collapsed read and the
    collapsed reverse complement (tests/test_minhash_pallas.py).
    """
    from . import encode
    if mirror:
        coll = jnp.where(bases == 2, jnp.int8(0), bases)     # GA(x)
    else:
        coll = jnp.where(bases == 1, jnp.int8(3), bases)     # CT(x)
    rc = encode.revcomp_bases(bases, lengths)
    if mirror:
        other = jnp.where(rc == 1, jnp.int8(3), rc)          # CT(RC(x))
        first, second = other, coll
    else:
        other = jnp.where(rc == 2, jnp.int8(0), rc)          # GA(RC(x))
        first, second = coll, other
    s1, v = minhash_signatures(first, lengths, k, hash_ids, canonical=False)
    s2, _ = minhash_signatures(second, lengths, k, hash_ids,
                               canonical=False)
    return jnp.concatenate([s1, s2], axis=1), v


@partial(jax.jit, static_argnames=("k", "chunk", "canonical"))
def minhash_signatures_chunked(bases: jnp.ndarray, lengths: jnp.ndarray,
                               k: int, hash_ids: jnp.ndarray, chunk: int,
                               canonical: bool = True
                               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Signatures for a large padded batch via lax.map over fixed chunks.

    One compiled program, one output buffer.  The row
    count must be a multiple of `chunk` (pad with zero-length rows).
    """
    n, maxlen = bases.shape
    assert n % chunk == 0, "pad rows to a multiple of chunk"
    bs = bases.reshape(n // chunk, chunk, maxlen)
    ls = lengths.reshape(n // chunk, chunk)

    def body(args):
        b, l = args
        return minhash_signatures(b, l, k, hash_ids, canonical=canonical)

    sigs, valid = jax.lax.map(body, (bs, ls))
    return sigs.reshape(n, -1), valid.reshape(n)
