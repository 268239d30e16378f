"""Device minhash signatures (ops/minhash.py) vs the pure-Python oracle
murmur-minhash (cpu/oracle.py), bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest

from hashreadmapper_tpu.cpu import oracle
from hashreadmapper_tpu.ops import encode, minhash


def _oracle_sigs(bases, lengths, k, hash_ids, canonical):
    """[N, F] uint32 oracle signatures, SIG_SENTINEL rows for len < k."""
    out = np.full((len(lengths), len(hash_ids)), minhash.SIG_SENTINEL,
                  np.uint32)
    for r, ln in enumerate(lengths):
        sig = oracle.minhash_signature([int(b) for b in bases[r, :ln]], k,
                                       [int(h) for h in hash_ids],
                                       canonical=canonical)
        if sig is not None:
            out[r] = sig
    return out


def _batch(rng, n, maxlen, k):
    bases = rng.integers(0, 4, size=(n, maxlen)).astype(np.int8)
    lengths = rng.integers(0, maxlen + 1, size=n).astype(np.int32)
    lengths[:8] = [0, k - 1, k, maxlen, 1, k + 1, maxlen - 1, k]
    return bases, lengths


@pytest.mark.parametrize("k,f", [(16, 16), (16, 3), (11, 16), (1, 2)])
def test_sig_min_murmur_matches_xla(k, f):
    """Forward-k-mer signatures (3N seeding) at every table count."""
    rng = np.random.default_rng(42 + k + f)
    bases, lengths = _batch(rng, 24, 100, k)
    hash_ids = np.arange(f, dtype=np.uint32)
    sig, valid = minhash.minhash_signatures(
        jnp.asarray(bases), jnp.asarray(lengths), k, jnp.asarray(hash_ids),
        canonical=False)
    np.testing.assert_array_equal(
        np.asarray(sig), _oracle_sigs(bases, lengths, k, hash_ids, False))
    np.testing.assert_array_equal(np.asarray(valid), lengths >= k)


@pytest.mark.parametrize("mode", ["fwd", "canon", "both"])
def test_sigs_from_bases_matches_xla(mode):
    """Forward, canonical, and both 3N spaces (signatures_3n_pair)."""
    rng = np.random.default_rng(5)
    k, f = 16, 6
    bases, lengths = _batch(rng, 24, 100, k)
    hash_ids = np.arange(f, dtype=np.uint32)
    bd, ld, hd = (jnp.asarray(bases), jnp.asarray(lengths),
                  jnp.asarray(hash_ids))
    if mode == "both":
        got, _ = minhash.signatures_3n_pair(bd, ld, k, hd)
        ct = np.where(bases == 1, 3, bases)
        ga_rc = np.asarray(encode.revcomp_bases(bd, ld))
        ga_rc = np.where(ga_rc == 2, 0, ga_rc)
        want = np.concatenate(
            [_oracle_sigs(ct, lengths, k, hash_ids, False),
             _oracle_sigs(ga_rc, lengths, k, hash_ids, False)], axis=1)
    else:
        canonical = mode == "canon"
        got, _ = minhash.minhash_signatures(bd, ld, k, hd,
                                            canonical=canonical)
        want = _oracle_sigs(bases, lengths, k, hash_ids, canonical)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("mirror", [False, True])
def test_signatures_3n_pair_fallback_is_engine_formulation(mirror):
    """signatures_3n_pair must equal the engine's two-call formulation
    (collapse + revcomp + collapse)."""
    rng = np.random.default_rng(11)
    k, f, n, maxlen = 16, 16, 128, 128
    bases = rng.integers(0, 4, size=(n, maxlen)).astype(np.int8)
    lengths = rng.integers(k, 101, size=n).astype(np.int32)
    hash_ids = np.arange(f, dtype=np.uint32)
    bd, ld, hd = (jnp.asarray(bases), jnp.asarray(lengths),
                  jnp.asarray(hash_ids))
    got, v = minhash.signatures_3n_pair(bd, ld, k, hd, mirror=mirror)
    rc = encode.revcomp_bases(bd, ld)
    if mirror:
        first = jnp.where(rc == 1, jnp.int8(3), rc)
        second = jnp.where(bd == 2, jnp.int8(0), bd)
    else:
        first = jnp.where(bd == 1, jnp.int8(3), bd)
        second = jnp.where(rc == 2, jnp.int8(0), rc)
    s1, _ = minhash.minhash_signatures(first, ld, k, hd, canonical=False)
    s2, _ = minhash.minhash_signatures(second, ld, k, hd, canonical=False)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.concatenate([s1, s2], axis=1))


def test_sig_min_murmur_vs_py_oracle():
    """Direct check of the reduction: min over positions of the Python
    murmur64 of each forward k-mer + hash id, low 32 bits (k = 16)."""
    rng = np.random.default_rng(7)
    k, f, n, maxlen = 16, 4, 128, 40
    bases = rng.integers(0, 4, size=(n, maxlen)).astype(np.int8)
    lengths = np.full(n, maxlen, np.int32)
    hash_ids = np.arange(f, dtype=np.uint32)
    got = np.asarray(minhash.minhash_signatures(
        jnp.asarray(bases), jnp.asarray(lengths), k, jnp.asarray(hash_ids),
        canonical=False)[0])
    for r in range(0, n, 37):
        kmers = oracle.forward_kmers([int(b) for b in bases[r]], k)
        for fi in range(f):
            h = min(oracle.murmur64(km + fi) for km in kmers)
            assert got[r, fi] == np.uint32(h & 0xFFFFFFFF)
