"""Device vote (minhash_index.vote_candidates) vs the reference of
keepDistinctByFrequency (cpu/oracle.vote_rows; reference:
minhashqueryfilter.cuh:123-279): distinct ids seen in >= min_table_hits
tables, ascending, capped."""

import numpy as np
import jax.numpy as jnp
import pytest

from hashreadmapper_tpu.cpu import oracle
from hashreadmapper_tpu.index import minhash_index as mi

SENT = np.uint32(0xFFFFFFFF)


def make_cand(rng, n, f, c, density=0.2, id_range=5000):
    """[N, F, C] uint32 ascending-per-(n,f) lists with SENTINEL padding,
    duplicated ids across tables so min_table_hits has something to vote."""
    counts = rng.binomial(c, density, size=(n, f))
    # draw ids from a narrow pool so cross-table repeats happen
    out = np.full((n, f, c), SENT, dtype=np.uint32)
    for i in range(n):
        pool = rng.integers(0, id_range, size=16)
        for t in range(f):
            k = counts[i, t]
            if k:
                vals = np.unique(rng.choice(pool, size=k))
                out[i, t, :len(vals)] = np.sort(vals).astype(np.uint32)
    return out


def _check(cand, min_hits, cap):
    got = mi.vote_candidates(jnp.asarray(cand), min_hits, cap)
    for g, w in zip(got, oracle.vote_rows(cand, min_hits, cap)):
        np.testing.assert_array_equal(np.asarray(g), w)
    return [np.asarray(g) for g in got]


@pytest.mark.parametrize("n,f,c,min_hits,cap", [
    (128, 16, 8, 4, 8),
    (256, 32, 16, 4, 8),    # 3N shape: 2F tables
    (128, 12, 4, 2, 4),     # non-power-of-two table count
    (128, 16, 8, 1, 8),     # min_hits == 1 path
])
def test_vote_pallas_matches_xla(n, f, c, min_hits, cap):
    rng = np.random.default_rng(n + f + c)
    _check(make_cand(rng, n, f, c), min_hits, cap)


def test_vote_pallas_empty_and_full():
    n, f, c, cap = 128, 8, 8, 8
    # all-SENTINEL input -> nothing kept
    ids, cnt, nk = _check(np.full((n, f, c), SENT, dtype=np.uint32), 4, cap)
    assert (ids == SENT).all()
    assert (nk == 0).all()
    # one id present in every table of every read -> kept with count f
    cand = np.full((n, f, c), SENT, dtype=np.uint32)
    cand[:, :, 0] = 7
    ids, cnt, nk = _check(cand, 4, cap)
    assert (ids[:, 0] == 7).all()
    assert (cnt[:, 0] == f).all()
    assert (nk == 1).all()


def test_vote_pallas_overflow_num_kept():
    """num_kept beyond out_cap is still reported (overflow accounting)."""
    n, f, c, cap = 128, 8, 8, 2
    cand = np.full((n, f, c), SENT, dtype=np.uint32)
    # 5 distinct ids, each in every table
    for j in range(5):
        cand[:, :, j] = 10 + j
    ids, cnt, nk = _check(cand, 2, cap)
    assert (nk == 5).all()
    assert (ids[:, 0] == 10).all()
    assert (ids[:, 1] == 11).all()
