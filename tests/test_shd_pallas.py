"""Bit-plane SHD (ops/shd.py packed path) == one-hot scan SHD, bit for bit."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from hashreadmapper_tpu.ops import shd
from hashreadmapper_tpu.ops.bitplanes import pack_bitplanes, \
    pack_genome_planes

MODES = {"parity": (False, False), "3n": (True, False),
         "3n_undirectional": (True, True)}


def test_pack_bitplanes():
    bases = jnp.array([[0, 1, 2, 3] * 20], dtype=jnp.int8)  # 80 bases
    hi, lo, mask = pack_bitplanes(bases, jnp.array([70], dtype=jnp.int32), 3)
    hi, lo, mask = np.asarray(hi), np.asarray(lo), np.asarray(mask)
    for pos in range(96):
        w, b = pos // 32, pos % 32
        if pos < 70:
            base = [0, 1, 2, 3][pos % 4]
            assert (hi[0, w] >> b) & 1 == base >> 1, pos
            assert (lo[0, w] >> b) & 1 == base & 1, pos
            assert (mask[0, w] >> b) & 1 == 1, pos
        else:
            assert (hi[0, w] >> b) & 1 == 0, pos
            assert (lo[0, w] >> b) & 1 == 0, pos
            assert (mask[0, w] >> b) & 1 == 0, pos


def _pairs(seed, n, genome_len, max_read_len, window_size, min_len=6,
           near=False):
    """Planted (some reverse-complemented, a few substitutions) and random
    reads against random window positions; near=True puts each planted
    read's window within half a window of its source."""
    rng = random.Random(seed)
    genome = [rng.randrange(4) for _ in range(genome_len)]
    pairs = []
    for _ in range(n):
        pos = rng.randrange(0, genome_len - 4)
        rl = rng.randint(min_len, max_read_len)
        if rng.random() < 0.6:
            src = rng.randrange(0, genome_len - rl)
            read = genome[src:src + rl]
            if rng.random() < 0.5:
                read = [3 - b for b in reversed(read)]
            for _ in range(rng.randint(0, 2)):
                read[rng.randrange(rl)] = rng.randrange(4)
            if near:
                pos = max(0, src - rng.randrange(window_size // 2))
        else:
            read = [rng.randrange(4) for _ in range(rl)]
        pairs.append((pos, read))
    p = len(pairs)
    pos_arr = jnp.array([x[0] for x in pairs], dtype=jnp.int32)
    rl_arr = jnp.array([len(x[1]) for x in pairs], dtype=jnp.int32)
    reads = np.zeros((p, max_read_len), dtype=np.int8)
    for i, (_, r) in enumerate(pairs):
        reads[i, :len(r)] = r
    loc = shd.extended_window_location(
        pos_arr, jnp.full((p,), genome_len, dtype=jnp.int32), rl_arr,
        window_size)
    params = shd.ShdParams(window_size=window_size,
                           max_ext_len=window_size + max_read_len,
                           max_read_len=max_read_len,
                           max_hamming_percent=0.3)
    return jnp.array(genome, dtype=jnp.int8), loc, jnp.array(reads), \
        rl_arr, params


def _packed(genome, loc, reads, rl, valid, params, three_n, und):
    g_hi, g_lo = pack_genome_planes(genome)
    planes = shd.pack_read_planes(reads, rl, three_n, und)
    return shd.shd_pairs_packed_planes(
        g_hi, g_lo, loc.start, loc.length, loc.left, *planes, rl, valid,
        params, three_n=three_n, undirectional=und)


def _assert_same(got, want):
    for field in ("orientation", "hamming", "shift"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_bitplane_matches_onehot():
    genome, loc, reads, rl, params = _pairs(0, 150, 800, 32, 48)
    valid = jnp.ones((rl.shape[0],), dtype=bool)
    want = shd.shd_pairs(genome, loc.start, loc.length, loc.left, reads, rl,
                         valid, params)
    _assert_same(_packed(genome, loc, reads, rl, valid, params, False,
                         False), want)


def test_packed_genome_matches_unpacked():
    genome, loc, reads, rl, params = _pairs(5, 200, 1000, 32, 48)
    valid = np.ones(rl.shape[0], dtype=bool)
    valid[3] = False
    valid = jnp.asarray(valid)
    for three_n in (False, True):
        want = shd.shd_pairs(genome, loc.start, loc.length, loc.left, reads,
                             rl, valid, params, three_n=three_n)
        _assert_same(_packed(genome, loc, reads, rl, valid, params, three_n,
                             False), want)


@pytest.mark.parametrize("read_len", [50, 100, 150, 160])
@pytest.mark.parametrize("mode", list(MODES))
def test_shd_xla_matches_onehot(mode, read_len):
    """The bit-plane running argmin (shd_best) == the one-hot scan at
    production widths."""
    three_n, und = MODES[mode]
    genome, loc, reads, rl, params = _pairs(
        read_len, 160, 4000, read_len, 128, min_len=read_len // 2,
        near=True)
    valid = jnp.ones((rl.shape[0],), dtype=bool)
    want = shd.shd_pairs(genome, loc.start, loc.length, loc.left, reads, rl,
                         valid, params, three_n=three_n, undirectional=und)
    got = _packed(genome, loc, reads, rl, valid, params, three_n, und)
    _assert_same(got, want)
    assert (np.asarray(got.orientation) != shd.NONE).sum() > 0


def _random_planes(seed, p, wr, n_shifts=160):
    """Random plane words and shift ranges, including empty ranges."""
    rng = np.random.default_rng(seed)
    wa = (n_shifts - 1) // 32 + wr + 2

    def words(*shape):
        return jnp.asarray(rng.integers(-2**31, 2**31, size=shape,
                                        dtype=np.int64).astype(np.int32))

    lo = rng.integers(0, 32, p)
    hi = lo + rng.integers(-5, n_shifts - 31, p)
    bounds = jnp.asarray(np.stack([lo, hi], 1).astype(np.int32))
    return (words(p, 2, wa), words(p, 2, wa), words(p, 2, wr),
            words(p, 2, wr), words(p, wr), bounds, n_shifts, wa, wr)


def _numpy_best(a_hi, a_lo, r_hi, r_lo, mask, bounds, n_shifts, wa, wr):
    """Bit-by-bit reference of shd.shd_best: unpack the plane words,
    score every shift of the range, keep the first minimum."""
    def bits(x):
        x = np.ascontiguousarray(np.asarray(x).astype("<u4"))
        return np.unpackbits(x.view(np.uint8), axis=-1, bitorder="little")

    a_hi, a_lo, r_hi, r_lo, m = map(bits, (a_hi, a_lo, r_hi, r_lo, mask))
    bounds = np.asarray(bounds)
    n_bits = 32 * wr
    s_all = 32 * ((n_shifts + 31) // 32)
    ham = np.stack([
        (((a_hi[:, :, s:s + n_bits] ^ r_hi) | (a_lo[:, :, s:s + n_bits] ^ r_lo))
         & m[:, None, :]).sum(axis=-1, dtype=np.int32)
        for s in range(s_all)], axis=-1)                          # [P, 2, S]
    s = np.arange(s_all)[None, None, :]
    ok = (s >= bounds[:, :1, None]) & (s <= bounds[:, 1:, None])
    ham = np.where(ok, ham, int(shd._BIG))
    best = ham.min(axis=2)
    shift = np.where(best >= shd._BIG, bounds[:, :1], ham.argmin(axis=2))
    return np.stack([best[:, 0], shift[:, 0], best[:, 1], shift[:, 1]],
                    axis=1).astype(np.int32)


@pytest.mark.parametrize("p,wr", [(128, 4), (200, 5), (1, 4), (300, 2)])
def test_shd_best_matches_numpy(p, wr):
    """The bit-plane running argmin on random plane words and shift
    ranges (empty ranges included) == the bit-by-bit numpy reference."""
    args = _random_planes(p + wr, p, wr)
    np.testing.assert_array_equal(np.asarray(shd.shd_best(*args)),
                                  _numpy_best(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("wr", [4, 5])
def test_shd_best_on_card_matches_numpy(gpu, wr):
    """The running argmin as compiled for the card == the numpy
    reference, at the bench batch (4096 reads x 4 pairs)."""
    args = _random_planes(wr, 4096 * 4, wr)
    np.testing.assert_array_equal(np.asarray(shd.shd_best(*args)),
                                  _numpy_best(*args))
