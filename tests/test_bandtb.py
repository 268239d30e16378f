"""Device banded traceback (ops/bandtb.py) vs the host banded DP.

The device fill+walk must reproduce native/swalign.cpp::banded_cigar (which
mirrors the golden-locked align/sw.py::_banded_cigar) bit-exactly: same
CIGARs, same mismatch counts, same traceback-failure flags — verified by
running hrm_ssw_finish_batch with and without the device ops.
"""

import numpy as np
import pytest

from hashreadmapper_tpu import native
from hashreadmapper_tpu.ops import bandtb, swdev

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="libhrm_native.so not built")

LQ = 128
LR = 128


def _indel_pairs(rng, n):
    """Planted pairs with substitutions AND indels (plus random junk)."""
    rc = np.full((n, LQ), 4, np.int8)
    fc = np.full((n, LR), 4, np.int8)
    rls = np.zeros(n, np.int32)
    fls = np.zeros(n, np.int32)
    for i in range(n):
        fl = int(rng.integers(40, LR + 1))
        ref = rng.integers(0, 4, fl).astype(np.int8)
        kind = i % 4
        if kind == 3:
            rl = int(rng.integers(20, LQ + 1))
            read = rng.integers(0, 5, rl).astype(np.int8)
        else:
            start = int(rng.integers(0, max(1, fl - 30)))
            seg = list(ref[start:start + int(rng.integers(25, 40))])
            # substitutions
            for _ in range(int(rng.integers(0, 5))):
                seg[int(rng.integers(0, len(seg)))] = int(rng.integers(0, 4))
            if kind == 1 and len(seg) > 6:       # deletion from the read
                d = int(rng.integers(1, 4))
                p = int(rng.integers(1, len(seg) - d))
                seg = seg[:p] + seg[p + d:]
            elif kind == 2:                      # insertion into the read
                p = int(rng.integers(1, len(seg)))
                seg = seg[:p] + list(rng.integers(0, 4, int(
                    rng.integers(1, 4)))) + seg[p:]
            read = np.array(seg, np.int8)
            rl = len(read)
        rc[i, :rl] = read
        fc[i, :fl] = ref
        rls[i] = rl
        fls[i] = fl
    return rc, rls, fc, fls


def _finish_both(rc, rls, fc, fls, dev, use_diag):
    """Run the native finish with and without device traceback ops."""
    n = rc.shape[0]
    sel = ~dev["host_fallback"] & ~dev["degenerate"]
    idx = np.nonzero(sel)[0]
    ops, status = bandtb.banded_traceback_batch(
        rc[idx], dev["query_begin"][idx], dev["query_end"][idx],
        fc[idx], dev["ref_begin"][idx], dev["ref_end"][idx],
        dev["score1"][idx])
    ops_all = np.zeros((n, ops.shape[1]), np.int16)
    fail_all = np.zeros(n, np.int8)
    ops_all[idx] = np.asarray(ops)
    fail_all[idx] = np.asarray(status)
    diag = dev["diag"].astype(np.int8) if use_diag else None
    args = (rc[sel].tobytes(),
            np.arange(sel.sum(), dtype=np.int32) * LQ, rls[sel],
            fc[sel].tobytes(),
            np.arange(sel.sum(), dtype=np.int32) * LR, fls[sel],
            dev["score1"][sel], dev["ref_begin"][sel], dev["ref_end"][sel],
            dev["query_begin"][sel], dev["query_end"][sel],
            np.zeros(int(sel.sum()), np.int32))
    kw = dict(threads=2, codes=True,
              diag=(diag[sel] if diag is not None else None))
    host = native.ssw_finish_batch(*args, **kw)
    devr = native.ssw_finish_batch(*args, **kw, dev_ops=ops_all[sel],
                                   dev_fail=fail_all[sel])
    return host, devr, int(sel.sum())


def test_bandtb_bit_identical_with_indels():
    rng = np.random.default_rng(23)
    n = 96
    rc, rls, fc, fls = _indel_pairs(rng, n)
    dev = swdev.ssw_score_batch(rc, rls, fc, fls,
                                np.maximum(15, rls // 2).astype(np.int32))
    host, devr, nsel = _finish_both(rc, rls, fc, fls, dev, use_diag=False)
    assert nsel > 50
    h_cig, h_mism, h_flag = host
    d_cig, d_mism, d_flag = devr
    assert h_cig == d_cig
    np.testing.assert_array_equal(h_mism, d_mism)
    np.testing.assert_array_equal(h_flag, d_flag)
    # the batch must actually exercise indel CIGARs
    assert any(("I" in c or "D" in c) for c in h_cig)


def test_bandtb_with_diag_certificate():
    """Production config: certified pairs keep the diag fast path, the rest
    take device ops — still bit-identical."""
    rng = np.random.default_rng(5)
    n = 64
    rc, rls, fc, fls = _indel_pairs(rng, n)
    dev = swdev.ssw_score_batch(rc, rls, fc, fls,
                                np.maximum(15, rls // 2).astype(np.int32))
    host, devr, _ = _finish_both(rc, rls, fc, fls, dev, use_diag=True)
    assert host[0] == devr[0]
    np.testing.assert_array_equal(host[1], devr[1])
    np.testing.assert_array_equal(host[2], devr[2])


def test_bandtb_band_doubling_cases():
    """Pairs engineered so the first band fails (large indel -> wide band
    needed) exercise the doubling loop on device."""
    rng = np.random.default_rng(77)
    n = 32
    rc = np.full((n, LQ), 4, np.int8)
    fc = np.full((n, LR), 4, np.int8)
    rls = np.zeros(n, np.int32)
    fls = np.zeros(n, np.int32)
    for i in range(n):
        fl = int(rng.integers(80, LR + 1))
        ref = rng.integers(0, 4, fl).astype(np.int8)
        seg = list(ref[5:75])
        p = int(rng.integers(10, 50))
        d = int(rng.integers(8, 20))        # big indel vs |r-m|+1 start band
        if i % 2 == 0:
            seg = seg[:p] + seg[p + min(d, len(seg) - p - 1):]
            pad = list(ref[75:75 + d])       # keep lengths ~equal: bw0 small
            seg = seg + pad
        else:
            seg = seg[:p] + list(rng.integers(0, 4, d)) + seg[p:]
            seg = seg[:70]
        rc[i, :len(seg)] = np.array(seg, np.int8)
        rls[i] = len(seg)
        fc[i, :fl] = ref
        fls[i] = fl
    dev = swdev.ssw_score_batch(rc, rls, fc, fls,
                                np.maximum(15, rls // 2).astype(np.int32))
    host, devr, nsel = _finish_both(rc, rls, fc, fls, dev, use_diag=False)
    assert nsel > 10
    assert host[0] == devr[0]
    np.testing.assert_array_equal(host[1], devr[1])
    np.testing.assert_array_equal(host[2], devr[2])


def test_shift_sub_pallas_matches_xla():
    """The select+roll barrel shift must equal a plain per-pair slice:
    sub[t, p] = x[begin[p] + t, p], code 4 past the end."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    L, P, size = 96, 256, 128
    x = rng.integers(0, 5, size=(L, P)).astype(np.int32)
    sh = rng.integers(0, L, size=P).astype(np.int32)
    got = np.asarray(bandtb._shift_sub(jnp.asarray(x), jnp.asarray(sh),
                                       size))
    want = np.full((size, P), 4, np.int32)
    for p in range(P):
        col = x[sh[p]:, p][:size]
        want[:len(col), p] = col
    np.testing.assert_array_equal(got, want)
