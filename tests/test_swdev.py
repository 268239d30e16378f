"""Device SSW score pass (ops/swdev.py) vs the host lane-exact oracle.

The device kernel must be bit-identical to align/sw.py::_striped_pass /
ssw_align (which are themselves golden-locked against the compiled
reference SSW, tests/golden/ssw_golden.txt)."""

import numpy as np
import pytest

from hashreadmapper_tpu.align import sw
from hashreadmapper_tpu.ops import swdev


def _random_pairs(rng, n, lq_max=128, lr_max=128, alphabet=5):
    reads, refs, rls, fls = [], [], [], []
    for t in range(n):
        rl = int(rng.integers(1, lq_max + 1))
        fl = int(rng.integers(1, lr_max + 1))
        if t % 3 == 0:
            # high-identity pair (planted read)
            ref = rng.integers(0, alphabet, fl).astype(np.int8)
            if fl >= rl:
                read = ref[:rl].copy()
            else:
                read = np.concatenate(
                    [ref, rng.integers(0, 4, rl - fl)]).astype(np.int8)
            mut = rng.random(rl) < 0.08
            read[mut] = rng.integers(0, 4, int(mut.sum()))
        else:
            read = rng.integers(0, alphabet, rl).astype(np.int8)
            ref = rng.integers(0, alphabet, fl).astype(np.int8)
        reads.append(read)
        refs.append(ref)
        rls.append(rl)
        fls.append(fl)
    rc = np.full((n, lq_max), 4, dtype=np.int8)
    fc = np.full((n, lr_max), 4, dtype=np.int8)
    for i in range(n):
        rc[i, :rls[i]] = reads[i]
        fc[i, :fls[i]] = refs[i]
    return (rc, np.array(rls, np.int32), fc, np.array(fls, np.int32),
            reads, refs)


def test_forward_pass_bit_exact():
    rng = np.random.default_rng(7)
    n = 64
    rc, rls, fc, fls, reads, refs = _random_pairs(rng, n)
    masks = np.maximum(15, rls // 2).astype(np.int32)
    out = swdev.ssw_forward_batch(rc, rls, fc, fls, masks, 128)
    out = {k: np.asarray(v) for k, v in out.items()}
    for i in range(n):
        best, end_ref, end_read, max_column, _ = sw._striped_pass(
            reads[i], refs[i], 0, sw.SCORE_MATRIX, sw.GAP_OPEN,
            sw.GAP_EXTEND, terminate=255, byte_mode=True)
        if best == 255:
            assert out["overflowed"][i]
            continue
        assert out["score1"][i] == best, i
        assert out["ref_end"][i] == end_ref, i
        assert out["query_end"][i] == end_read, i
        # second-best via the host rule
        score2, ref_end2 = 0, 0
        lo = max(0, end_ref - int(masks[i]))
        hi = min(int(fls[i]), end_ref + int(masks[i]))
        for j in range(0, lo):
            if max_column[j] > score2:
                score2, ref_end2 = int(max_column[j]), j
        for j in range(hi + 1, int(fls[i])):
            if max_column[j] > score2:
                score2, ref_end2 = int(max_column[j]), j
        assert out["score2"][i] == score2, i
        assert out["ref_end2"][i] == ref_end2, i


def test_forward_pass_lazy_f_adversarial():
    """Gap-heavy and low-complexity pairs — maximal lazy-F activity.

    Pins the full-propagation lazy-F formulation (Farrar's early exit is
    exact, see swdev._pass_batched) against the oracle's faithful
    exit-emulating scalar simulation."""
    rng = np.random.default_rng(11)
    n, lq, ncols = 96, 128, 128
    rl = rng.integers(1, 101, n).astype(np.int32)
    fl = rng.integers(1, 129, n).astype(np.int32)
    q = rng.integers(0, 5, (n, lq)).astype(np.int8)
    r = rng.integers(0, 5, (n, ncols)).astype(np.int8)
    base = rng.integers(0, 4, 300).astype(np.int8)
    for p in range(n):
        if p % 3 == 0:
            # shared substring with a spliced indel (strong F chains)
            o1 = int(rng.integers(0, 150))
            o2 = int(rng.integers(0, 150))
            q[p, :rl[p]] = base[o1:o1 + rl[p]]
            r[p, :fl[p]] = base[o2:o2 + fl[p]]
            cut = int(rng.integers(0, max(1, rl[p])))
            ins = int(rng.integers(0, 30))
            q[p, cut:rl[p]] = base[o1 + cut + ins:o1 + rl[p] + ins]
        elif p % 3 == 1:
            # low-complexity: F wins constantly
            q[p] = rng.integers(0, 2, lq)
            r[p] = rng.integers(0, 2, ncols)
    masks = np.maximum(15, rl // 2).astype(np.int32)
    out = swdev.ssw_forward_batch(q, rl, fc := r, fl, masks, ncols)
    out = {k: np.asarray(v) for k, v in out.items()}
    for i in range(n):
        best, end_ref, end_read, _, _ = sw._striped_pass(
            q[i, :rl[i]], r[i, :fl[i]], 0, sw.SCORE_MATRIX, sw.GAP_OPEN,
            sw.GAP_EXTEND, terminate=255, byte_mode=True)
        if best == 255:
            assert out["overflowed"][i]
            continue
        assert out["score1"][i] == best, i
        assert out["ref_end"][i] == end_ref, i
        assert out["query_end"][i] == end_read, i


def test_full_alignment_vs_host_oracle():
    """Device fwd+rev == ssw_align's score fields on realistic 3N pairs."""
    rng = np.random.default_rng(11)
    n = 48
    lq, lr = 128, 128
    rc = np.full((n, lq), 4, dtype=np.int8)
    fc = np.full((n, lr), 4, dtype=np.int8)
    rls = np.zeros(n, np.int32)
    fls = np.zeros(n, np.int32)
    queries, windows = [], []
    b2c = np.array(list("ACGT"))
    for i in range(n):
        fl = 128
        wlen = int(rng.integers(60, fl + 1)) if i % 5 == 0 else fl
        win = rng.integers(0, 4, wlen)
        rl = int(rng.integers(40, 101))
        off = int(rng.integers(0, max(1, wlen - rl))) if wlen > rl else 0
        read = win[off:off + min(rl, wlen)].copy()
        if len(read) < rl:
            read = np.concatenate([read, rng.integers(0, 4, rl - len(read))])
        mut = rng.random(rl) < 0.05
        read[mut] = rng.integers(0, 4, int(mut.sum()))
        q = "".join(b2c[read]).replace("C", "T")      # 3N query
        w = "".join(b2c[win]).replace("C", "T")       # 3N window
        queries.append(q)
        windows.append(w)
        qt = sw.translate(q)
        wt = sw.translate(w)
        rc[i, :len(qt)] = qt
        fc[i, :len(wt)] = wt
        rls[i] = len(qt)
        fls[i] = len(wt)
    masks = np.maximum(15, rls // 2).astype(np.int32)

    dev = swdev.ssw_score_batch(rc, rls, fc, fls, masks)
    for i in range(n):
        al = sw.ssw_align(queries[i], windows[i], int(masks[i]),
                          compute_cigar=False)
        if dev["host_fallback"][i]:
            assert al.sw_score == 255
            continue
        assert dev["score1"][i] == al.sw_score, i
        assert dev["score2"][i] == al.sw_score_next_best, i
        assert dev["ref_end"][i] == al.ref_end, i
        assert dev["ref_end2"][i] == al.ref_end_next_best, i
        assert dev["query_end"][i] == al.query_end, i
        if dev["degenerate"][i]:
            continue
        assert dev["ref_begin"][i] == al.ref_begin, i
        assert dev["query_begin"][i] == al.query_begin, i
        assert dev["flag"][i] == al.flag, i


def test_degenerate_and_tiny():
    """Tiny reads/refs and all-N pairs behave like the oracle."""
    cases = [("A", "A"), ("A", "T"), ("ACGT", "ACGT"), ("N", "N"),
             ("AC", "ACACACAC"), ("T" * 17, "T" * 3)]
    lq = 32
    n = len(cases)
    rc = np.full((n, lq), 4, np.int8)
    fc = np.full((n, lq), 4, np.int8)
    rls = np.zeros(n, np.int32)
    fls = np.zeros(n, np.int32)
    for i, (q, w) in enumerate(cases):
        qt, wt = sw.translate(q), sw.translate(w)
        rc[i, :len(qt)] = qt
        fc[i, :len(wt)] = wt
        rls[i], fls[i] = len(qt), len(wt)
    masks = np.full(n, 15, np.int32)
    dev = swdev.ssw_score_batch(rc, rls, fc, fls, masks)
    for i, (q, w) in enumerate(cases):
        al = sw.ssw_align(q, w, 15, compute_cigar=False)
        assert dev["score1"][i] == al.sw_score, (i, q, w)
        if al.sw_score == 0:
            assert dev["degenerate"][i]
            continue
        assert dev["ref_end"][i] == al.ref_end, (i, q, w)
        assert dev["query_end"][i] == al.query_end, (i, q, w)
        assert dev["ref_begin"][i] == al.ref_begin, (i, q, w)
        assert dev["query_begin"][i] == al.query_begin, (i, q, w)


def _forward_vs_host(rng, n, lq_max=128, lr_max=128, alphabet=5):
    """The XLA striped pass (forward) vs the host lane-exact oracle on
    random pairs, elementwise."""
    rc, rls, fc, fls, reads, refs = _random_pairs(rng, n, lq_max, lr_max,
                                                  alphabet)
    masks = np.maximum(15, rls // 2).astype(np.int32)
    out = swdev.ssw_forward_batch(rc, rls, fc, fls, masks, lr_max)
    out = {k: np.asarray(v) for k, v in out.items()}
    for i in range(n):
        best, end_ref, end_read, _, _ = sw._striped_pass(
            reads[i], refs[i], 0, sw.SCORE_MATRIX, sw.GAP_OPEN,
            sw.GAP_EXTEND, terminate=255, byte_mode=True)
        if best == 255:
            assert out["overflowed"][i]
            continue
        assert not out["overflowed"][i], i
        assert out["score1"][i] == best, i
        assert out["ref_end"][i] == end_ref, i
        assert out["query_end"][i] == end_read, i


def test_pallas_pass_equivalence():
    """XLA striped pass == host oracle, bit for bit (fuzz; includes
    saturating and odd-P shapes)."""
    rng = np.random.default_rng(123)
    _forward_vs_host(rng, 64)          # lq 128 (S=8), realistic
    _forward_vs_host(rng, 32, lq_max=64, lr_max=96)   # segLen variety
    _forward_vs_host(rng, 130)         # P not a multiple of 128


def test_pallas_pass_terminate_equivalence():
    """Reverse-pass semantics: the terminate=score1 early stop must give
    the host aligner's begin positions and flag."""
    rng = np.random.default_rng(9)
    n = 64
    rc, rls, fc, fls, reads, refs = _random_pairs(rng, n)
    masks = np.maximum(15, rls // 2).astype(np.int32)
    dev = swdev.ssw_score_batch(rc, rls, fc, fls, masks)
    b2c = np.array(list("ACGTN"))
    checked = 0
    for i in range(n):
        q = "".join(b2c[reads[i]])
        w = "".join(b2c[refs[i]])
        al = sw.ssw_align(q, w, int(masks[i]), compute_cigar=False)
        if dev["host_fallback"][i]:
            assert al.sw_score == 255
            continue
        assert dev["score1"][i] == al.sw_score, i
        if dev["degenerate"][i]:
            continue
        assert dev["ref_begin"][i] == al.ref_begin, i
        assert dev["query_begin"][i] == al.query_begin, i
        assert dev["flag"][i] == al.flag, i
        checked += 1
    assert checked > n // 2
