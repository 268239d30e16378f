"""Batched on-device banded affine-gap traceback (STEP-2 CIGAR DP).

Device reformulation of the banded CIGAR pass that follows the SSW score
passes (reference: src/ssw.c:550-790 banded_sw driven from
src/gpu/mappinghandler.cu:560-595; host oracle align/sw.py::_banded_cigar,
golden-verified, re-derived natively in native/swalign.cpp::banded_cigar).
It covers the pairs the all-M diag certificate
(ops/swdev.py::_diag_fastpath_flag) does not.  The band fill runs on the
device over all pairs at once and the traceback walk consumes whole CIGAR
RUNS per step, so the host only merges the returned run-length entries and
does the =/X rewrite (native/swalign.cpp::finish_alignment).

Reformulation notes (per DP row i over ref lanes j, band
[beg, endj] = [max(0, i-bw), min(r-1, i+bw)]):

  * the E layer (gap in read) depends only on row i-1 -> elementwise.
  * the F layer (gap in ref) recurrence f_j = max(h_{j-1}-go, f_{j-1}-ge)
    with h_j = max(a_j, max(f_j, 0)) collapses (go > ge, h >= 0) to
        f_j = max(max(a_{j-1}, 0) - go, f_{j-1} - ge)
    a max-plus prefix scan along the lane axis:
        f_j = max(cummax(u_k + k*ge)[j] - j*ge, (beg-1-j)*ge)
    with u_k = max(a_{k-1}, 0) - go and the second term the f=0 row seed.
  * direction tie rules replicate the oracle exactly (t1 > t2 for E/F,
    t1 <= t2 preferring the diagonal for H).
  * run-length encoding: the traceback only ever READS cells in the H
    layer — an E/F excursion is a maximal run of I/D steps whose length
    is a pure function of the de/df bit chains — so the fill precomputes
    per cell the FULL run the walk would take from it:
        dh==1: diagonal M-run  D2[i,j] = 1 + D2[i-1,j-1]   (while dh==1)
        dh==2: I-run 1 + J[i-1,j],  J = de==0 ? 1 + J_up : 1  (vertical)
        dh==3: I-run 1            dh==5: D-run 1
        dh==4: D-run 1 + K[i,j-1], K = df==0 ? 1 + K_left : 1 (in-row)
    packed per cell as int16 (dh in bits 0..2, run length in bits 3..14;
    0 = out of band / run crosses the band = the oracle's traceback
    failure).  The walk then emits one (op, len) entry per gather — a few
    entries per pair instead of one step per CIGAR base.
  * band doubling (double while best < score1 and 2*bw <= max_len) runs
    as a FIXED-length scan of passes, with no data-dependent loop exit;
    done pairs keep their bw so extra passes recompute final results and
    change nothing.

Monotonicity argument used for the doubling loop (why per-pass best at
the final band equals the oracle's best accumulated across passes):
in-band h values are monotone non-decreasing in bw.  The only
mask-dependent read that can DECREASE when unmasked is e_up (e can be
negative); but a negative e never reaches h (e enters h clamped at 0 and
the chain e-ge only decays until refreshed by the mask-independent
h_up-go), so widening the band never lowers any h cell, and the oracle's
carried-over best equals the final pass's best.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

GAP_OPEN = 3
GAP_EXTEND = 1
MATCH = 2
MISMATCH = 2

_BIG = np.int32(0x3FFFFFFF)  # np not jnp: module-level jnp constants
# initialize the backend at import time (see ops/swdev.py)
_POISON = np.int32(-4096)    # run crossed the band -> oracle fails

N_ENTRIES = 64  # walk entries per pair; overflow -> host banded_cigar
# walk result codes (ops int16: dh-op in bits 0..1, run length in 2..14)
OP_M, OP_I, OP_D = 1, 2, 3


def _shift_sub(codes_t, begin, size):
    """codes_t [L, P] -> sub[t] = codes[begin + t] (4 past the end).

    Barrel shift by `begin` via log2 select+roll: log2(L) whole-array
    selects instead of a per-element gather."""
    L, P = codes_t.shape
    pad = jnp.full((size, P), 4, jnp.int32)
    x = jnp.concatenate([codes_t, pad], axis=0)
    n = int(x.shape[0])
    sh = begin.astype(jnp.int32)
    for b in range(max(1, (n - 1).bit_length())):
        step = 1 << b
        if step >= n:
            break
        x = jnp.where((sh & step).astype(bool)[None, :],
                      jnp.roll(x, -step, axis=0), x)
    return x[:size]


def _row_core(h_up, e_up, d2_up, j_up, read_i, sub_ref, s_valid, i, m, r,
              bw, j_l, sdj, n_lanes: int, emit_dirs: bool = True):
    """Single-row recurrence of the banded fill; `sdj` is the shift
    primitive along the ref-position axis.

    h_up/e_up carries are masked to 0 outside the previous row's band;
    d2_up to 0; j_up holds _POISON outside it (and 0 before row 0, so a
    top-exiting I-run stays legitimate).  read_i broadcastable to the
    cell grid.  Returns (h, e_cur, d2, jj, packed16, ok)."""
    beg = jnp.maximum(0, i - bw)
    inb = (j_l >= beg) & (j_l <= jnp.minimum(r - 1, i + bw))
    row_act = i < m
    in_up = j_l <= (i - 1 + bw)
    hu = jnp.where(in_up, h_up, 0)
    eu = jnp.where(in_up, e_up, 0)
    t1e = hu - GAP_OPEN
    t2e = eu - GAP_EXTEND
    e_cur = jnp.maximum(t1e, t2e)
    e1 = jnp.maximum(e_cur, 0)
    at_beg = j_l == beg
    hd = jnp.where(at_beg, 0, sdj(h_up, 1, jnp.int32(0)))
    s = jnp.where((sub_ref == read_i) & s_valid, MATCH, -MISMATCH)
    t2 = hd + s
    a = jnp.maximum(e1, t2)
    am1 = jnp.where(at_beg, 0, sdj(a, 1, jnp.int32(0)))
    v = jnp.where(inb, jnp.maximum(am1, 0) - GAP_OPEN + j_l, -_BIG)
    run = v
    k = 1
    while k < n_lanes:
        run = jnp.maximum(run, sdj(run, k, -_BIG))
        k *= 2
    f = jnp.maximum(run - j_l, beg - 1 - j_l)
    f1 = jnp.maximum(f, 0)
    h = jnp.maximum(a, f1)
    ok = inb & row_act
    if not emit_dirs:
        # score-only doubling pass: no directions, no run chains
        zero = jnp.zeros_like(h)
        return (jnp.where(ok, h, 0), jnp.where(ok, e_cur, 0),
                zero, zero, zero.astype(jnp.int16), ok)

    de = (t1e > t2e).astype(jnp.int32)
    hm1 = jnp.where(at_beg, 0, sdj(h, 1, jnp.int32(0)))
    fm1 = jnp.where(at_beg, 0, sdj(f, 1, jnp.int32(0)))
    df = (hm1 - GAP_OPEN > fm1 - GAP_EXTEND).astype(jnp.int32)
    t1h = jnp.maximum(e1, f1)
    dh = jnp.where(t1h <= t2, 1, jnp.where(e1 > f1, 2 + de, 4 + df))

    # M-run: diagonal chain of dh==1 cells.  The diagonal preserves j-i,
    # so it can never leave the band mid-run (no poison needed).
    d2_diag = jnp.where(at_beg, 0, sdj(d2_up, 1, jnp.int32(0)))
    d2 = jnp.where(dh == 1, 1 + jnp.maximum(d2_diag, 0), 0)
    # I-run vertical chain: J = de==0 ? 1 + J_up : 1.  j_up is _POISON
    # outside the previous band (the oracle's walk fails on leaving the
    # band) and 0 above row 0 (a top exit is a normal loop exit, and the
    # i+1 cap in the walk trims the run there anyway).
    jj = jnp.where(de == 0, 1 + j_up, 1)
    jj = jnp.where(inb, jj, _POISON)
    # D-run horizontal chain: K[j] = df==0 ? 1 + K[j-1] : 1.
    # K[j] = j - Z[j] + 1 with Z = doubled position of the last df==1 at
    # or before j.  At the band begin: beg > 0 crossing = oracle failure,
    # marked with the ODD value 2*beg-1 (poisons until the next real
    # df==1 resets the cummax); beg == 0 is the walk's normal j==0 exit,
    # marked with the even 0 (acts as a virtual reset giving K = j + 1,
    # which the walk's j cap trims to the exact step count).
    w = jnp.where(df == 1, 2 * j_l, -_BIG)
    w = jnp.where(at_beg & (df == 0),
                  jnp.where(beg > 0, 2 * j_l - 1, 0), w)
    w = jnp.where(inb, w, -_BIG)
    z = w
    k = 1
    while k < n_lanes:
        z = jnp.maximum(z, sdj(z, k, -_BIG))
        k *= 2
    kk = jnp.where((z & 1) == 1, _POISON, j_l - (z >> 1) + 1)
    # full run length the walk takes from this cell, by dh
    km1 = jnp.where(at_beg, _POISON, sdj(kk, 1, _POISON))
    rl = jnp.where(dh == 1, d2,
                   jnp.where(dh == 2, 1 + j_up,
                             jnp.where(dh == 4, 1 + km1, 1)))
    rl = jnp.clip(rl, 0, (1 << 12) - 1)
    packed = jnp.where(ok & (rl > 0), dh | (rl << 3), 0)
    return (jnp.where(ok, h, 0), jnp.where(ok, e_cur, 0),
            jnp.where(ok, d2, 0), jnp.where(ok, jj, _POISON),
            packed, ok)


def _sdj_lanes(x, k, fill):
    """Ref-position (axis 1) shift of the [P, NL] layout."""
    return jnp.concatenate(
        [jnp.full(x.shape[:1] + (k,), fill, x.dtype), x[:, :-k]], axis=1)


def _fill_pass(read_t, sub_ref, m, r, bw, m_max: int, emit_dirs: bool):
    """One banded DP pass at band width bw (a scan over read rows).

    read_t [m_max, P] subregion read codes, sub_ref [P, NL] subregion ref
    codes.  Returns (best [P], packed [m_max, P, NL] int16 or None)."""
    P = sub_ref.shape[0]
    NL = sub_ref.shape[1]
    j_l = jax.lax.broadcasted_iota(jnp.int32, (P, NL), 1)
    s_valid = sub_ref < 4

    def row(carry, xs):
        h_up, e_up, d2_up, j_up, best = carry
        read_i, i = xs
        h, e, d2, jj, packed, ok = _row_core(
            h_up, e_up, d2_up, j_up, read_i[:, None], sub_ref, s_valid,
            i, m[:, None], r[:, None], bw[:, None], j_l, _sdj_lanes, NL,
            emit_dirs)
        best = jnp.maximum(best, jnp.max(jnp.where(ok, h, 0), axis=1))
        ys = packed.astype(jnp.int16) if emit_dirs else jnp.int32(0)
        return (h, e, d2, jj, best), ys

    z = jnp.zeros((P, NL), jnp.int32)
    init = (z, z, z, z, jnp.zeros((P,), jnp.int32))
    xs = (read_t[:m_max], jnp.arange(m_max, dtype=jnp.int32)[:, None])
    (_, _, _, _, best), dirs = jax.lax.scan(row, init, xs)
    return best, (dirs if emit_dirs else None)


FUSED_ENTRIES = 48   # fused-mode walk budget (uint8 entries, runs split
# at 63; p99 of real walks is ~35 entries — overflow -> host banded DP)


def fused_traceback_t(pair_q_t, pair_ref_t, s10,
                      n_entries: int = FUSED_ENTRIES):
    """Traced banded traceback for one scored batch — called INSIDE the
    engine's fused coarse+score jit (engine.fused_step2_scores), so the
    pair tensors never leave device memory.  Transposed pair tensors:
    pair_q_t [LQ, P], pair_ref_t [NL, P].

    s10: swdev.ssw_score_packed's [10, P] int32 rows.  Pairs covered by
    the all-M diag certificate / overflowed / degenerate are masked done
    (their rows come back zero; the host never consumes them).  Entries
    are uint8 — op in bits 0..1, run length (<= 63) in bits 2..7; longer
    runs split across entries, which the native consumer's adjacent-run
    merge (native/swalign.cpp::finish_alignment) reassembles exactly.

    Returns (ops [P, n_entries] uint8, status [P] int8).
    """
    LQ = pair_q_t.shape[0]
    score1, ref_end, query_end = s10[0], s10[1], s10[2]
    ref_begin, query_begin = s10[5], s10[6]
    ovf = s10[8] != 0
    diag = s10[9] != 0
    degen = (s10[0] == 0) | (s10[1] < 0)
    need = ~(diag | ovf | degen)
    ents, status, _ = _tb_core_t(
        pair_q_t.astype(jnp.int32), query_begin, query_end,
        pair_ref_t.astype(jnp.int32), ref_begin, ref_end, score1,
        m_max=LQ, n_entries=n_entries, need=need, run_cap=63)
    return ents.astype(jnp.uint8), status


@partial(jax.jit, static_argnames=("m_max", "n_entries"))
def _banded_tb_jit(read_codes, query_begin, query_end, ref_codes,
                   ref_begin, ref_end, score1, m_max: int, n_entries: int):
    """Row-major entry: transposes once and defers to _tb_core_t."""
    return _tb_core_t(read_codes.astype(jnp.int32).T, query_begin,
                      query_end, ref_codes.astype(jnp.int32).T,
                      ref_begin, ref_end, score1, m_max, n_entries)


def _tb_core_t(read_tt, query_begin, query_end, ref_tt,
               ref_begin, ref_end, score1, m_max: int, n_entries: int,
               need=None, run_cap: int = 0):
    """Transposed inputs: read_tt [LQ, P], ref_tt [NL, P] int32 — the
    fused path builds pairs in this layout, skipping the relayouts."""
    LQ = read_tt.shape[0]
    P = read_tt.shape[1]
    NL = ref_tt.shape[0]
    qb = query_begin.astype(jnp.int32)
    m = (query_end - query_begin + 1).astype(jnp.int32)
    rb = ref_begin.astype(jnp.int32)
    r = (ref_end - ref_begin + 1).astype(jnp.int32)
    score1 = score1.astype(jnp.int32)

    read_t = _shift_sub(read_tt.astype(jnp.int32), qb, m_max)
    sub_ref = _shift_sub(ref_tt.astype(jnp.int32), rb, NL).T   # [P, NL]

    max_len = jnp.maximum(m, r)
    bw0 = jnp.abs(r - m) + 1
    # band doubling as a FIXED-length scan: bw doubles at most
    # ceil(log2(max_len)) + 1 times before 2*bw > max_len stops it
    n_passes = max(1, (max(m_max, NL) - 1).bit_length() + 1)
    done0 = jnp.zeros((P,), bool) if need is None else ~need

    def body(c, _):
        bw, done = c
        best, _ = _fill_pass(read_t, sub_ref, m, r, bw, m_max, False)
        now = (best >= score1) | (2 * bw > max_len)
        bw = jnp.where(done | now, bw, 2 * bw)
        return (bw, done | now), None

    (bw_f, _), _ = jax.lax.scan(
        body, (bw0, done0), None, length=n_passes)
    _, dirs = _fill_pass(read_t, sub_ref, m, r, bw_f, m_max, True)
    dirs = dirs.transpose(0, 2, 1)               # -> [m_max, NL, P]
    # flat [m_max * NL * P] for the walk's 1D gather
    flat = dirs.reshape(-1)

    # run-length traceback walk, all pairs in lock-step; each step
    # consumes one full CIGAR run (precomputed in the fill)
    p_idx = jnp.arange(P, dtype=jnp.int32)

    def step(carry, _):
        i, j, failed, ndone = carry
        active = ~ndone & ~failed
        g = flat[(jnp.clip(i, 0, m_max - 1) * NL
                  + jnp.clip(j, 0, NL - 1)) * P + p_idx].astype(jnp.int32)
        dh = g & 7
        rl = g >> 3
        bad = active & ((dh == 0) | (dh > 5))
        mv = active & ~bad
        op = jnp.where(dh == 1, OP_M, jnp.where(dh <= 3, OP_I, OP_D))
        # caps: the oracle's loop condition (i >= 0 && j > 0) before
        # every step bounds how much of the run is consumed; hitting a
        # cap exits the walk (runs never resume mid-way)
        cap = jnp.where(dh == 1, jnp.minimum(i + 1, j),
                        jnp.where(dh <= 3, i + 1, j))
        ln = jnp.minimum(rl, cap)
        if run_cap:
            # uint8-entry mode: split long runs; the per-cell run chains
            # are suffix-closed, so the next gather lands mid-run with
            # exactly the remainder precomputed
            ln = jnp.minimum(ln, run_cap)
        i = jnp.where(mv & (op != OP_D), i - ln, i)
        j = jnp.where(mv & (op != OP_I), j - ln, j)
        failed = failed | bad
        ndone = ndone | ~((i >= 0) & (j > 0)) | failed
        ent = jnp.where(mv, op | (ln << 2), 0)
        return (i, j, failed, ndone), ent.astype(jnp.int16)

    ndone0 = ~((m - 1 >= 0) & (r - 1 > 0))
    if need is not None:
        ndone0 = ndone0 | ~need
    init = (m - 1, r - 1, jnp.zeros((P,), bool), ndone0)
    (_, _, failed, ndone), ents = jax.lax.scan(
        step, init, None, length=n_entries)
    # rle_overflow: still walking after n_entries -> host runs its own
    # banded DP for these pairs (dev_fail == 2)
    status = jnp.where(failed, 1, jnp.where(~ndone, 2, 0)).astype(jnp.int8)
    return ents.T, status, bw_f                  # ents [P, n_entries]


def banded_traceback_batch(read_codes, query_begin, query_end,
                           ref_codes, ref_begin, ref_end, score1):
    """Device banded DP + run-length traceback for a batch of scored
    pairs.

    read_codes [P, LQ] int8 0..4, ref_codes [P, NL] int8; begin/end are
    the device score pass's matched subregion bounds (inclusive), score1
    the target score.  Returns (ops [P, N_ENTRIES] int16 — backward-order
    run-length entries, op in bits 0..1 (1=M 2=I 3=D), length in bits
    2..14, 0 past the end — and status [P] int8: 0 = ops valid,
    1 = traceback failed (oracle flag=1), 2 = entry budget exceeded (the
    caller must run the host banded DP for these pairs)).  The caller
    feeds ops to native/swalign.cpp (hrm_ssw_finish_batch dev_ops), which
    merges the runs exactly like its own walk would.
    """
    return banded_traceback_dispatch(read_codes, query_begin, query_end,
                                     ref_codes, ref_begin, ref_end, score1)


def banded_traceback_dispatch(read_codes, query_begin, query_end,
                              ref_codes, ref_begin, ref_end, score1):
    """Enqueue without synchronizing (same contract as
    swdev.ssw_score_dispatch): returns device arrays (ops, status)."""
    LQ = int(read_codes.shape[1])
    ops, status, _ = _banded_tb_jit(
        jnp.asarray(read_codes), jnp.asarray(query_begin),
        jnp.asarray(query_end), jnp.asarray(ref_codes),
        jnp.asarray(ref_begin), jnp.asarray(ref_end),
        jnp.asarray(score1), m_max=LQ, n_entries=N_ENTRIES)
    return ops, status


def banded_traceback_collect(dev):
    ops, status = dev
    return np.asarray(ops), np.asarray(status)
