"""Batched on-device SSW score pass (STEP-2 fine alignment, device side).

Lane-exact, closed-form reformulation of the striped byte-mode
Smith-Waterman pass (reference: src/ssw.c:197-398 sw_sse2_byte, driven from
src/gpu/mappinghandler.cu:560-595).  The observable semantics to match are
those of align/sw.py::_striped_pass (golden-verified against the compiled
reference SSW): the striped E-lag makes maxColumn[] depend on segLen and
lane count, so the 16 uint8 lanes are simulated faithfully — but the two
sequential inner loops of the scalar algorithm are collapsed into closed
forms so each genome-window column costs O(1) vector ops instead of
O(segLen * lanes) scalar steps:

  main j-loop   the only loop-carried value is vF, and its recurrence
                vf_{j+1} = max(vf_j - gapE, pre_j - gapO, 0) is a max-plus
                prefix scan  =>  vf_j = max(cummax(pre_t + gapE*t)[j-1]
                                             - gapO - gapE*(j-1), 0).
  lazy-F loop   within one pass vF only decays (no H feedback), so the vF
                seen at (pass kk, row j, lane k) is
                max(vf_init[k-kk] - (kk-1)*segLen - j, 0).  With
                B = base(kk)[k] = vf_init[k-kk] - (kk-1)*segLen and
                C = cummax_kk(B), the early-exit predicate
                "vf_next > max(h_upd - gapO, 0)" reduces to
                T > max(H[j,k] + j, j + 3) where T = B + 2 if B >= C-1
                else -inf; the first (kk, j) in lex order with any lane
                true is found with one argmax.

Layout: all state is kept pairs-minor ([segs, lanes, P]), so the batch is
the contiguous axis and the 16 SSE lanes are an outer axis.  Everything is int32 arithmetic (the uint8 bias/saturation
semantics are emulated exactly); pairs whose score saturates
(score1 + bias >= 255) are flagged and the caller re-runs them through the
host word-mode path, exactly as ssw_align does (align/sw.py:379-388).

The reverse pass (begin positions, ssw.c:877-886) runs the same kernel on
the reversed read prefix with descending columns and terminate = score1;
early-exit semantics are reproduced with a per-pair `stopped` flag.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

LANES = 16          # byte-mode SSE lanes (ssw.c sw_sse2_byte)
GAP_OPEN = 3
GAP_EXTEND = 1
MATCH = 2
MISMATCH = 2
BIAS = MISMATCH     # byte-mode bias = -min(score_matrix)
SAT = 255

_BIG = np.int32(0x3FFFFFFF)  # np, not jnp: a module-level jnp
# constant initializes the device backend at import time, wedging the
# platform choice (dryrun_multichip must pick CPU before first init)


def _pass_batched(read_at, pre_mask, pos, seg_len, ref_t, ref_len,
                  terminate, ref_dir: int, n_cols: int,
                  want_max_column: bool):
    """The striped byte-mode pass over a batch, pairs-minor layout.

    read_at  [S, 16, P] int32  read codes at each striped position
    pre_mask [S, 16, P] bool   pos < read_len
    pos      [S, 16, P] int32  striped position map (j + k*segLen)
    seg_len  [P] int32
    ref_t    [n_cols, P] int32 ref codes, column-major
    ref_len  [P] int32
    terminate[P] int32

    Returns (best, end_ref, end_read, max_column [n_cols, P] or None,
    overflowed), all [P] unless noted.
    """
    S = read_at.shape[0]
    P = read_at.shape[2]
    j_col = jax.lax.broadcasted_iota(jnp.int32, (S, 1, 1), 0)
    arow = j_col < seg_len[None, None, :]                    # [S,1,P]
    # gather-free row selections: one-hot masks (ROADMAP D8: re-measure a
    # plain gather)
    oh_last = (j_col == jnp.maximum(seg_len - 1, 0)[None, None, :])  # [S,1,P]
    kk2 = jax.lax.broadcasted_iota(jnp.int32, (LANES, 1), 0)

    def column(h_prev, e_old, ref_base):
        """One column; ref_base [P].  Returns (h_fin, e_new, colmax)."""
        match = (read_at == ref_base[None, None, :]) & \
                (ref_base < 4)[None, None, :]
        p = jnp.where(pre_mask,
                      jnp.where(match, MATCH + BIAS, -MISMATCH + BIAS),
                      BIAS)
        # vh_in[0] = lane-shift(h_prev[segLen-1]); vh_in[j>0] = h_prev[j-1]
        last = jnp.max(jnp.where(oh_last, h_prev, 0), axis=0)  # [16,P]
        row0 = jnp.concatenate(
            [jnp.zeros((1, P), jnp.int32), last[:-1]], axis=0)
        vh_in = jnp.concatenate([row0[None], h_prev[:-1]], axis=0)

        a = jnp.maximum(jnp.minimum(vh_in + p, SAT) - BIAS, 0)
        pre = jnp.where(arow, jnp.maximum(a, e_old), 0)

        g = pre + j_col                                       # gapE = 1
        run = jax.lax.cummax(g, axis=0)
        vf = jnp.concatenate(
            [jnp.zeros((1, LANES, P), jnp.int32),
             run[:-1] - GAP_OPEN - (j_col[1:] - 1)], axis=0)
        vf = jnp.maximum(vf, 0)
        h_main = jnp.where(arow, jnp.maximum(pre, vf), 0)
        e_new = jnp.where(
            arow, jnp.maximum(jnp.maximum(e_old - GAP_EXTEND, 0),
                              jnp.maximum(h_main - GAP_OPEN, 0)), 0)
        run_last = jnp.max(jnp.where(oh_last, run, 0), axis=0)  # [16,P]
        vf_init = jnp.maximum(
            run_last - GAP_OPEN - (seg_len - 1)[None, :], 0)  # [16,P]

        # lazy-F, full propagation.  Farrar's early exit is EXACT: when it
        # fires (all lanes vF <= max(h - gapO, 0) at some row), every
        # correction the remaining passes would apply is dominated by the
        # main loop's F chain seeded from that h (gapO >= gapE), so the
        # final h equals running all LANES-1 passes to completion.  The
        # completed propagation collapses to a per-lane cummax: the source
        # lane s reaches lane k after k-s passes with decay
        # (k-s-1)*segLen + j, hence
        #   corr[j, k] = max_{s<k}(vf_init[s] + s*segLen)
        #                - (k-1)*segLen - j.
        # (Replaces the exit-point search, which built a [16,S,16,P]
        # tensor per column and dominated the pass; bit-identical —
        # goldens + adversarial fuzz in tests/test_swdev.py.)
        g2 = vf_init + kk2 * seg_len[None, :]                 # [16,P]
        cmax = jax.lax.cummax(g2, axis=0)
        prev = jnp.concatenate(
            [jnp.full((1, P), -_BIG, jnp.int32), cmax[:-1]], axis=0)
        corr = prev - (kk2 - 1) * seg_len[None, :]            # [16,P]
        h_fin = jnp.where(
            arow, jnp.maximum(h_main, jnp.maximum(corr[None] - j_col, 0)),
            0)
        colmax = jnp.max(h_fin, axis=(0, 1))
        return h_fin, e_new, colmax

    def body(carry, t):
        h_prev, e_old, best, end_ref, snap, stopped, overflowed = carry
        if ref_dir == 0:
            i = jnp.broadcast_to(t, (P,))
            ref_base = ref_t[t]
        else:
            i = ref_len - 1 - t
            ref_base = ref_t[t]   # ref_t pre-reversed per pair by the caller
        in_range = (i >= 0) & (i < ref_len)
        active = in_range & ~stopped

        h_fin, e_new, colmax = column(h_prev, e_old, ref_base)

        improved = active & (colmax > best)
        ovf_now = improved & (colmax + BIAS >= SAT)
        take_end = improved & ~ovf_now
        best_n = jnp.where(improved, colmax, best)
        end_ref_n = jnp.where(take_end, i, end_ref)
        snap_n = jnp.where(take_end[None, None, :], h_fin, snap)
        mc = jnp.where(active, colmax, 0)
        stopped_n = stopped | ovf_now | (active & (colmax == terminate))
        h_out = jnp.where(active[None, None, :], h_fin, h_prev)
        e_out = jnp.where(active[None, None, :], e_new, e_old)
        ys = mc if want_max_column else jnp.int32(0)
        return ((h_out, e_out, best_n, end_ref_n, snap_n, stopped_n,
                 overflowed | ovf_now), ys)

    init = (jnp.zeros((S, LANES, P), jnp.int32),
            jnp.zeros((S, LANES, P), jnp.int32),
            jnp.zeros((P,), jnp.int32), jnp.full((P,), -1, jnp.int32),
            jnp.full((S, LANES, P), -1, jnp.int32),
            jnp.zeros((P,), bool), jnp.zeros((P,), bool))
    (_, _, best, end_ref, snap, _, overflowed), mc = jax.lax.scan(
        body, init, jnp.arange(n_cols, dtype=jnp.int32))

    # end_read: smallest striped position holding `best` in the snapshot
    # (ssw.c:344-350); inactive rows were snapped as -1 and never match a
    # best > 0; an all-zero snapshot (best 0) reproduces the host's scan.
    cand = jnp.where(snap == best[None, None, :], pos, _BIG)
    read_len_m1 = jnp.max(jnp.where(pre_mask, pos, 0), axis=(0, 1))
    end_read = jnp.minimum(jnp.min(cand, axis=(0, 1)), read_len_m1)

    overflowed = overflowed | (best + BIAS >= SAT)
    best = jnp.where(overflowed, SAT, best)
    max_column = mc if want_max_column else None
    return best, end_ref, end_read, max_column, overflowed


def _striped_select(read_t, seg_len, S: int, lq: int):
    """read_at[j, k] = read_t[j + k*seg_len] without per-pair gathers.

    seg_len has at most ceil(lq/16) distinct values, so the striped
    permutation is materialized once per value as a STATIC row gather
    (a plain data movement) and selected per pair, instead of a
    per-element dynamic gather (ROADMAP D8: re-measure one).
    """
    P = read_t.shape[1]
    out = jnp.zeros((S, LANES, P), jnp.int32)
    for s in range(1, S + 1):
        idx = (np.arange(S)[:, None] + np.arange(LANES)[None, :] * s)
        idx = np.minimum(idx, lq - 1).reshape(-1)
        gat = read_t[idx].reshape(S, LANES, P)
        out = jnp.where((seg_len == s)[None, None, :], gat, out)
    return out


def _shift_rows_up(x, sh, fill):
    """out[t] = x[t + sh] (per-pair sh >= 0) via log-step select+roll —
    replaces per-pair reversal gathers (same trick as bandtb._shift_sub)."""
    n = int(x.shape[0])
    sh = sh.astype(jnp.int32)
    for b in range(max(1, (n - 1).bit_length())):
        step = 1 << b
        if step >= n:
            break
        shifted = jnp.concatenate(
            [x[step:], jnp.full((step,) + x.shape[1:], fill, x.dtype)],
            axis=0)
        x = jnp.where((sh & step).astype(bool)[None, :], shifted, x)
    return x


def _striped_layout_t(read_t, read_len, lq):
    """[LQ, P] transposed reads -> striped [S, 16, P] tensors.

    The transposed form is the NATIVE one — every consumer below works in
    [L, P]; accepting read_t directly lets the fused STEP-2 path build its
    pair tensors transposed at the source and skip the [P, L] -> [L, P]
    relayouts."""
    S = (lq + LANES - 1) // LANES
    P = read_t.shape[1]
    seg_len = (read_len + LANES - 1) // LANES
    j3 = jax.lax.broadcasted_iota(jnp.int32, (S, LANES, P), 0)
    k3 = jax.lax.broadcasted_iota(jnp.int32, (S, LANES, P), 1)
    pos = j3 + k3 * seg_len[None, None, :]
    pre_mask = pos < read_len[None, None, :]
    read_at = _striped_select(read_t.astype(jnp.int32), seg_len, S, lq)
    read_at = jnp.where(pre_mask, read_at, 4)
    return read_at, pre_mask, pos, seg_len


def _striped_layout(read_codes, read_len, lq):
    """[P, LQ] reads -> striped [S, 16, P] code/pos/mask tensors."""
    return _striped_layout_t(read_codes.astype(jnp.int32).T, read_len, lq)


def _forward_t(read_t, read_len, ref_tt, ref_len, mask_len, n_cols: int):
    """Forward byte-mode pass, transposed inputs (read_t [LQ, P] int32,
    ref_tt [>=n_cols, P] int32).  Same returns as ssw_forward_batch."""
    read_len = read_len.astype(jnp.int32)
    ref_len = ref_len.astype(jnp.int32)
    mask_len = mask_len.astype(jnp.int32)
    lq = read_t.shape[0]
    P = read_t.shape[1]
    read_at, pre_mask, pos, seg_len = _striped_layout_t(read_t, read_len,
                                                        lq)
    ref_t = ref_tt[:n_cols]
    best, end_ref, end_read, max_column, ovf = _pass_batched(
        read_at, pre_mask, pos, seg_len, ref_t, ref_len,
        jnp.full((P,), SAT, jnp.int32), 0, n_cols, True)

    # second-best outside the masked window (byte quirk: second range starts
    # one PAST the edge, ssw.c:367-381)
    i_idx = jax.lax.broadcasted_iota(jnp.int32, (n_cols, 1), 0)
    lo = jnp.maximum(0, end_ref - mask_len)[None, :]
    hi = jnp.minimum(ref_len, end_ref + mask_len)[None, :]
    allowed = ((i_idx < lo) | (i_idx >= hi + 1)) & (i_idx < ref_len[None, :])
    masked = jnp.where(allowed, max_column, -1)
    s2 = jnp.max(masked, axis=0)
    ref_end2 = jnp.where(s2 > 0, jnp.argmax(masked, axis=0).astype(jnp.int32),
                         0)
    score2 = jnp.maximum(s2, 0)
    # maskLen < 15 -> no second-best reported (ssw.c:385-392)
    score2 = jnp.where(mask_len >= 15, score2, 0)
    ref_end2 = jnp.where(mask_len >= 15, ref_end2, -1)
    return {"score1": best, "ref_end": end_ref, "query_end": end_read,
            "score2": score2, "ref_end2": ref_end2, "overflowed": ovf}


@partial(jax.jit, static_argnames=("n_cols",))
def ssw_forward_batch(read_codes, read_len, ref_codes, ref_len, mask_len,
                      n_cols: int):
    """Forward byte-mode pass for a batch of pairs.

    read_codes [P, LQ] int8 (0..4), read_len [P], ref_codes [P, LR] int8,
    ref_len [P], mask_len [P].  n_cols: static column count (>= max ref_len).

    Returns dict of [P] arrays: score1, ref_end, query_end, score2,
    ref_end2, overflowed.  Pairs with overflowed=True must be re-run on the
    host word-mode path (ssw_align falls back the same way).
    """
    return _forward_t(read_codes.astype(jnp.int32).T, read_len,
                      ref_codes.astype(jnp.int32).T, ref_len, mask_len,
                      n_cols)


def _reverse_t(read_t, ref_tt, score1, ref_end, query_end, n_cols: int):
    """Reverse byte-mode pass, transposed inputs: begin positions
    (ssw.c:877-886).  Aligns reversed read[:query_end+1] against
    ref[:ref_end+1] with descending columns and terminate = score1.

    Returns dict of [P] arrays: ref_begin, query_begin, flag2 (score1 >
    rev_score, the reference's "missed small part" flag), overflowed.
    """
    score1 = score1.astype(jnp.int32)
    ref_end = ref_end.astype(jnp.int32)
    query_end = query_end.astype(jnp.int32)
    lq = read_t.shape[0]
    # reversed prefix: rev[t] = read[query_end - t] for t <= query_end.
    # Static flip + per-pair row shift (rev[t] = flip[t + lq-1-qe]) in
    # place of a per-pair take_along_axis reversal.
    t_idx = jax.lax.broadcasted_iota(jnp.int32, (lq, 1), 0)
    qe = query_end[None, :]
    flipped = read_t.astype(jnp.int32)[::-1]                   # [LQ, P]
    rev_t = _shift_rows_up(flipped, lq - 1 - query_end, jnp.int32(4))
    rev_t = jnp.where(t_idx <= qe, rev_t, 4)                   # [LQ, P]
    rl_rev = query_end + 1
    fl_rev = ref_end + 1

    S = (lq + LANES - 1) // LANES
    P = read_t.shape[1]
    seg_len = (rl_rev + LANES - 1) // LANES
    j3 = jax.lax.broadcasted_iota(jnp.int32, (S, LANES, P), 0)
    k3 = jax.lax.broadcasted_iota(jnp.int32, (S, LANES, P), 1)
    pos = j3 + k3 * seg_len[None, None, :]
    pre_mask = pos < rl_rev[None, None, :]
    read_at = _striped_select(rev_t, seg_len, S, lq)
    read_at = jnp.where(pre_mask, read_at, 4)

    # pre-reverse ref columns per pair: column t of the reverse scan reads
    # ref[ref_end - t]; same flip + per-pair shift (columns past ref_end
    # are inactive in the pass, so the fill never reaches a result)
    ref_flip = ref_tt.astype(jnp.int32)[:n_cols][::-1]         # [LR, P]
    ref_rev_t = _shift_rows_up(ref_flip, n_cols - 1 - ref_end,
                               jnp.int32(4))
    best, end_ref, end_read, _, ovf = _pass_batched(
        read_at, pre_mask, pos, seg_len, ref_rev_t, fl_rev,
        score1, 1, n_cols, False)
    return {"ref_begin": end_ref, "query_begin": query_end - end_read,
            "flag2": score1 > best, "overflowed": ovf}


@partial(jax.jit, static_argnames=("n_cols",))
def ssw_reverse_batch(read_codes, read_len, ref_codes, score1, ref_end,
                      query_end, n_cols: int):
    """Row-major wrapper of _reverse_t (see there)."""
    del read_len  # the reversed prefix length comes from query_end
    return _reverse_t(read_codes.astype(jnp.int32).T,
                      ref_codes.astype(jnp.int32).T, score1, ref_end,
                      query_end, n_cols)


def _diag_fastpath_flag(read_t, ref_tt, score1, ref_begin, ref_end,
                        query_begin, query_end, overflowed, n_cols: int):
    """all-M traceback certificate (the banded-DP bypass).
    Transposed inputs: read_t [LQ, P], ref_tt [>=n_cols, P] int32.

    Claim: if the matched subregions have EQUAL lengths (m == r) and the
    gapless diagonal score  S = sum_k score(read[qb+k], ref[rb+k])  equals
    score1, then the reference's banded traceback (ssw.c:595-790, oracle
    align/sw.py::_banded_cigar) is exactly m 'M' ops — so the CIGAR is
    soft-clips + the =/X rewrite of the diagonal, no DP needed.

    Proof sketch (each step per band iteration, any band width >= 1):
      (a) banded h <= unbanded h pointwise (out-of-band reads of h/e/f as 0
          only lower the clamped quantities the cells consume), and any
          subregion path is a path of the full strings, so
          banded_best <= score1.
      (b) h[i,i] >= h[i-1,i-1] + s_i (the diagonal candidate t2 is always
          in band for bw >= 1), hence h[i,i] >= prefix_i by induction.
      (c) if at some diagonal cell the gap branch won STRICTLY
          (t1 > t2, the only way d_h != 1 given the <= tie rule), then
          h[i,i] > prefix_i and chaining (b) to the corner gives
          h[m-1,m-1] > S = score1 — contradicting (a).
    So every visited diagonal cell has d_h == 1 and the corner-to-(0,*)
    walk stays on the diagonal.  (Also by (b) banded_best >= S = score1,
    so the band never doubles.)  The flag is computed on device so the
    host never runs the banded DP for these pairs (the vast majority:
    substitution-only alignments, i.e. everything without an indel).
    """
    lq = read_t.shape[0]
    P = read_t.shape[1]
    m = query_end - query_begin + 1
    r = ref_end - ref_begin + 1
    # shifted_ref[a] = ref[a + delta], delta = ref_begin - query_begin in
    # [-(lq-1), n_cols-1]; barrel-shift (log2 select+roll) instead of a
    # per-pair gather
    pad = jnp.full((lq, P), 4, jnp.int32)
    x = jnp.concatenate([pad, ref_tt.astype(jnp.int32)[:n_cols], pad],
                        axis=0)                      # index c = a + delta + lq
    size = int(x.shape[0])
    sh = (ref_begin - query_begin + lq).astype(jnp.int32)  # in [1, lq+n_cols)
    bits = max(1, (size - 1).bit_length())
    for b in range(bits):
        step = 1 << b
        if step >= size:
            break
        x = jnp.where((sh & step).astype(bool)[None, :],
                      jnp.roll(x, -step, axis=0), x)
    read_t = read_t.astype(jnp.int32)                       # [LQ, P]
    a_idx = jax.lax.broadcasted_iota(jnp.int32, (lq, 1), 0)
    active = (a_idx >= query_begin[None, :]) & (a_idx <= query_end[None, :])
    ref_at = x[:lq]
    s = jnp.where((read_t == ref_at) & (read_t < 4), MATCH, -MISMATCH)
    diag_sum = jnp.sum(jnp.where(active, s, 0), axis=0)
    return ((m == r) & (diag_sum == score1) & ~overflowed
            & (score1 > 0) & (ref_end >= 0))


def ssw_score_packed_t(read_t, read_len, ref_tt, ref_len, mask_len,
                       n_cols: int):
    """Forward + reverse pass fused over TRANSPOSED pair tensors
    (read_t [LQ, P], ref_tt [LR, P] int32) — the fused STEP-2 path builds
    its pairs in this layout at the source, eliminating every
    [P,128]->[128,P] relayout the row-major API pays.  ONE packed [10, P]
    int32 output; rows: score1, ref_end, query_end, score2, ref_end2,
    ref_begin, query_begin, flag2, overflowed(fwd|rev), diag."""
    fwd = _forward_t(read_t, read_len, ref_tt, ref_len, mask_len, n_cols)
    rev = _reverse_t(read_t, ref_tt, fwd["score1"], fwd["ref_end"],
                     fwd["query_end"], n_cols)
    ovf = fwd["overflowed"] | rev["overflowed"]
    diag = _diag_fastpath_flag(read_t, ref_tt, fwd["score1"],
                               rev["ref_begin"], fwd["ref_end"],
                               rev["query_begin"], fwd["query_end"],
                               ovf, n_cols)
    return jnp.stack([
        fwd["score1"], fwd["ref_end"], fwd["query_end"], fwd["score2"],
        fwd["ref_end2"], rev["ref_begin"], rev["query_begin"],
        rev["flag2"].astype(jnp.int32),
        ovf.astype(jnp.int32), diag.astype(jnp.int32)], axis=0)


@partial(jax.jit, static_argnames=("n_cols",))
def ssw_score_packed(read_codes, read_len, ref_codes, ref_len, mask_len,
                     n_cols: int):
    """Row-major wrapper of ssw_score_packed_t (see there)."""
    return ssw_score_packed_t(read_codes.astype(jnp.int32).T, read_len,
                              ref_codes.astype(jnp.int32).T, ref_len,
                              mask_len, n_cols)


def ssw_score_dispatch(read_codes, read_len, ref_codes, ref_len, mask_len):
    """Enqueue one score chunk; returns the device [9, P] packed result
    WITHOUT synchronizing — callers dispatch every chunk first, then
    collect, so H2D/compute/D2H of successive chunks overlap (the
    reference's 2-stream pipelining, gpuminhasherconstruction.cu:89-108)."""
    n_cols = int(ref_codes.shape[1])
    return ssw_score_packed(
        jnp.asarray(read_codes), jnp.asarray(read_len),
        jnp.asarray(ref_codes), jnp.asarray(ref_len),
        jnp.asarray(mask_len), n_cols)


def ssw_score_collect(packed_dev):
    """Fetch + unpack one dispatched chunk (see ssw_score_dispatch)."""
    packed = np.asarray(packed_dev)
    fallback = packed[8].astype(bool)
    degenerate = (packed[0] == 0) | (packed[1] < 0)
    return {
        "score1": packed[0], "score2": packed[3],
        "ref_end": packed[1], "ref_end2": packed[4],
        "query_end": packed[2], "ref_begin": packed[5],
        "query_begin": packed[6],
        "flag": np.where(packed[7] != 0, 2, 0).astype(np.int32),
        "degenerate": degenerate,
        "host_fallback": fallback,
        "diag": packed[9].astype(bool),
    }


def ssw_score_batch(read_codes, read_len, ref_codes, ref_len, mask_len):
    """Full device score pass: forward + reverse, host-side convenience.

    All inputs numpy; returns a dict of numpy arrays with score1, score2,
    ref_end, ref_end2, query_end, ref_begin, query_begin, flag
    (0 ok / 2 begin-missing, matching s_align flag semantics) and
    host_fallback (bool: byte-mode saturation -> caller must use the host
    word path for these pairs).
    """
    return ssw_score_collect(ssw_score_dispatch(
        read_codes, read_len, ref_codes, ref_len, mask_len))
