"""Shifted Hamming Distance against extended genome windows (device / JAX).

Re-derivation of the reference's SHD stage (reference:
src/gpu/hammingdistancekernels.cu:132-263 + window generation
include/gpu/windowgenerationkernels.cuh:17-48):

  * the anchor is the candidate genome window extended left/right by
    readLength/2 with the reference's quirk-compatible clamping (left
    extension is all-or-nothing: zero whenever extension >= window position);
  * the read is slid across every full-overlap shift in both orientations
    (forward first, then reverse-complement), hamming distance per shift;
  * strictly-smaller score wins, ties keep the earlier (orientation, shift);
  * orientation becomes None when best > trunc(readLen * maxHammingPercent)
    or when the read is longer than the anchor (score = readLen, shift = 0).

Instead of the reference's per-pair popcount loop with early exit, all shifts
are evaluated exactly — the result is the exact minimum, so early-exit
semantics are preserved by construction.  Two formulations, bit-identical:
  * shd_pairs               — masked one-hot correlation scan over base
    codes (the plain reference; tests only)
  * shd_pairs_packed_planes — production path: word-aligned gathers from
    the pre-packed genome planes (ops/bitplanes.py), per-read plane
    packing, sub-word offset folded into the shift range, and the
    bit-plane popcount running argmin shd_best.  The three_n flag
    switches the per-orientation CT/GA collapsed spaces.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import bitplanes

# Orientation codes (reference: include/alignmentorientation.hpp:4)
FORWARD = 1
REVERSE_COMPLEMENT = 2
NONE = 3

_BIG = np.int32(0x3FFFFFFF)  # np, not jnp: a module-level jnp
# constant initializes the device backend at import time, wedging the
# platform choice (dryrun_multichip must pick CPU before first init)


class ExtendedWindows(NamedTuple):
    start: jnp.ndarray    # [P] int32 chromosome-local start of extended window
    left: jnp.ndarray     # [P] int32 applied left extension
    length: jnp.ndarray   # [P] int32 extended-window length


def extended_window_location(pos: jnp.ndarray, chrom_len: jnp.ndarray,
                             read_len: jnp.ndarray, window_size: int
                             ) -> ExtendedWindows:
    """Vectorized computeWindowLocation (windowgenerationkernels.cuh:17-48)."""
    ext = read_len // 2
    left = jnp.where(ext < pos, ext, 0)
    end = pos + window_size
    in_bounds = end <= chrom_len
    right = jnp.where(
        in_bounds,
        jnp.where(end + ext < chrom_len, ext, chrom_len - end),
        0)
    length = window_size + left + right - jnp.where(in_bounds, 0, end - chrom_len)
    return ExtendedWindows(start=pos - left, left=left, length=length)


class ShdParams(NamedTuple):
    window_size: int
    max_ext_len: int       # static bound: window_size + max_read_len
    max_read_len: int
    max_hamming_percent: float


class ShdResult(NamedTuple):
    hamming: jnp.ndarray      # [P] int32 best score
    shift: jnp.ndarray        # [P] int32 shift in ORIGINAL window coordinates
    orientation: jnp.ndarray  # [P] int8 FORWARD / REVERSE_COMPLEMENT / NONE


def _onehot(bases: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """[..., L] int -> [..., L, 4] bf16 one-hot, zeros where masked out."""
    oh = jax.nn.one_hot(bases, 4, dtype=jnp.bfloat16)
    return oh * mask[..., None].astype(jnp.bfloat16)


def _collapse(bases: jnp.ndarray, space: str) -> jnp.ndarray:
    """Bisulfite collapse of base codes: 'ct' C->T, 'ga' G->A, '' none."""
    if space == "ct":
        return jnp.where(bases == 1, 3, bases).astype(bases.dtype)
    if space == "ga":
        return jnp.where(bases == 2, 0, bases).astype(bases.dtype)
    return bases


def orientation_spaces(three_n: bool, undirectional: bool):
    """Collapse space of (orientation 0 = read, orientation 1 = its RC):
    directional 3N compares CT(read) with CT(anchor) and GA(RC(read)) with
    GA(anchor); the mirrored PBAT spaces swap the two."""
    if not three_n:
        return "", ""
    return ("ga", "ct") if undirectional else ("ct", "ga")


@partial(jax.jit, static_argnames=("params", "three_n", "undirectional"))
def shd_pairs(genome_concat: jnp.ndarray,
              anchor_global_start: jnp.ndarray,
              anchor_length: jnp.ndarray,
              anchor_left: jnp.ndarray,
              read_bases: jnp.ndarray,
              read_len: jnp.ndarray,
              pair_valid: jnp.ndarray,
              params: ShdParams,
              three_n: bool = False,
              undirectional: bool = False) -> ShdResult:
    """SHD for P (extended-window, read) pairs.

    Args:
      genome_concat: [G] int8 whole-genome base codes (chromosomes
        concatenated; windows never cross chromosome bounds by construction).
      anchor_global_start: [P] int32 start of each extended window in
        genome_concat (chromosome offset already applied).
      anchor_length / anchor_left: from extended_window_location.
      read_bases: [P, Lr] int8; read_len: [P] int32; pair_valid: [P] bool.
      three_n / undirectional: per-orientation collapse spaces
        (orientation_spaces), as in shd_pairs_packed_planes.
    """
    p, lr = read_bases.shape
    assert lr == params.max_read_len
    s_max = params.max_ext_len - 1 + 1  # shifts 0 .. max_ext_len-1 (masked)
    pad_len = params.max_ext_len + lr
    sp0, sp1 = orientation_spaces(three_n, undirectional)

    pos_iota = jnp.arange(pad_len, dtype=jnp.int32)[None, :]
    gather_idx = jnp.clip(
        anchor_global_start[:, None] + pos_iota, 0, genome_concat.shape[0] - 1)
    anchor = jnp.take(genome_concat, gather_idx)                  # [P, pad]
    anchor_mask = pos_iota < anchor_length[:, None]
    anchor_oh = jnp.stack(
        [_onehot(_collapse(anchor, sp), anchor_mask) for sp in (sp0, sp1)],
        axis=1)                                                   # [P,2,pad,4]

    read_iota = jnp.arange(lr, dtype=jnp.int32)[None, :]
    read_mask = read_iota < read_len[:, None]
    read_oh = _onehot(_collapse(read_bases, sp0), read_mask)      # [P, Lr, 4]
    # reverse complement: rc[i] = 3 - read[len-1-i]
    src = jnp.clip(read_len[:, None] - 1 - read_iota, 0, lr - 1)
    rc_bases = 3 - jnp.take_along_axis(read_bases.astype(jnp.int32), src, axis=1)
    rc_oh = _onehot(_collapse(rc_bases, sp1), read_mask)

    both_oh = jnp.stack([read_oh, rc_oh], axis=1)                 # [P, 2, Lr, 4]

    def body(_, s):
        window = jax.lax.dynamic_slice_in_dim(anchor_oh, s, lr, axis=2)
        m = jnp.einsum("pola,pola->po", window, both_oh,
                       preferred_element_type=jnp.float32)        # [P, 2]
        return None, m

    _, matches = jax.lax.scan(body, None,
                              jnp.arange(s_max, dtype=jnp.int32))  # [S, P, 2]
    matches = matches.transpose(1, 2, 0)                          # [P, 2, S]
    hamming = read_len[:, None, None] - matches.astype(jnp.int32)
    return finalize_shd(hamming, anchor_length, anchor_left, read_len,
                        pair_valid, params)


def finalize_shd(hamming: jnp.ndarray, anchor_length: jnp.ndarray,
                 anchor_left: jnp.ndarray, read_len: jnp.ndarray,
                 pair_valid: jnp.ndarray, params: ShdParams) -> ShdResult:
    """Shared argmin/threshold post-processing over a [P, 2, S] matrix.

    Tie rules mirror the reference kernel's iteration order (forward before
    RC, shifts ascending, strictly-smaller score wins)."""
    p, _, s_max = hamming.shape
    shift_iota = jnp.arange(s_max, dtype=jnp.int32)[None, None, :]
    shift_ok = shift_iota <= (anchor_length - read_len)[:, None, None]
    hamming = jnp.where(shift_ok, hamming, _BIG)

    flat = hamming.reshape(p, 2 * s_max)
    best_idx = jnp.argmin(flat, axis=1)          # first occurrence of the min
    best = jnp.take_along_axis(flat, best_idx[:, None], axis=1)[:, 0]
    best_orient = (best_idx // s_max).astype(jnp.int32)
    best_shift = (best_idx % s_max).astype(jnp.int32)

    too_long = read_len > anchor_length
    threshold = (read_len.astype(jnp.float32)
                 * jnp.float32(params.max_hamming_percent)).astype(jnp.int32)
    good = (best <= threshold) & ~too_long & pair_valid

    orientation = jnp.where(
        good,
        jnp.where(best_orient == 0, FORWARD, REVERSE_COMPLEMENT),
        NONE).astype(jnp.int8)
    score = jnp.where(too_long, read_len, best)
    shift_out = jnp.where(too_long, 0, best_shift) - jnp.where(
        too_long, 0, anchor_left)
    return ShdResult(hamming=score.astype(jnp.int32),
                     shift=shift_out.astype(jnp.int32),
                     orientation=orientation)


def finalize_shd_from_best(best4: jnp.ndarray, anchor_length: jnp.ndarray,
                           anchor_left: jnp.ndarray, read_len: jnp.ndarray,
                           pair_valid: jnp.ndarray,
                           params: ShdParams) -> ShdResult:
    """Post-processing from per-orientation running-argmin kernel output.

    Equivalent to finalize_shd over the full matrix: forward wins orientation
    ties (strict < selects RC), the kernel already kept the earliest shift.
    """
    best_f, shift_f, best_r, shift_r = (best4[:, 0], best4[:, 1],
                                        best4[:, 2], best4[:, 3])
    use_rc = best_r < best_f
    best = jnp.where(use_rc, best_r, best_f)
    best_shift = jnp.where(use_rc, shift_r, shift_f)

    too_long = read_len > anchor_length
    threshold = (read_len.astype(jnp.float32)
                 * jnp.float32(params.max_hamming_percent)).astype(jnp.int32)
    good = (best <= threshold) & ~too_long & pair_valid
    orientation = jnp.where(
        good, jnp.where(use_rc, REVERSE_COMPLEMENT, FORWARD),
        NONE).astype(jnp.int8)
    score = jnp.where(too_long, read_len, best)
    shift_out = jnp.where(too_long, 0, best_shift) - jnp.where(
        too_long, 0, anchor_left)
    return ShdResult(hamming=score.astype(jnp.int32),
                     shift=shift_out.astype(jnp.int32),
                     orientation=orientation)


def pack_read_planes(read_bases: jnp.ndarray, read_len: jnp.ndarray,
                     three_n: bool, undirectional: bool = False):
    """Per-READ plane packing for the packed SHD: returns
    (hi_o0, lo_o0, hi_o1, lo_o1, mask) each [N, wr].  Orientation 0 is the
    read, orientation 1 its reverse complement, each in its collapse space
    (orientation_spaces: CT / GA in 3N mode, mirrored GA / CT for the PBAT
    strands with undirectional=True — a G->A-in-read-space read matches
    the window's GA space forward, and its RC matches the CT space).  Pack
    once per read, then gather rows per pair — kcap x cheaper than packing
    per pair."""
    n, lr = read_bases.shape
    wr = (lr + 31) // 32
    read_iota = jnp.arange(lr, dtype=jnp.int32)[None, :]
    src = jnp.clip(read_len[:, None] - 1 - read_iota, 0, lr - 1)
    rc_bases = (3 - jnp.take_along_axis(
        read_bases.astype(jnp.int32), src, axis=1)).astype(jnp.int8)
    sp0, sp1 = orientation_spaces(three_n, undirectional)
    hi0, lo0, mask = bitplanes.pack_bitplanes(_collapse(read_bases, sp0),
                                              read_len, wr)
    hi1, lo1, _ = bitplanes.pack_bitplanes(_collapse(rc_bases, sp1),
                                           read_len, wr)
    return hi0, lo0, hi1, lo1, mask


@partial(jax.jit, static_argnames=("n_shifts", "wa", "wr"))
def shd_best(anchor_hi, anchor_lo, read_hi_both, read_lo_both,
             read_mask, shift_bounds, n_shifts: int, wa: int, wr: int):
    """Best (score, shift) per orientation for P pairs.

    anchor planes [P, 2, wa] int32 (one plane set per orientation), read
    planes [P, 2, wr], mask [P, wr], shift_bounds [P, 2] int32 inclusive
    (min_shift, max_shift).  Every shift s = 32*w + b of the n_shifts
    range is scored at once — the [P, 2, S] matrix — then reduced with the
    reference kernel's rules: strictly smaller wins, so ties keep the
    earliest shift; a pair with an empty range reports (_BIG, min_shift).
    Returns [P, 4] int32 rows (best_f, shift_f, best_r, shift_r).
    """
    p = anchor_hi.shape[0]
    assert anchor_hi.shape[1:] == (2, wa)
    n_words = (n_shifts + 31) // 32
    assert n_words + wr <= wa, "anchor planes too short for the shift range"
    widx = np.arange(n_words)[:, None] + np.arange(wr + 1)[None, :]
    bit = jnp.arange(32, dtype=jnp.uint32)[:, None]               # [32, 1]
    up = jnp.uint32(32) - jnp.maximum(bit, jnp.uint32(1))

    def shifted(a):
        """[P, 2, wa] -> anchor words at every shift, [P, 2, W, 32, wr]."""
        a = a.astype(jnp.uint32)[:, :, widx][:, :, :, None, :]
        hi = jnp.where(bit == 0, jnp.uint32(0), a[..., 1:] << up)
        return (a[..., :wr] >> bit) | hi

    def per_read(x):
        return x.astype(jnp.uint32)[:, :, None, None, :]

    mm = ((shifted(anchor_hi) ^ per_read(read_hi_both))
          | (shifted(anchor_lo) ^ per_read(read_lo_both))) \
        & read_mask.astype(jnp.uint32)[:, None, None, None, :]
    ham = jnp.sum(jax.lax.population_count(mm).astype(jnp.int32), axis=-1)
    ham = ham.reshape(p, 2, n_words * 32)
    s = jnp.arange(n_words * 32, dtype=jnp.int32)[None, None, :]
    lo_s = shift_bounds[:, 0][:, None, None]
    hi_s = shift_bounds[:, 1][:, None, None]
    ham = jnp.where((s >= lo_s) & (s <= hi_s), ham, _BIG)
    best = jnp.min(ham, axis=2)                                   # [P, 2]
    shift = jnp.argmin(ham, axis=2).astype(jnp.int32)
    shift = jnp.where(best >= _BIG, shift_bounds[:, :1], shift)
    return jnp.stack([best[:, 0], shift[:, 0], best[:, 1], shift[:, 1]],
                     axis=1)


@partial(jax.jit, static_argnames=("params", "three_n", "undirectional"))
def shd_pairs_packed_planes(genome_hi, genome_lo,
                            anchor_global_start, anchor_length, anchor_left,
                            r_hi_f, r_lo_f, r_hi_r, r_lo_r, mask,
                            read_len, pair_valid, params: ShdParams,
                            three_n: bool = False,
                            undirectional: bool = False) -> ShdResult:
    """Packed SHD over pairs whose read planes are already packed/gathered.

    The genome lives as hi/lo plane words (bitplanes.pack_genome_planes),
    so the anchor fetch gathers wa consecutive int32 WORDS per pair, and
    the sub-word offset bit0 = start % 32 folds into the shift range
    (reported shifts are shifted back).  undirectional=True mirrors the
    window collapses to match pack_read_planes(undirectional=True)."""
    p, wr = r_hi_f.shape
    # max valid shift = bit0 + (anchor_len - read_len) <= 31 + window_size
    # (anchor_len <= window_size + 2*(read_len//2) <= window_size + read_len)
    s_max = params.window_size + 32
    wa_pad = (s_max - 1) // 32 + wr + 2

    word0 = jnp.maximum(anchor_global_start, 0) >> 5
    bit0 = (anchor_global_start & 31).astype(jnp.int32)
    nwords_genome = genome_hi.shape[0]
    widx = jnp.clip(
        word0[:, None] + jnp.arange(wa_pad, dtype=jnp.int32)[None, :],
        0, nwords_genome - 1)
    a_hi = jnp.take(genome_hi, widx)                       # [P, wa_pad]
    a_lo = jnp.take(genome_lo, widx)
    collapse = {"": lambda h, l: (h, l), "ct": bitplanes.collapse_planes_ct,
                "ga": bitplanes.collapse_planes_ga}
    planes = [collapse[sp](a_hi, a_lo)
              for sp in orientation_spaces(three_n, undirectional)]

    max_shift = bit0 + (anchor_length - read_len)
    bounds = jnp.stack([bit0, max_shift], axis=1)
    a_hi2 = jnp.stack([planes[0][0], planes[1][0]], axis=1)
    a_lo2 = jnp.stack([planes[0][1], planes[1][1]], axis=1)
    r_hi = jnp.stack([r_hi_f, r_hi_r], axis=1)
    r_lo = jnp.stack([r_lo_f, r_lo_r], axis=1)
    best4 = shd_best(a_hi2, a_lo2, r_hi, r_lo, mask, bounds, s_max,
                     wa_pad, wr)
    best4 = best4.at[:, 1].add(-bit0)
    best4 = best4.at[:, 3].add(-bit0)
    return finalize_shd_from_best(best4, anchor_length, anchor_left,
                                  read_len, pair_valid, params)
