"""Coarse-mapping engine: genome window index in HBM, reads stream through.

This is the device-side inversion of the reference's STEP 1 (reference:
src/gpu/main_gpu.cu:431-856 WindowBatchProcessor): instead of indexing the
reads and streaming genome windows, the minhash index of genome WINDOWS lives
in device memory and read batches stream through

    signatures -> CSR probe -> min-table-hits vote -> SHD vs extended windows
    -> per-read best (argmin by (hamming, genome order)).

Candidate (window, read) pair sets are identical to the reference's because
signature equality is symmetric; the reference's read-side key dropping is
reproduced via the dropped-keys mask (index/minhash_index.py).  The per-read
best-hit merge becomes a LOCAL reduction (each read's candidates arrive in one
batch), eliminating the reference's serial host merge
(main_gpu.cu:777-821).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ProgramOptions
from ..index import minhash_index as mi
from ..io.genome import Genome
from ..ops import minhash, shd

SENTINEL = np.uint32(0xFFFFFFFF)
_BIG = np.int32(0x3FFFFFFF)  # np, not jnp: a module-level jnp
# constant initializes the device backend at import time, wedging the
# platform choice (dryrun_multichip must pick CPU before first init)


@dataclasses.dataclass
class WindowTable:
    """Device-resident genome geometry + per-window metadata."""
    genome_concat: jnp.ndarray   # [G] int8 all chromosomes concatenated
    win_pos: jnp.ndarray         # [W] int32 window start within chromosome
    win_chrom: jnp.ndarray       # [W] int32 chromosome id
    chrom_offset: jnp.ndarray    # [C] int32 chromosome start in genome_concat
    chrom_len: jnp.ndarray       # [C] int32
    num_windows: int
    genome_hi: jnp.ndarray = None  # [G/32] int32 bit planes (packed genome)
    genome_lo: jnp.ndarray = None


@dataclasses.dataclass
class CoarseResults:
    """Per-read best hits (reference MappedRead arrays, mappedread.cuh:6-12)."""
    orientation: np.ndarray        # [N] int8 (1=fwd, 2=rc, 3=none)
    hamming: np.ndarray            # [N] int32
    shift: np.ndarray              # [N] int32
    chromosome_id: np.ndarray      # [N] int32
    position: np.ndarray           # [N] int32
    global_window_id: np.ndarray   # [N] uint32 (SENTINEL when unmapped)
    stats: Dict[str, int]
    # full-width window ordinal (region-sharded >2 Gbp genomes exceed
    # uint32); None when the mapper's ordinals fit global_window_id
    global_window_id64: Optional[np.ndarray] = None
    # bisulfite strand space per read: 0 = directional C->T, 1 = mirrored
    # PBAT G->A (only set under opts.undirectional; see config)
    bs_strand: Optional[np.ndarray] = None


def build_window_table(genome: Genome, segments=None,
                       opts: Optional[ProgramOptions] = None) -> WindowTable:
    """Stage the genome (or only `segments` of it, plus margins) on device.

    With segments, chrom_offset holds VIRTUAL per-segment offsets
    (staged-start minus true start position), so gathers of
    `chrom_offset[seg] + true_position` land in the staged bases while the
    extension math keeps seeing true positions and true chromosome lengths
    (bit-identical to an uncut mapper; parallel/segments.py docstring).
    """
    if segments is not None:
        from ..parallel.segments import segment_base_span
        margin = opts.max_read_length
        offsets = np.zeros(len(segments), dtype=np.int64)
        lens = np.zeros(len(segments), dtype=np.int32)
        parts = []
        cursor = 0
        for s, seg in enumerate(segments):
            lo, hi = segment_base_span(genome, opts, seg, margin)
            parts.append(genome.bases[seg.chrom_id][lo:hi].astype(np.int8))
            offsets[s] = cursor - lo
            lens[s] = genome.chromosome_length(seg.chrom_id)
            cursor += hi - lo
        total = cursor
        chrom_lens = lens
    else:
        offsets = np.zeros(genome.num_chromosomes, dtype=np.int64)
        total = 0
        for c in range(genome.num_chromosomes):
            offsets[c] = total
            total += genome.chromosome_length(c)
        parts = [genome.bases[c].astype(np.int8)
                 for c in range(genome.num_chromosomes)]
        chrom_lens = np.array(
            [genome.chromosome_length(c)
             for c in range(genome.num_chromosomes)], dtype=np.int32)
    assert total < 2**31, (
        "a single mapper stages <2 Gbp; larger genomes go through "
        "RegionShardedMapper's window partition (parallel/region_sharded.py)")
    concat = np.concatenate(parts)
    from ..ops import bitplanes
    concat_dev = jnp.asarray(concat)
    g_hi, g_lo = bitplanes.pack_genome_planes(concat_dev)
    return WindowTable(
        genome_hi=g_hi, genome_lo=g_lo,
        genome_concat=concat_dev,
        win_pos=None, win_chrom=None,  # filled by build_engine
        chrom_offset=jnp.asarray(offsets.astype(np.int32)),
        chrom_len=jnp.asarray(chrom_lens),
        num_windows=0)


def plan_num_hash_functions(opts: ProgramOptions, num_windows: int) -> int:
    """Size the table count to the --memHashtables budget.

    The reference adds hash tables only while they fit the memory budget
    and errors under mustUseAllHashfunctions if the request cannot be met
    (reference: src/gpu/gpuminhasherconstruction.cu:123-147, options
    src/options.cpp:113-140).  Upper-bound estimate per table: every
    window contributes one value (4B) and at worst a unique key
    (4B key + 4B offset + ~4B bucket/metadata)."""
    f = opts.num_hash_functions
    if opts.memory_for_hashtables <= 0:
        return f
    tables_per_func = 2 if opts.three_n_seeding else 1
    per_table = 16 * max(num_windows, 1) + 4096
    max_f = int(opts.memory_for_hashtables // (per_table * tables_per_func))
    if max_f < f:
        if opts.must_use_all_hash_functions:
            raise MemoryError(
                f"memHashtables budget fits only {max_f} of "
                f"{f} hash tables but mustUseAllHashfunctions is set")
        max_f = max(1, max_f)
        print(f"memHashtables: can use {max_f} of {f} hash tables")
        return max_f
    return f


def coarse_pairs_best(ids, read_bases, read_len, opts, lr, genome_hi,
                      genome_lo, win_pos, win_chrom, chrom_offset,
                      chrom_len):
    """Voted candidate ids -> SHD -> per-read best hit.

    The shared tail of the coarse step (inverted engine and sharded step;
    traced inside their jits/shard_map).  ids: [B, K] uint32 window
    ordinals, SENTINEL-padded.  Honors opts.shd_pairs_per_read_budget:
    valid (read, candidate) pairs are cumsum-compacted before the SHD
    window/plane gathers, with overflow beyond batch*budget counted in
    pair_drops (those pairs score as SHD-rejected).

    Returns (out_ori, out_ham, out_shift, out_chrom, out_pos, best_gwin,
    out_strand [all [B] int32], has [B] bool, ori [B, K], pair_drops
    scalar).  out_strand: 0 = directional (C->T read space), 1 = mirrored
    PBAT space (only under opts.undirectional).
    """
    b, kcap = ids.shape
    gwin = ids.reshape(-1)
    pair_valid = gwin != jnp.uint32(0xFFFFFFFF)
    gwin_full = jnp.where(pair_valid, gwin, 0).astype(jnp.int32)
    nk = b * kcap
    kb = opts.shd_pairs_per_read_budget
    compact = 0 < kb < kcap
    if compact:
        # pair compaction: at real candidate densities most [B, K] slots
        # are padding — SHD (and its window/plane gathers) runs only on
        # the compacted valid pairs.
        budget = b * kb
        iota_p = jnp.arange(nk, dtype=jnp.int32)
        vi = pair_valid.astype(jnp.int32)
        rank_p = jnp.cumsum(vi) - 1
        n_valid = jnp.sum(vi)
        slot = jnp.where(pair_valid & (rank_p < budget), rank_p, budget)
        pair_sel = jnp.zeros((budget + 1,), jnp.int32).at[slot].set(
            iota_p, mode="drop")[:budget]
        sel_valid = jnp.arange(budget, dtype=jnp.int32) < n_valid
        pair_drops = jnp.maximum(n_valid - budget, 0)
    else:
        pair_sel = jnp.arange(nk, dtype=jnp.int32)
        sel_valid = pair_valid
        pair_drops = jnp.int32(0)

    gwin_c = jnp.take(gwin_full, pair_sel)
    ridx = pair_sel // kcap
    pos = jnp.take(win_pos, gwin_c)
    chrom = jnp.take(win_chrom, gwin_c)
    clen = jnp.take(chrom_len, chrom)
    coff = jnp.take(chrom_offset, chrom)

    rl_rep = jnp.take(read_len, ridx)
    loc = shd.extended_window_location(pos, clen, rl_rep, opts.window_size)
    params = shd.ShdParams(
        window_size=opts.window_size,
        max_ext_len=opts.window_size + opts.max_read_length,
        max_read_len=lr,
        max_hamming_percent=opts.max_hamming_percent)

    def eval_pairs(undirectional):
        hi0, lo0, hi1, lo1, pmask = shd.pack_read_planes(
            read_bases, read_len, opts.three_n_seeding,
            undirectional=undirectional)
        return shd.shd_pairs_packed_planes(
            genome_hi, genome_lo, coff + loc.start, loc.length, loc.left,
            jnp.take(hi0, ridx, axis=0), jnp.take(lo0, ridx, axis=0),
            jnp.take(hi1, ridx, axis=0), jnp.take(lo1, ridx, axis=0),
            jnp.take(pmask, ridx, axis=0), rl_rep,
            sel_valid, params, three_n=opts.three_n_seeding,
            undirectional=undirectional)

    res = eval_pairs(False)
    if opts.undirectional:
        # mirrored (PBAT) collapse spaces; per pair keep the lower-hamming
        # evaluation, ties prefer the directional space (deterministic)
        res_u = eval_pairs(True)
        better_u = (res_u.orientation != shd.NONE) & (
            (res.orientation == shd.NONE) | (res_u.hamming < res.hamming))
        res_ham = jnp.where(better_u, res_u.hamming, res.hamming)
        res_shf = jnp.where(better_u, res_u.shift, res.shift)
        res_ori = jnp.where(better_u, res_u.orientation, res.orientation)
        res_strand = better_u.astype(jnp.int32)
    else:
        res_ham, res_shf, res_ori = res.hamming, res.shift, res.orientation
        res_strand = jnp.zeros_like(res.hamming)

    if compact:
        tgt = jnp.where(sel_valid, pair_sel, nk)
        ham_f = jnp.zeros((nk,), res_ham.dtype).at[tgt].set(
            res_ham, mode="drop")
        shf_f = jnp.zeros((nk,), res_shf.dtype).at[tgt].set(
            res_shf, mode="drop")
        ori_f = jnp.full((nk,), shd.NONE, res_ori.dtype).at[
            tgt].set(res_ori, mode="drop")
        strand_f = jnp.zeros((nk,), jnp.int32).at[tgt].set(
            res_strand, mode="drop")
    else:
        ham_f, shf_f, ori_f, strand_f = res_ham, res_shf, res_ori, res_strand

    ham = ham_f.reshape(b, kcap)
    shf = shf_f.reshape(b, kcap)
    ori = ori_f.reshape(b, kcap)
    strand = strand_f.reshape(b, kcap)
    good = ori != shd.NONE

    # best per read: min hamming, then earliest window (ids ascend =>
    # genome order; reference keeps first strictly-smaller hit,
    # main_gpu.cu:800-812)
    ham_m = jnp.where(good, ham, _BIG)
    min_h = jnp.min(ham_m, axis=1, keepdims=True)
    slot_key = jnp.where(good & (ham_m == min_h),
                         gwin_full.reshape(b, kcap), _BIG)
    best_slot = jnp.argmin(slot_key, axis=1)
    has = jnp.any(good, axis=1)

    take = lambda m: jnp.take_along_axis(m, best_slot[:, None], axis=1)[:, 0]
    out_ori = jnp.where(has, take(ori).astype(jnp.int32), shd.NONE)
    out_ham = jnp.where(has, take(ham), 0)
    out_shift = jnp.where(has, take(shf), 0)
    out_strand = jnp.where(has, take(strand), 0)
    best_gwin_i = take(gwin_full.reshape(b, kcap))
    out_chrom = jnp.where(has, jnp.take(win_chrom, best_gwin_i), 0)
    out_pos = jnp.where(has, jnp.take(win_pos, best_gwin_i), 0)
    return (out_ori, out_ham, out_shift, out_chrom, out_pos, best_gwin_i,
            has, ori, out_strand, pair_drops)


@partial(jax.jit, static_argnames=("ws",))
def window_bases_device(genome_concat: jnp.ndarray, gstart: jnp.ndarray,
                        ws: int) -> jnp.ndarray:
    """Gather [n, ws] window bases from the resident genome on device.

    Replaces the host-staged superbatch gather (the reference streams
    window bases from host memory, gpuminhasherconstruction.cu:168-214;
    here the genome is already device-resident, so the index build only
    uploads the [n] int32 start offsets)."""
    idx = gstart[:, None] + jnp.arange(ws, dtype=jnp.int32)[None, :]
    idx = jnp.minimum(idx, genome_concat.shape[0] - 1)
    return jnp.take(genome_concat, idx.reshape(-1)).reshape(idx.shape)


def build_genome_s2(genome: Genome, opts: ProgramOptions,
                    segments=None) -> np.ndarray:
    """[G/8] uint32 nibble-packed STEP-2 genome codes 0..4 (N preserved).

    With segments the staged spans and virtual chromosome offsets
    replicate build_window_table's exactly, so table.chrom_offset indexes
    this array too (STEP-2 windows [pos, pos+ws) always lie inside a
    segment's staged span — segment_base_span covers last window + ws)."""
    from ..align import sw as _sw
    if segments is not None:
        from ..parallel.segments import segment_base_span
        margin = opts.max_read_length
        parts = []
        for seg in segments:
            lo, hi = segment_base_span(genome, opts, seg, margin)
            parts.append(_sw.TRANSLATE[
                np.asarray(genome.seqs_ascii[seg.chrom_id])[lo:hi]])
    else:
        parts = [_sw.TRANSLATE[np.asarray(a)] for a in genome.seqs_ascii]
    codes = np.concatenate(parts).astype(np.uint32)
    pad = (-len(codes)) % 8
    if pad:
        codes = np.concatenate([codes, np.full(pad, 4, np.uint32)])
    packed = np.zeros(len(codes) // 8, np.uint32)
    for j in range(8):
        packed |= codes[j::8] << (4 * j)
    return packed


def fused_step2_scores(opts, chrom_offset, chrom_len, genome_s2,
                       read_bases, read_len, packed):
    """Traced tail of the scored step: build the STEP-2 3N pairs from the
    coarse results, run the device score pass, and (by default) the banded
    CIGAR traceback — everything in the caller's dispatch.  Pair layout
    and 3N/strand handling mirror pipeline/mapping.py::_run_cssw_device
    exactly (pairs [2i] = 3N query, [2i+1] = 3N RC query, same 3N window
    ref; PBAT G->A collapse only for strand==1 FORWARD reads).  Returns
    (scores [10, 2B] int16, tb_ops [2B, E] uint8, tb_status [2B] int8)."""
    from ..ops import encode, swdev
    ws = opts.window_size
    b, lq = read_bases.shape
    ori = packed[:, 0]
    chrom = packed[:, 3]
    pos = packed[:, 4]
    strand = packed[:, 6]
    rc = encode.revcomp_bases(read_bases, read_len)
    is_rc = (ori == 2)[:, None]
    # the pair tensors are built TRANSPOSED ([L, pairs]) — the layout
    # every striped-SW/traceback consumer natively wants, so no relayout
    # follows
    fwd_t = jnp.where(is_rc, rc, read_bases).astype(jnp.int8).T  # [lq, b]
    rcq_t = jnp.where(is_rc, read_bases, rc).astype(jnp.int8).T
    sc_t = ((strand != 0) & (ori == 1))[None, :]

    def collapse(m):
        ct = jnp.where(m == 1, jnp.int8(3), m)
        if not opts.undirectional:
            return ct
        ga = jnp.where(m == 2, jnp.int8(0), m)
        return jnp.where(sc_t, ga, ct)

    clen = jnp.take(chrom_len, chrom)
    wl = jnp.where(pos + ws < clen, ws, clen - pos).astype(jnp.int32)
    base = jnp.take(chrom_offset, chrom).astype(jnp.int32) + pos
    # packed-nibble window gather + 3-step barrel realign (no per-base
    # gather): words w0..w0+ws/8 then shift by (base & 7) nibbles
    nw = ws // 8 + 1
    w0 = base >> 3
    widx = jnp.minimum(w0[None, :] + jnp.arange(nw, dtype=jnp.int32)[:, None],
                       genome_s2.shape[0] - 1)                  # [nw, b]
    words_t = jnp.take(genome_s2, widx.reshape(-1)).reshape(nw, b)
    shifts = (jnp.arange(nw * 8, dtype=jnp.uint32) % 8 * 4)[:, None]
    codes_t = (jnp.repeat(words_t, 8, axis=0) >> shifts) & 0xF   # [nw*8, b]
    off = (base & 7)[None, :]
    for s in (4, 2, 1):
        codes_t = jnp.where((off & s).astype(bool),
                            jnp.roll(codes_t, -s, axis=0), codes_t)
    win_t = codes_t[:ws].astype(jnp.int8)
    iw = jax.lax.broadcasted_iota(jnp.int32, (ws, 1), 0)
    win_t = jnp.where(iw < wl[None, :], win_t, jnp.int8(4))
    q3n_t = collapse(fwd_t)
    rcq3n_t = collapse(rcq_t)
    ref3n_t = collapse(win_t)
    pair_q_t = jnp.stack([q3n_t, rcq3n_t], axis=2).reshape(lq, 2 * b)
    pair_ref_t = jnp.repeat(ref3n_t, 2, axis=1)
    rl32 = read_len.astype(jnp.int32)
    pair_rl = jnp.repeat(rl32, 2)
    pair_fl = jnp.repeat(wl, 2)
    pair_ml = jnp.repeat(jnp.maximum(15, rl32 // 2), 2)
    packed10 = swdev.ssw_score_packed_t(
        pair_q_t.astype(jnp.int32), pair_rl,
        pair_ref_t.astype(jnp.int32), pair_fl, pair_ml, ws)
    if getattr(opts, "step2_device_traceback", True):
        # the banded CIGAR traceback runs in the SAME dispatch, with no
        # host round trip; uint8 run-length entries keep the extra D2H to
        # n_entries bytes/pair
        from ..ops import bandtb
        tb_ops, tb_status = bandtb.fused_traceback_t(pair_q_t, pair_ref_t,
                                                     packed10)
    else:
        tb_ops = jnp.zeros((2 * b, 1), jnp.uint8)
        tb_status = jnp.zeros((2 * b,), jnp.int8)
    return packed10.astype(jnp.int16), tb_ops, tb_status


class CoarseMapper:
    def __init__(self, genome: Genome, opts: ProgramOptions,
                 sig_batch: int = 4096, load_index_from: str = "",
                 build_index: bool = True, segments=None,
                 build_direct_probe: bool = True):
        opts.validate()
        self.opts = opts
        self.genome = genome
        # segments: map only these window spans (parallel/segments.py);
        # results report SEGMENT ids in chromosome_id and LOCAL window
        # ordinals in global_window_id — RegionShardedMapper converts back.
        self.segments = segments
        # cuckoo tables cost ~2.5x the CSR index in HBM; callers packing
        # several regions onto one device turn them off
        self._build_direct_probe = build_direct_probe
        if segments is not None:
            self.seg_local_base = np.zeros(len(segments) + 1, dtype=np.int64)
            for i, seg in enumerate(segments):
                self.seg_local_base[i + 1] = (
                    self.seg_local_base[i] + seg.num_windows())
        n_win_total = (sum(s.num_windows() for s in segments)
                       if segments is not None else
                       genome.total_num_windows(opts.kmer_length,
                                                opts.window_size))
        self.hash_ids = np.arange(
            plan_num_hash_functions(opts, n_win_total), dtype=np.uint32)
        self._hash_ids_dev = jnp.asarray(self.hash_ids)
        self.table = build_window_table(genome, segments, opts)
        if load_index_from:
            # index artifact (replaces --load-hashtables-from,
            # reference: gpuminhasherconstruction.cu:311-319)
            self.index = mi.CsrIndex.load(load_index_from)
            assert self.index.kmer_length == opts.kmer_length, (
                "loaded index was built with a different k")
            self.index.build_buckets()
            if opts.probe_cap < 1023 and self._build_direct_probe:
                self.index.build_cuckoo()
            win_pos, win_chrom, _ = self._window_geometry()
            self.table.win_pos = jnp.asarray(win_pos)
            self.table.win_chrom = jnp.asarray(win_chrom)
            self.table.num_windows = len(win_pos)
        elif build_index:
            self._build_window_index(sig_batch)
        else:
            # geometry only: the sharded mapper builds its own per-shard
            # index (parallel/sharded.py), never staging it on one device
            win_pos, win_chrom, _ = self._window_geometry()
            self.table.win_pos = jnp.asarray(win_pos)
            self.table.win_chrom = jnp.asarray(win_chrom)
            self.table.num_windows = len(win_pos)
            self.index = None
        self.dropped: Optional[tuple] = None

    def iter_window_superbatch_starts(self, sig_batch: int = 4096):
        """Window-start superbatches for the device-side index build.

        Yields (gstart [n_pad] int32 device offsets into genome_concat,
        lens [n_pad] int32, n) with n_pad a sig_batch multiple; the bases
        themselves are gathered ON DEVICE from the resident genome
        (window_bases_device) — only these small offset arrays cross
        host->device.  Mirrors the reference's bounded-memory insert loop
        (gpuminhasherconstruction.cu:123-242)."""
        opts = self.opts
        win_pos, win_chrom, win_len = self._window_geometry()
        w = len(win_pos)
        chrom_offset = np.asarray(self.table.chrom_offset)
        superbatch = sig_batch * 64
        for s0 in range(0, w, superbatch):
            s1 = min(s0 + superbatch, w)
            n = s1 - s0
            n_pad = ((n + sig_batch - 1) // sig_batch) * sig_batch
            gstart = np.zeros(n_pad, dtype=np.int32)
            gstart[:n] = chrom_offset[win_chrom[s0:s1]] + win_pos[s0:s1]
            lens = np.zeros(n_pad, dtype=np.int32)
            lens[:n] = win_len[s0:s1]
            yield gstart, lens, n

    def iter_window_superbatches(self, sig_batch: int = 4096):
        """Host-staged window base superbatches (oracle/compat path for
        iter_window_superbatch_starts + window_bases_device)."""
        concat = np.asarray(self.table.genome_concat)
        ws = self.opts.window_size
        for gstart, lens, n in self.iter_window_superbatch_starts(sig_batch):
            idx = gstart[:, None].astype(np.int64) + np.arange(ws)[None, :]
            idx = np.minimum(idx, len(concat) - 1)
            yield concat[idx], lens, n

    def save_index(self, path: str) -> None:
        """Window-index artifact (replaces --save-hashtables-to)."""
        self.index.save(path)

    # ------------------------------------------------------------------
    # index construction (device signatures, host CSR build)
    # ------------------------------------------------------------------
    def _window_geometry(self):
        k, ws = self.opts.kmer_length, self.opts.window_size
        pos_l, chrom_l, len_l = [], [], []
        if self.segments is not None:
            # positions/lengths are the TRUE chromosome values; the
            # "chromosome" axis indexes segments (virtual offsets in the
            # window table make the gathers land in the staged bases)
            for s, seg in enumerate(self.segments):
                clen = self.genome.chromosome_length(seg.chrom_id)
                n = seg.num_windows()
                p = (seg.win_start + np.arange(n, dtype=np.int64)) \
                    * self.opts.window_stride
                pos_l.append(p.astype(np.int32))
                chrom_l.append(np.full(n, s, dtype=np.int32))
                len_l.append(np.minimum(clen - p, ws).astype(np.int32))
        else:
            for c in range(self.genome.num_chromosomes):
                clen = self.genome.chromosome_length(c)
                n = self.genome.num_windows_in_chromosome(c, k, ws)
                p = np.arange(n, dtype=np.int64) * self.opts.window_stride
                pos_l.append(p.astype(np.int32))
                chrom_l.append(np.full(n, c, dtype=np.int32))
                len_l.append(np.minimum(clen - p, ws).astype(np.int32))
        return (np.concatenate(pos_l), np.concatenate(chrom_l),
                np.concatenate(len_l))

    def _build_window_index(self, sig_batch: int) -> None:
        opts = self.opts
        win_pos, win_chrom, win_len = self._window_geometry()
        w = len(win_pos)
        self.table.win_pos = jnp.asarray(win_pos)
        self.table.win_chrom = jnp.asarray(win_chrom)
        self.table.num_windows = w

        from ..utils.progress import ProgressReporter
        progress = ProgressReporter(w, label="hash windows",
                                    enabled=opts.show_progress)
        sig_parts = []
        valid_parts = []
        for gstart, lens, n in self.iter_window_superbatch_starts(sig_batch):
            bdev = window_bases_device(
                self.table.genome_concat, jnp.asarray(gstart), opts.window_size)
            ldev = jnp.asarray(lens)
            if opts.three_n_seeding:
                s_ct, v = minhash.minhash_signatures_chunked(
                    jnp.where(bdev == 1, jnp.int8(3), bdev), ldev,
                    opts.kmer_length, self._hash_ids_dev, sig_batch,
                    canonical=False)
                s_ga, _ = minhash.minhash_signatures_chunked(
                    jnp.where(bdev == 2, jnp.int8(0), bdev), ldev,
                    opts.kmer_length, self._hash_ids_dev, sig_batch,
                    canonical=False)
                s = jnp.concatenate([s_ct, s_ga], axis=1)   # [n, 2F]
            else:
                s, v = minhash.minhash_signatures_chunked(
                    bdev, ldev, opts.kmer_length,
                    self._hash_ids_dev, sig_batch)
            sig_parts.append(s[:n])
            valid_parts.append(v[:n])
            progress.add(n)
        if opts.show_progress:
            progress.finish()

        sigs = jnp.concatenate(sig_parts) if len(sig_parts) > 1 else sig_parts[0]
        valid = (jnp.concatenate(valid_parts) if len(valid_parts) > 1
                 else valid_parts[0])
        # window keys are never dropped: in the reference the windows are the
        # queries, and query signatures are never capped.  The CSR build runs
        # entirely on device — signatures never leave HBM.
        self.index = mi.build_csr_index_device(
            sigs, valid, opts.kmer_length, self.hash_ids)
        self.index.build_buckets()
        if opts.probe_cap < 1023 and self._build_direct_probe:
            # direct-probe table (falls back silently to the binary search
            # when the native builder is unavailable)
            self.index.build_cuckoo()

    # ------------------------------------------------------------------
    # read-side key dropping (parity with reference read-index build)
    # ------------------------------------------------------------------
    def prepare_read_drops(self, read_sigs: np.ndarray,
                           read_valid: np.ndarray) -> None:
        """Compute the dropped-keys mask from the full read-signature set.

        Mirrors the reference's GroupByKey value-dropping on its read index
        (groupbykey.hpp:60-67): keys with more than max_results_per_map reads
        are invisible to every query in that table.
        """
        dk, dn = mi.build_dropped_keys(
            read_sigs, read_valid, self.opts.max_results_per_map)
        self.dropped = (jnp.asarray(dk), jnp.asarray(dn))

    # ------------------------------------------------------------------
    # the jitted per-batch mapping step
    # ------------------------------------------------------------------
    def _map_batch(self, read_bases, read_len, read_valid, dropped_keys,
                   dropped_num):
        """Public step wrapper: passes the large resident arrays as jit
        arguments so they are never serialized into compile payloads."""
        t = self.table
        i = self.index
        return self._map_batch_impl(
            i.keys, i.offsets, i.values, i.num_keys, i.bucket_start,
            i.cuckoo_keys, i.cuckoo_payload,
            t.genome_hi, t.genome_lo, t.win_pos, t.win_chrom, t.chrom_offset,
            t.chrom_len, self._hash_ids_dev,
            read_bases, read_len, read_valid, dropped_keys, dropped_num)

    def _map_batch_at(self, all_bases, all_lens, all_valid, start, bsz,
                      dropped_keys, dropped_num, collect_candidates=False,
                      all_limits=None, votes_only=False):
        """Step over a device-resident read pool: one dispatch per batch,
        no per-batch host->device transfers.  All resident arrays go in as
        jit ARGUMENTS (captured constants blow up the compile payload).
        all_limits / votes_only: region mode's genome-wide vote cap
        (_map_batch_impl)."""
        t = self.table
        i = self.index
        return self._map_batch_at_impl(
            i.keys, i.offsets, i.values, i.num_keys, i.bucket_start,
            i.cuckoo_keys, i.cuckoo_payload,
            t.genome_hi, t.genome_lo, t.win_pos, t.win_chrom, t.chrom_offset,
            t.chrom_len, self._hash_ids_dev,
            all_bases, all_lens, all_valid, start, bsz,
            dropped_keys, dropped_num, collect_candidates,
            i.overflow_keys, all_limits, votes_only)

    @partial(jax.jit, static_argnames=("self", "bsz", "collect_candidates",
                                       "votes_only"))
    def _map_batch_at_impl(self, index_keys, index_offsets, index_values,
                           index_num_keys, bucket_start, cuckoo_keys,
                           cuckoo_payload, genome_hi, genome_lo,
                           win_pos, win_chrom, chrom_offset, chrom_len,
                           hash_ids, all_bases, all_lens, all_valid, start,
                           bsz, dropped_keys, dropped_num,
                           collect_candidates=False, overflow_keys=None,
                           all_limits=None, votes_only=False):
        chunk = jax.lax.dynamic_slice_in_dim(all_bases, start, bsz, 0)
        lens = jax.lax.dynamic_slice_in_dim(all_lens, start, bsz, 0)
        valid = jax.lax.dynamic_slice_in_dim(all_valid, start, bsz, 0)
        limit = (None if all_limits is None else
                 jax.lax.dynamic_slice_in_dim(all_limits, start, bsz, 0))
        return self._map_batch_impl(
            index_keys, index_offsets, index_values, index_num_keys,
            bucket_start, cuckoo_keys, cuckoo_payload,
            genome_hi, genome_lo, win_pos, win_chrom,
            chrom_offset, chrom_len, hash_ids,
            chunk, lens, valid, dropped_keys, dropped_num,
            collect_candidates=collect_candidates,
            overflow_keys=overflow_keys, cand_limit=limit,
            votes_only=votes_only)

    @partial(jax.jit, static_argnames=("self", "collect_candidates",
                                       "votes_only"))
    def _map_batch_impl(self, index_keys, index_offsets, index_values,
                        index_num_keys, bucket_start, cuckoo_keys,
                        cuckoo_payload, genome_hi, genome_lo,
                        win_pos, win_chrom, chrom_offset, chrom_len,
                        hash_ids,
                        read_bases: jnp.ndarray, read_len: jnp.ndarray,
                        read_valid: jnp.ndarray, dropped_keys, dropped_num,
                        collect_candidates: bool = False,
                        overflow_keys=None, cand_limit=None,
                        votes_only: bool = False):
        """One batch: signatures -> probe -> vote -> SHD -> per-read best.

        Region mode (parallel/region_sharded.py) applies the vote cap over
        the whole genome in two calls: votes_only=True returns each read's
        voted ids (ascending, the first candidates_per_read_cap) and the
        number that passed; a second call with cand_limit [B] keeps only
        the first cand_limit[i] of read i's ids."""
        opts = self.opts
        b, lr = read_bases.shape
        kcap = opts.candidates_per_read_cap

        if opts.three_n_seeding:
            # both 3N spaces in one fused pass (no revcomp gather; see
            # minhash.signatures_3n_pair)
            sigs, sig_valid = minhash.signatures_3n_pair(
                read_bases, read_len, opts.kmer_length, hash_ids)
        else:
            sigs, sig_valid = minhash.minhash_signatures(
                read_bases, read_len, opts.kmer_length, hash_ids)
        sig_valid = sig_valid & read_valid

        tail_budget = b * opts.probe_tail_budget_per_read
        head_budget = b * getattr(opts, "probe_head_budget_per_read", 0)
        cuckoo_kw = {}
        if cuckoo_keys is not None:
            cuckoo_kw = dict(cuckoo=(cuckoo_keys, cuckoo_payload),
                             cuckoo_bits=self.index.cuckoo_bits,
                             cuckoo_seeds=self.index.cuckoo_seeds)

        def probe(sig_block):
            if tail_budget > 0:
                return mi.probe_tables(
                    index_keys, index_offsets, index_values,
                    index_num_keys, sig_block, sig_valid, opts.probe_cap,
                    dropped_keys=(dropped_keys, dropped_num),
                    bucket_start=bucket_start,
                    probe_steps=self.index.probe_steps, fnc_layout=True,
                    tail_budget=tail_budget, head_budget=head_budget,
                    overflow_keys=overflow_keys, **cuckoo_kw)
            c, cnt = mi.probe_tables(
                index_keys, index_offsets, index_values,
                index_num_keys, sig_block, sig_valid, opts.probe_cap,
                dropped_keys=(dropped_keys, dropped_num),
                bucket_start=bucket_start,
                probe_steps=self.index.probe_steps, fnc_layout=True,
                overflow_keys=overflow_keys, **cuckoo_kw)
            return c, cnt, jnp.int32(0), jnp.int32(0)

        cand, counts, tail_drops, head_drops = probe(sigs)
        if opts.undirectional:
            # PBAT strands: the same 2F window tables probed with the
            # mirrored query spaces — CT(RC read) against the CT tables,
            # GA(read) against the GA tables
            sigs_u, _ = minhash.signatures_3n_pair(
                read_bases, read_len, opts.kmer_length, hash_ids,
                mirror=True)
            cand_u, counts_u, tail_drops_u, head_drops_u = probe(sigs_u)
            cand = jnp.concatenate([cand, cand_u], axis=0)     # [4F, N, C]
            counts = jnp.concatenate([counts, counts_u], axis=0)
            tail_drops = tail_drops + tail_drops_u
            head_drops = head_drops + head_drops_u
        ids, hit_cnt, num_kept = mi.vote_candidates(
            cand.transpose(1, 0, 2), opts.min_table_hits, kcap)
        if votes_only:
            return ids, num_kept
        if cand_limit is not None:
            ids = jnp.where(jnp.arange(kcap)[None, :] < cand_limit[:, None],
                            ids, jnp.uint32(SENTINEL))

        (out_ori, out_ham, out_shift, out_chrom, out_pos, best_gwin_i, has,
         ori, out_strand, pair_drops) = coarse_pairs_best(
            ids, read_bases, read_len, opts, lr, genome_hi, genome_lo,
            win_pos, win_chrom, chrom_offset, chrom_len)
        out_gwin = jnp.where(has, best_gwin_i, -1)  # -1 == SENTINEL bits

        # single packed output: one device->host transfer shape per batch
        packed = jnp.stack(
            [out_ori, out_ham, out_shift, out_chrom, out_pos, out_gwin,
             out_strand],
            axis=1)
        overflow = jnp.stack([jnp.sum(counts > opts.probe_cap),
                              jnp.sum(num_kept > kcap), pair_drops,
                              tail_drops, head_drops])
        if collect_candidates:
            # COUNT_WINDOW_HITS instrumentation (reference:
            # windowhitstatisticcollector.hpp; main_gpu.cu:555-574, 824-852):
            # candidate windows per read after hashing+vote, and the SHD
            # orientation per candidate (None = rejected by SHD)
            return packed, overflow, ids, ori
        return packed, overflow

    # ------------------------------------------------------------------
    # fused STEP-2 scoring: the striped-SW score pass (ops/swdev.py) runs
    # INSIDE the coarse-mapping dispatch, gathering windows from the
    # device-resident genome — no host staging of pair arrays, no extra
    # host round trips (the reference runs STEP 2 as a separate host
    # phase, mappinghandler.cu:383-774).
    # ------------------------------------------------------------------
    supports_fused_scores = True

    def _ensure_genome_s2(self):
        """Device [G] codes 0..4 (N preserved) packed 8 codes / int32.

        STEP-2 refs need N kept distinct (score matrix treats N as
        mismatch; sw.TRANSLATE), unlike genome_concat's 0..3.  Packed
        nibbles: the window gather fetches ws/8 + 1 words per read instead
        of ws bases."""
        if getattr(self, "_genome_s2", None) is None:
            self._genome_s2 = jnp.asarray(
                build_genome_s2(self.genome, self.opts, self.segments))
        return self._genome_s2

    def _step2_scores(self, chrom_offset, chrom_len, genome_s2,
                      read_bases, read_len, packed):
        return fused_step2_scores(self.opts, chrom_offset, chrom_len,
                                  genome_s2, read_bases, read_len, packed)

    @partial(jax.jit, static_argnames=("self", "bsz"))
    def _map_batch_scored_at_impl(self, index_keys, index_offsets,
                                  index_values, index_num_keys, bucket_start,
                                  cuckoo_keys, cuckoo_payload, genome_hi,
                                  genome_lo, win_pos, win_chrom, chrom_offset,
                                  chrom_len, hash_ids, genome_s2,
                                  all_bases, all_lens, all_valid, start, bsz,
                                  dropped_keys, dropped_num,
                                  overflow_keys=None, all_limits=None):
        chunk = jax.lax.dynamic_slice_in_dim(all_bases, start, bsz, 0)
        lens = jax.lax.dynamic_slice_in_dim(all_lens, start, bsz, 0)
        valid = jax.lax.dynamic_slice_in_dim(all_valid, start, bsz, 0)
        limit = (None if all_limits is None else
                 jax.lax.dynamic_slice_in_dim(all_limits, start, bsz, 0))
        packed, overflow = self._map_batch_impl(
            index_keys, index_offsets, index_values, index_num_keys,
            bucket_start, cuckoo_keys, cuckoo_payload,
            genome_hi, genome_lo, win_pos, win_chrom,
            chrom_offset, chrom_len, hash_ids,
            chunk, lens, valid, dropped_keys, dropped_num,
            overflow_keys=overflow_keys, cand_limit=limit)
        scores16, tb_ops, tb_status = self._step2_scores(
            chrom_offset, chrom_len, genome_s2, chunk, lens, packed)
        return packed, overflow, scores16, tb_ops, tb_status

    def _map_batch_scored_at(self, all_bases, all_lens, all_valid, start,
                             bsz, dropped_keys, dropped_num, all_limits=None):
        t = self.table
        i = self.index
        return self._map_batch_scored_at_impl(
            i.keys, i.offsets, i.values, i.num_keys, i.bucket_start,
            i.cuckoo_keys, i.cuckoo_payload,
            t.genome_hi, t.genome_lo, t.win_pos, t.win_chrom, t.chrom_offset,
            t.chrom_len, self._hash_ids_dev, self._ensure_genome_s2(),
            all_bases, all_lens, all_valid, start, bsz,
            dropped_keys, dropped_num, i.overflow_keys, all_limits)

    @partial(jax.jit, static_argnames=("self", "bsz", "n_batches"))
    def _map_pool_scan_impl(self, index_keys, index_offsets, index_values,
                            index_num_keys, bucket_start, cuckoo_keys,
                            cuckoo_payload, genome_hi, genome_lo,
                            win_pos, win_chrom, chrom_offset, chrom_len,
                            hash_ids, all_bases, all_lens, all_valid,
                            bsz, n_batches, dropped_keys, dropped_num):
        """All batches of the device pool in ONE jitted scan (one dispatch,
        one executable) instead of one dispatch per batch
        (_map_reads_device).  Identical results — the scan body IS
        _map_batch_impl."""
        def body(carry, start):
            chunk = jax.lax.dynamic_slice_in_dim(all_bases, start, bsz, 0)
            lens = jax.lax.dynamic_slice_in_dim(all_lens, start, bsz, 0)
            valid = jax.lax.dynamic_slice_in_dim(all_valid, start, bsz, 0)
            packed, overflow = self._map_batch_impl(
                index_keys, index_offsets, index_values, index_num_keys,
                bucket_start, cuckoo_keys, cuckoo_payload,
                genome_hi, genome_lo, win_pos, win_chrom,
                chrom_offset, chrom_len, hash_ids,
                chunk, lens, valid, dropped_keys, dropped_num)
            return carry, (packed, overflow)
        starts = jnp.arange(n_batches, dtype=jnp.int32) * bsz
        _, (packed, overflow) = jax.lax.scan(body, jnp.int32(0), starts)
        return (packed.reshape(n_batches * bsz, packed.shape[2]),
                overflow.sum(axis=0))

    def map_pool_scanned(self, all_bases, all_lens, all_valid, n_pad: int,
                         bsz: int):
        """One-dispatch coarse mapping of a staged read pool (see
        _map_pool_scan_impl).  Returns (packed [n_pad, 7] dev, overflow
        [5] dev)."""
        assert n_pad % bsz == 0
        t = self.table
        i = self.index
        return self._map_pool_scan_impl(
            i.keys, i.offsets, i.values, i.num_keys, i.bucket_start,
            i.cuckoo_keys, i.cuckoo_payload,
            t.genome_hi, t.genome_lo, t.win_pos, t.win_chrom,
            t.chrom_offset, t.chrom_len, self._hash_ids_dev,
            all_bases, all_lens, all_valid, bsz, n_pad // bsz,
            self.dropped[0], self.dropped[1])

    def _map_reads_device(self, all_bases, all_lens, all_valid, n_pad: int,
                          bsz: int, collect_candidates: bool = False,
                          all_limits=None, votes_only: bool = False):
        """Dispatch all batches asynchronously; results stay ON DEVICE.

        Returns (packed [n_pad, 7] device array, overflow [5] device array,
        cand_batches).  Callers that drive several engines (region sharding)
        enqueue every region's work before any host sync, so regions run
        concurrently on their devices.  votes_only=True returns (ids
        [n_pad, candidates_per_read_cap], num_kept [n_pad]) instead;
        all_limits [n_pad] caps each read's candidates (_map_batch_impl)."""
        packed_batches = []
        overflow_batches = []
        cand_batches = []
        for start in range(0, n_pad, bsz):
            outs = self._map_batch_at(
                all_bases, all_lens, all_valid, jnp.int32(start), bsz,
                self.dropped[0], self.dropped[1],
                collect_candidates=collect_candidates,
                all_limits=all_limits, votes_only=votes_only)
            if collect_candidates:
                packed, overflow, c_ids, c_ori = outs
                cand_batches.append((c_ids, c_ori))
            else:
                packed, overflow = outs
            # keep results on device; fetch once at the end
            packed_batches.append(packed)
            overflow_batches.append(overflow)
        all_packed_dev = jnp.concatenate(packed_batches, axis=0)
        if votes_only:
            return all_packed_dev, jnp.concatenate(overflow_batches)
        overflow_dev = jnp.stack(overflow_batches).sum(axis=0)
        return all_packed_dev, overflow_dev, cand_batches

    def _map_reads_device_scored(self, all_bases, all_lens, all_valid,
                                 n_pad: int, bsz: int, all_limits=None):
        """Scored+traceback variant of _map_reads_device: dispatch all
        batches async; everything stays ON DEVICE (callers fetch once).
        Returns (packed [n_pad, 7], overflow [5], scores [10, 2*n_pad]
        int16, tb_ops [2*n_pad, E] uint8, tb_status [2*n_pad] int8)."""
        pk, ov, sc, to, ts = [], [], [], [], []
        for start in range(0, n_pad, bsz):
            p, o, s, t_o, t_s = self._map_batch_scored_at(
                all_bases, all_lens, all_valid, jnp.int32(start), bsz,
                self.dropped[0], self.dropped[1], all_limits=all_limits)
            pk.append(p)
            ov.append(o)
            sc.append(s)
            to.append(t_o)
            ts.append(t_s)
        return (jnp.concatenate(pk, axis=0), jnp.stack(ov).sum(axis=0),
                jnp.concatenate(sc, axis=1), jnp.concatenate(to, axis=0),
                jnp.concatenate(ts, axis=0))

    def stage_reads_device(self, read_bases: np.ndarray,
                           read_lengths: np.ndarray):
        """Upload a read set once, padded to a batchsize multiple."""
        opts = self.opts
        n, lr = read_bases.shape
        if lr < opts.max_read_length:
            read_bases = np.pad(
                read_bases, ((0, 0), (0, opts.max_read_length - lr)))
        bsz = opts.batchsize
        n_pad = ((n + bsz - 1) // bsz) * bsz
        all_bases = jnp.asarray(np.pad(
            read_bases.astype(np.int8), ((0, n_pad - n), (0, 0))))
        all_lens = jnp.asarray(np.pad(
            read_lengths.astype(np.int32), (0, n_pad - n)))
        all_valid = jnp.asarray(np.arange(n_pad) < n)
        return all_bases, all_lens, all_valid, n_pad

    def memory_bytes(self) -> int:
        """Index bytes (uniform driver-reporting hook across mapper kinds)."""
        return self.index.memory_bytes() if self.index is not None else 0

    def _fallback_stats(self) -> Dict[str, int]:
        """Which probe ran: the cuckoo direct probe, or the bit-identical
        binary search it degrades to.  Merged into every
        CoarseResults.stats; the reason prints once."""
        import sys
        stats = {
            "cuckoo_direct_probe": int(
                self.index is not None
                and self.index.cuckoo_keys is not None),
        }
        if not getattr(self, "_warned_fallbacks", False):
            self._warned_fallbacks = True
            reason = (self.index.cuckoo_fallback_reason
                      if self.index is not None else None)
            if reason:
                print(f"note: cuckoo direct probe disabled ({reason}); "
                      f"binary-search probe in use", file=sys.stderr)
        return stats

    def resident_bytes(self) -> int:
        """Device bytes held by the index + staged genome."""
        t = self.table
        total = (self.index.memory_bytes() if self.index is not None else 0)
        for a in (t.genome_concat, t.genome_hi, t.genome_lo, t.win_pos,
                  t.win_chrom, t.chrom_offset, t.chrom_len):
            if a is not None:
                total += a.nbytes
        return total

    def read_pool_size(self, n: int, read_len: int, bsz: int) -> int:
        """Reads per device-pool chunk under the --memTotal budget.

        The reference sizes its device read storage to the leftover of
        memoryTotalLimit after the tables and spills the rest to host,
        streamed in (multigpureadstorage.cuh host overflow + 2-stream
        insert loop).  Here: reads beyond the pool stay in host numpy and
        stream through a bounded device pool."""
        limit = self.opts.memory_total_limit
        n_pad = ((n + bsz - 1) // bsz) * bsz
        if limit <= 0:
            return n_pad
        budget = limit - self.resident_bytes()
        # per staged read: int8 bases row + length + valid + packed result
        # row + SHD read-plane scratch (~4 int32 words per 32 bases per
        # orientation)
        per_read = (self.opts.max_read_length + 4 + 1 + 24
                    + 16 * ((self.opts.max_read_length + 31) // 32))
        pool = int(budget // per_read)
        pool = max(bsz, (pool // bsz) * bsz)
        return min(pool, n_pad)

    def ensure_read_drops(self, read_bases: np.ndarray,
                          read_lengths: np.ndarray,
                          precomputed_sigs: Optional[np.ndarray] = None
                          ) -> None:
        """Dropped-keys mask from the FULL read set.

        The chunked (pipelined) driver must call this over all reads before
        per-chunk map_reads calls: the reference's read-index GroupByKey
        drop rule is a whole-dataset property (groupbykey.hpp:60-67), not a
        per-chunk one.  No-op in 3N mode or when already computed.
        """
        opts = self.opts
        if opts.three_n_seeding or self.dropped is not None:
            return
        n = read_bases.shape[0]
        if precomputed_sigs is None:
            sig_list = []
            val_list = []
            for start in range(0, n, opts.batchsize):
                stop = min(start + opts.batchsize, n)
                chunk = read_bases[start:stop]
                s, v = minhash.minhash_signatures(
                    jnp.asarray(chunk), jnp.asarray(read_lengths[start:stop]),
                    opts.kmer_length, self._hash_ids_dev)
                sig_list.append(np.asarray(s))
                val_list.append(np.asarray(v))
            precomputed_sigs = np.concatenate(sig_list)
            pre_valid = np.concatenate(val_list)
        else:
            pre_valid = read_lengths >= opts.kmer_length
        self.prepare_read_drops(precomputed_sigs, pre_valid)

    def ensure_empty_drops(self) -> None:
        if self.dropped is None:
            f = len(self.hash_ids) * (
                2 if self.opts.three_n_seeding else 1)
            self.dropped = (
                jnp.full((f, 1), jnp.uint32(0xFFFFFFFF), dtype=jnp.uint32),
                jnp.zeros((f,), dtype=jnp.int32))

    def map_reads(self, read_bases: np.ndarray, read_lengths: np.ndarray,
                  precomputed_sigs: Optional[np.ndarray] = None,
                  emulate_read_key_drop: bool = True,
                  collect_candidates: bool = False,
                  with_scores: bool = False):
        """Map all reads (host driver: batches the jitted step).

        read_bases: [N, L] int8 padded; read_lengths: [N] int32.
        with_scores: also run the fused STEP-2 score pass per batch and
        return (CoarseResults, scores [10, 2N] int16) — see _step2_scores.
        """
        opts = self.opts
        n, lr = read_bases.shape
        if with_scores and n == 0:
            empty = np.zeros((10, 0), np.int16)
            if getattr(opts, "step2_device_traceback", True):
                empty = (empty, np.zeros((0, 1), np.uint8),
                         np.zeros((0,), np.int8))
            return self.map_reads(read_bases, read_lengths, precomputed_sigs,
                                  emulate_read_key_drop), empty
        if n == 0:
            return CoarseResults(
                orientation=np.full(0, shd.NONE, dtype=np.int8),
                hamming=np.zeros(0, dtype=np.int32),
                shift=np.zeros(0, dtype=np.int32),
                chromosome_id=np.zeros(0, dtype=np.int32),
                position=np.zeros(0, dtype=np.int32),
                global_window_id=np.zeros(0, dtype=np.uint32),
                stats={"probe_overflow": 0, "vote_overflow": 0,
                       "pair_budget_overflow": 0, "probe_tail_overflow": 0,
                       "probe_head_overflow": 0,
                       **self._fallback_stats()},
                bs_strand=np.zeros(0, dtype=np.int8))
        assert lr <= opts.max_read_length, (
            f"reads longer than max_read_length ({lr} > {opts.max_read_length})")
        if lr < opts.max_read_length:
            read_bases = np.pad(
                read_bases, ((0, 0), (0, opts.max_read_length - lr)))
            lr = opts.max_read_length

        if opts.three_n_seeding:
            # the read-side key-drop emulation is a parity feature of the
            # canonical-kmer configuration; the 3N index has 2F tables and
            # no reference counterpart to emulate
            emulate_read_key_drop = False
        if emulate_read_key_drop and self.dropped is None:
            self.ensure_read_drops(read_bases, read_lengths,
                                   precomputed_sigs)

        if self.dropped is None:
            # no read-key dropping: empty mask
            f = len(self.hash_ids) * (2 if opts.three_n_seeding else 1)
            self.dropped = (
                jnp.full((f, 1), jnp.uint32(0xFFFFFFFF), dtype=jnp.uint32),
                jnp.zeros((f,), dtype=jnp.int32))

        bsz = opts.batchsize
        # upload reads in device-pool chunks; per-batch slicing happens on
        # device (one transfer, not one per batch).  With no --memTotal limit
        # the pool is the whole read set (one upload); under a limit the
        # read set streams through a bounded pool, with the fetch of chunk
        # i overlapping the compute of chunk i+1 (async dispatch) — the
        # reference's 2-stream insert-loop overlap
        # (gpuminhasherconstruction.cu:89-108, 168-214).
        pool_n = self.read_pool_size(n, lr, bsz)
        packed_parts = []
        overflow_parts = []
        score_parts = []
        tb_parts = []
        cand_all = []
        pending = None

        def fetch(chunk):
            (packed_dev, overflow_dev, chunk_n, cand_batches, score_dev,
             tb_dev) = chunk
            packed_parts.append(np.asarray(packed_dev)[:chunk_n])
            overflow_parts.append(np.asarray(overflow_dev))
            if score_dev is not None:
                score_parts.append(np.asarray(score_dev)[:, :2 * chunk_n])
                tb_parts.append((np.asarray(tb_dev[0])[:2 * chunk_n],
                                 np.asarray(tb_dev[1])[:2 * chunk_n]))
            if collect_candidates:
                cand_all.append((
                    np.asarray(jnp.concatenate(
                        [c for c, _ in cand_batches]))[:chunk_n],
                    np.asarray(jnp.concatenate(
                        [o for _, o in cand_batches]))[:chunk_n]))

        for c0 in range(0, n, pool_n):
            c1 = min(c0 + pool_n, n)
            all_bases, all_lens, all_valid, n_pad = self.stage_reads_device(
                read_bases[c0:c1], read_lengths[c0:c1])
            if with_scores:
                (packed_dev, overflow_dev, score_dev, tb_ops_dev,
                 tb_status_dev) = self._map_reads_device_scored(
                    all_bases, all_lens, all_valid, n_pad, bsz)
                tb_dev = (tb_ops_dev, tb_status_dev)
                cand_batches = []
            else:
                packed_dev, overflow_dev, cand_batches = \
                    self._map_reads_device(all_bases, all_lens, all_valid,
                                           n_pad, bsz, collect_candidates)
                score_dev = None
                tb_dev = None
            if pending is not None:
                fetch(pending)
            pending = (packed_dev, overflow_dev, c1 - c0, cand_batches,
                       score_dev, tb_dev)
        fetch(pending)
        all_packed = (np.concatenate(packed_parts)
                      if len(packed_parts) > 1 else packed_parts[0])
        all_overflow = np.stack(overflow_parts).sum(axis=0)
        if collect_candidates:
            self.last_candidates = (
                np.concatenate([c for c, _ in cand_all]),
                np.concatenate([o for _, o in cand_all]))
        results = CoarseResults(
            orientation=all_packed[:, 0].astype(np.int8),
            hamming=all_packed[:, 1].astype(np.int32),
            shift=all_packed[:, 2].astype(np.int32),
            chromosome_id=all_packed[:, 3].astype(np.int32),
            position=all_packed[:, 4].astype(np.int32),
            global_window_id=all_packed[:, 5].astype(np.uint32),
            stats={"probe_overflow": int(all_overflow[0]),
                   "vote_overflow": int(all_overflow[1]),
                   "pair_budget_overflow": int(all_overflow[2]),
                   "probe_tail_overflow": int(all_overflow[3]),
                   "probe_head_overflow": int(all_overflow[4]),
                   **self._fallback_stats()},
            bs_strand=all_packed[:, 6].astype(np.int8))
        if with_scores:
            all_scores = (np.concatenate(score_parts, axis=1)
                          if len(score_parts) > 1 else score_parts[0])
            if getattr(self.opts, "step2_device_traceback", True):
                tb_ops = np.concatenate([t for t, _ in tb_parts]) \
                    if len(tb_parts) > 1 else tb_parts[0][0]
                tb_status = np.concatenate([s for _, s in tb_parts]) \
                    if len(tb_parts) > 1 else tb_parts[0][1]
                return results, (all_scores, tb_ops, tb_status)
            return results, all_scores
        return results
