"""Window-streaming orientation: read index resident, genome windows stream.

This is the reference's OWN architecture (reference: src/gpu/main_gpu.cu
WindowBatchProcessor, :431-856), provided as a second pipeline mode for
workloads where the read set fits in HBM but the genome index would not —
the reference's original use case (index 10M reads, stream GRCh38):

  window batch -> encode -> minhash signatures -> probe READ index
  -> min-table-hits vote (candidate read ids per window, ascending)
  -> SHD of each candidate read vs the extended window
  -> host merge of per-(window, read) results in genome order
     (first-window-wins, strictly-smaller-hamming replaces;
      main_gpu.cu:777-821).

Results are identical to the inverted engine (pipeline/engine.py) and the
oracle — equivalence-tested in tests/test_window_stream.py.  The read index
uses lazy max-values-per-key drop masking at probe time, which is exactly
GroupByKey's drop-all rule.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ProgramOptions
from ..index import minhash_index as mi
from ..io.genome import Genome
from ..ops import minhash, shd
from .engine import CoarseResults

SENTINEL = np.uint32(0xFFFFFFFF)


class WindowStreamMapper:
    """Reference-orientation mapper: build once per read set, then stream."""

    def __init__(self, read_bases: np.ndarray, read_lengths: np.ndarray,
                 opts: ProgramOptions):
        opts.validate()
        self.opts = opts
        n, lr = read_bases.shape
        if lr < opts.max_read_length:
            read_bases = np.pad(
                read_bases, ((0, 0), (0, opts.max_read_length - lr)))
        self.num_reads = n
        self.read_bases = jnp.asarray(read_bases.astype(np.int8))
        self.read_lengths = jnp.asarray(read_lengths.astype(np.int32))
        self.hash_ids = jnp.arange(opts.num_hash_functions, dtype=jnp.uint32)

        # read index (the reference's STEP-1 index build)
        chunk = 4096
        n_pad = ((n + chunk - 1) // chunk) * chunk
        rb = jnp.pad(self.read_bases, ((0, n_pad - n), (0, 0)))
        rl = jnp.pad(self.read_lengths, (0, n_pad - n))
        if opts.three_n_seeding:
            # 3N read index: tables 1..F keyed by the read's CT collapse,
            # F+1..2F by its RC's GA collapse — the mirror of the inverted
            # engine's window index (engine.py:158-168), so candidate pair
            # sets are identical (signature equality is symmetric)
            from ..ops import encode
            rc = encode.revcomp_bases(rb, rl)
            s_ct, valid = minhash.minhash_signatures_chunked(
                jnp.where(rb == 1, jnp.int8(3), rb), rl,
                opts.kmer_length, self.hash_ids, chunk, canonical=False)
            s_ga, _ = minhash.minhash_signatures_chunked(
                jnp.where(rc == 2, jnp.int8(0), rc), rl,
                opts.kmer_length, self.hash_ids, chunk, canonical=False)
            sigs = jnp.concatenate([s_ct, s_ga], axis=1)       # [n, 2F]
            if opts.undirectional:
                # PBAT read-key spaces: tables [2F..3F) = CT(RC read),
                # [3F..4F) = GA(read) — the mirror of the inverted
                # engine's undirectional query blocks, so candidate pair
                # sets stay identical (signature equality is symmetric)
                s_rcct, _ = minhash.minhash_signatures_chunked(
                    jnp.where(rc == 1, jnp.int8(3), rc), rl,
                    opts.kmer_length, self.hash_ids, chunk,
                    canonical=False)
                s_rga, _ = minhash.minhash_signatures_chunked(
                    jnp.where(rb == 2, jnp.int8(0), rb), rl,
                    opts.kmer_length, self.hash_ids, chunk,
                    canonical=False)
                sigs = jnp.concatenate([sigs, s_rcct, s_rga], axis=1)
        else:
            sigs, valid = minhash.minhash_signatures_chunked(
                rb, rl, opts.kmer_length, self.hash_ids, chunk)
        self.index = mi.build_csr_index_device(
            sigs[:n], valid[:n], opts.kmer_length,
            np.asarray(self.hash_ids))
        self.index.build_buckets()
        if opts.three_n_seeding and opts.probe_cap < 1023:
            # direct probe for the 3N config; the parity config keeps the
            # binary search (its lazy max-values-per-key drop rule needs
            # exact counts, which the cuckoo payload saturates)
            self.index.build_cuckoo()
        # per-read plane packing, once
        from ..ops import shd as shd_mod
        self.read_planes = shd_mod.pack_read_planes(
            self.read_bases, self.read_lengths, opts.three_n_seeding)
        self.read_planes_u = (shd_mod.pack_read_planes(
            self.read_bases, self.read_lengths, opts.three_n_seeding,
            undirectional=True) if opts.undirectional else self.read_planes)

    def _window_batch(self, genome_concat, genome_hi, genome_lo, chrom_goff,
                      win_len, win_pos, chrom_len, win_valid):
        i = self.index
        return self._window_batch_impl(
            i.keys, i.offsets, i.values, i.num_keys, i.bucket_start,
            i.cuckoo_keys, i.cuckoo_payload,
            self.read_planes, self.read_planes_u, self.read_lengths,
            self.hash_ids,
            genome_concat, genome_hi, genome_lo, chrom_goff, win_len,
            win_pos, chrom_len, win_valid)

    @partial(jax.jit, static_argnames=("self",))
    def _window_batch_impl(self, index_keys, index_offsets, index_values,
                           index_num_keys, bucket_start,
                           cuckoo_keys, cuckoo_payload,
                           read_planes, read_planes_u, read_lengths_all,
                           hash_ids,
                           genome_concat, genome_hi, genome_lo,
                           chrom_goff: jnp.ndarray, win_len: jnp.ndarray,
                           win_pos: jnp.ndarray, chrom_len: jnp.ndarray,
                           win_valid: jnp.ndarray):
        """One batch of windows -> packed per-pair results [B*K, 4]:
        (read_id|SENTINEL, hamming, shift, orientation)."""
        opts = self.opts
        b = win_pos.shape[0]
        kcap = opts.candidates_per_read_cap
        # window bases gathered on device from the resident genome —
        # only the [B] int32 positions cross H2D per batch (the reference
        # likewise ships window chars, never the genome,
        # src/gpu/main_gpu.cu:484-514)
        widx = (chrom_goff + win_pos[:, None]
                + jnp.arange(opts.window_size, dtype=jnp.int32)[None, :])
        widx = jnp.minimum(widx, genome_concat.shape[0] - 1)
        win_bases = jnp.take(genome_concat, widx.reshape(-1)).reshape(
            b, opts.window_size)

        if opts.three_n_seeding:
            s_ct, sig_valid = minhash.minhash_signatures(
                jnp.where(win_bases == 1, jnp.int8(3), win_bases), win_len,
                opts.kmer_length, hash_ids, canonical=False)
            s_ga, _ = minhash.minhash_signatures(
                jnp.where(win_bases == 2, jnp.int8(0), win_bases), win_len,
                opts.kmer_length, hash_ids, canonical=False)
            sigs = jnp.concatenate([s_ct, s_ga], axis=1)       # [B, 2F]
            if opts.undirectional:
                # the same window collapses probe the PBAT table blocks
                sigs = jnp.concatenate([sigs, s_ct, s_ga], axis=1)
        else:
            sigs, sig_valid = minhash.minhash_signatures(
                win_bases, win_len, opts.kmer_length, hash_ids)
        sig_valid = sig_valid & win_valid
        # the lazy key-cap emulates the reference read-index GroupByKey drop
        # (parity feature); the 3N config has no drop rule, matching the
        # inverted engine (engine.map_reads disables it in 3N mode)
        cuckoo_kw = {}
        if cuckoo_keys is not None:
            cuckoo_kw = dict(cuckoo=(cuckoo_keys, cuckoo_payload),
                             cuckoo_bits=self.index.cuckoo_bits,
                             cuckoo_seeds=self.index.cuckoo_seeds)
        tail_budget = b * opts.probe_tail_budget_per_read
        head_budget = b * getattr(opts, "probe_head_budget_per_read", 0)
        tail_drops = head_drops = jnp.int32(0)
        if tail_budget > 0:
            cand, counts, tail_drops, head_drops = mi.probe_tables(
                index_keys, index_offsets, index_values,
                index_num_keys, sigs, sig_valid, opts.probe_cap,
                bucket_start=bucket_start,
                probe_steps=self.index.probe_steps,
                max_values_per_key=(0 if opts.three_n_seeding
                                    else opts.max_results_per_map),
                fnc_layout=True, tail_budget=tail_budget,
                head_budget=head_budget, **cuckoo_kw)
        else:
            cand, counts = mi.probe_tables(
                index_keys, index_offsets, index_values,
                index_num_keys, sigs, sig_valid, opts.probe_cap,
                bucket_start=bucket_start,
                probe_steps=self.index.probe_steps,
                max_values_per_key=(0 if opts.three_n_seeding
                                    else opts.max_results_per_map),
                fnc_layout=True, **cuckoo_kw)
        ids, _cnt, num_kept = mi.vote_candidates(
            cand.transpose(1, 0, 2), opts.min_table_hits, kcap)

        rid = ids.reshape(-1)                          # [B*K] read ids
        pair_valid = rid != jnp.uint32(0xFFFFFFFF)
        rid_full = jnp.where(pair_valid, rid, 0).astype(jnp.int32)
        nk = b * kcap
        # pair compaction (engine.coarse_pairs_best's budget machinery in
        # the window orientation: budget = windows * shd_pairs budget) —
        # at real densities most of the [B, K] candidate grid is padding,
        # so SHD and its plane gathers run on the compacted pairs only.
        # Bit-identical while pair_drops stays 0.
        kb = opts.shd_pairs_per_read_budget
        compact = 0 < kb < kcap
        if compact:
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

        rid_c = jnp.take(rid_full, pair_sel)
        widx_p = pair_sel // kcap
        r_len = jnp.take(read_lengths_all, rid_c)
        pos_rep = jnp.take(win_pos, widx_p)
        clen_rep = jnp.take(chrom_len, widx_p)
        loc = shd.extended_window_location(
            pos_rep, clen_rep, r_len, opts.window_size)
        params = shd.ShdParams(
            window_size=opts.window_size,
            max_ext_len=opts.window_size + opts.max_read_length,
            max_read_len=self.opts.max_read_length,
            max_hamming_percent=opts.max_hamming_percent)
        def eval_pairs(planes, undirectional):
            hi0, lo0, hi1, lo1, pmask = planes
            return shd.shd_pairs_packed_planes(
                genome_hi, genome_lo, chrom_goff + loc.start,
                loc.length, loc.left,
                jnp.take(hi0, rid_c, axis=0), jnp.take(lo0, rid_c, axis=0),
                jnp.take(hi1, rid_c, axis=0), jnp.take(lo1, rid_c, axis=0),
                jnp.take(pmask, rid_c, axis=0), r_len, sel_valid, params,
                three_n=opts.three_n_seeding, undirectional=undirectional)

        res = eval_pairs(read_planes, False)
        if opts.undirectional:
            res_u = eval_pairs(read_planes_u, True)
            better_u = (res_u.orientation != shd.NONE) & (
                (res.orientation == shd.NONE)
                | (res_u.hamming < res.hamming))
            res_ham = jnp.where(better_u, res_u.hamming, res.hamming)
            res_shf = jnp.where(better_u, res_u.shift, res.shift)
            res_ori = jnp.where(better_u, res_u.orientation,
                                res.orientation)
            res_strand = better_u.astype(jnp.int32)
        else:
            res_ham, res_shf, res_ori = (res.hamming, res.shift,
                                         res.orientation)
            res_strand = jnp.zeros_like(res.hamming)

        if compact:
            tgt = jnp.where(sel_valid, pair_sel, nk)
            res_ham = jnp.zeros((nk,), res_ham.dtype).at[tgt].set(
                res_ham, mode="drop")
            res_shf = jnp.zeros((nk,), res_shf.dtype).at[tgt].set(
                res_shf, mode="drop")
            res_ori = jnp.full((nk,), shd.NONE, res_ori.dtype).at[tgt].set(
                res_ori, mode="drop")
            res_strand = jnp.zeros((nk,), jnp.int32).at[tgt].set(
                res_strand, mode="drop")

        out_rid = jnp.where(pair_valid & (res_ori != shd.NONE), rid_full,
                            -1)
        packed = jnp.stack(
            [out_rid, res_ham, res_shf, res_ori.astype(jnp.int32),
             res_strand], axis=1)
        overflow = jnp.stack([jnp.sum(counts > opts.probe_cap),
                              jnp.sum(num_kept > kcap), pair_drops,
                              tail_drops, head_drops])
        return packed, overflow

    def map_genome(self, genome: Genome) -> CoarseResults:
        opts = self.opts
        self._genome_concat = jnp.asarray(np.concatenate(
            [genome.bases[c].astype(np.int8)
             for c in range(genome.num_chromosomes)]))
        from ..ops import bitplanes
        self._genome_hi, self._genome_lo = bitplanes.pack_genome_planes(
            self._genome_concat)
        chrom_offsets = np.zeros(genome.num_chromosomes, dtype=np.int64)
        t = 0
        for c in range(genome.num_chromosomes):
            chrom_offsets[c] = t
            t += genome.chromosome_length(c)
        assert t < 2**31

        bsz = opts.batchsize
        kcap = opts.candidates_per_read_cap
        packed_parts = []
        batch_meta = []  # (chrom_id, positions array, n_windows)
        overflow_parts = []  # device handles; summed once at the end
        for batch in genome.iter_window_batches(
                opts.kmer_length, opts.window_size, bsz):
            nb = len(batch.positions)
            clen = genome.chromosome_length(batch.chromosome_id)
            pos = batch.positions
            lens = batch.lengths
            valid = np.ones(nb, dtype=bool)
            if nb < bsz:
                pos = np.pad(pos, (0, bsz - nb))
                lens = np.pad(lens, (0, bsz - nb))
                valid = np.pad(valid, (0, bsz - nb))
            goff = int(chrom_offsets[batch.chromosome_id])
            packed, ovf = self._window_batch(
                self._genome_concat, self._genome_hi, self._genome_lo,
                jnp.int32(goff), jnp.asarray(lens),
                jnp.asarray(pos.astype(np.int32)),
                jnp.full((bsz,), clen, dtype=jnp.int32),
                jnp.asarray(valid))
            packed_parts.append(packed)
            batch_meta.append((batch.chromosome_id, batch.positions,
                               batch.global_window_ids, nb))
            overflow_parts.append(ovf)

        all_packed = np.asarray(jnp.concatenate(packed_parts))
        overflow = np.asarray(
            jnp.sum(jnp.stack(overflow_parts), axis=0)).astype(np.int64)

        out = CoarseResults(
            orientation=np.full(self.num_reads, shd.NONE, dtype=np.int8),
            hamming=np.zeros(self.num_reads, dtype=np.int32),
            shift=np.zeros(self.num_reads, dtype=np.int32),
            chromosome_id=np.zeros(self.num_reads, dtype=np.int32),
            position=np.zeros(self.num_reads, dtype=np.int32),
            global_window_id=np.full(self.num_reads, SENTINEL,
                                     dtype=np.uint32),
            stats={"probe_overflow": int(overflow[0]),
                   "vote_overflow": int(overflow[1]),
                   "pair_budget_overflow": int(overflow[2]),
                   "probe_tail_overflow": int(overflow[3]),
                   "probe_head_overflow": int(overflow[4])},
            bs_strand=np.zeros(self.num_reads, dtype=np.int8))

        # host merge in genome order (reference: main_gpu.cu:777-821).
        # First-window-wins with strictly-smaller-hamming replacement is
        # equivalent to the lexicographic minimum over (hamming, row order)
        # because rows are emitted in genome/window/candidate order.
        chrom_rep = []
        pos_rep = []
        gwin_rep = []
        for chrom_id, positions, gwins, nb in batch_meta:
            c = np.full((bsz, kcap), chrom_id, dtype=np.int32)
            p = np.zeros((bsz, kcap), dtype=np.int32)
            g = np.zeros((bsz, kcap), dtype=np.int64)
            p[:nb] = positions[:, None]
            g[:nb] = gwins[:, None]
            chrom_rep.append(c.reshape(-1))
            pos_rep.append(p.reshape(-1))
            gwin_rep.append(g.reshape(-1))
        chrom_rep = np.concatenate(chrom_rep)
        pos_rep = np.concatenate(pos_rep)
        gwin_rep = np.concatenate(gwin_rep)

        rid = all_packed[:, 0]
        valid = rid >= 0
        rid_v = rid[valid]
        ham_v = all_packed[valid, 1]
        order_v = np.arange(len(all_packed), dtype=np.int64)[valid]
        if len(rid_v):
            sel = np.lexsort((order_v, ham_v, rid_v))
            rid_s = rid_v[sel]
            first = np.ones(len(rid_s), dtype=bool)
            first[1:] = rid_s[1:] != rid_s[:-1]
            win = sel[first]           # winning row per distinct read
            rows = np.flatnonzero(valid)[win]
            r = rid_v[win]
            out.orientation[r] = all_packed[rows, 3]
            out.bs_strand[r] = all_packed[rows, 4].astype(np.int8)
            out.hamming[r] = all_packed[rows, 1]
            out.shift[r] = all_packed[rows, 2]
            out.chromosome_id[r] = chrom_rep[rows]
            out.position[r] = pos_rep[rows]
            out.global_window_id[r] = gwin_rep[rows].astype(np.uint32)
        return out
