"""Genome-region sharding: each device indexes a slice of the genome.

The scaling mode for genomes whose window index exceeds one device's HBM
(whole GRCh38: ~27.5M windows x 16 tables) and for genomes >2 Gbp (the
int32 staged-gather limit of a single mapper).  The genome's window
sequence is partitioned into contiguous regions — whole chromosomes when
the chromosome granularity suffices, INTRA-chromosome window spans with
read-length margins otherwise (parallel/segments.py) — every region's
mapper builds/holds the window index of ITS segments only, read batches
are replicated across regions, and the global best hit per read is the
lexicographic minimum over (hamming, global window ordinal) — an
associative, deterministic reduce, so results are independent of the
region count (SURVEY.md §5 "multi-host merge semantics" requirement) and
EQUAL to the single-device engine's (margins keep every window's
sequence, signature, and extension clamping bit-identical).  The probe
and vote caps hold over the whole genome, as on one device:
  * probe cap: after the build, every region's index keeps only the
    values of a key that are among its first `probe_cap` in genome order
    (apply_global_probe_cap), and the region holding a key's first value
    reports the key's genome-wide count for the overflow stat;
  * vote cap: each batch runs twice per region — first the vote alone,
    then, with each read's genome-wide first `candidates_per_read_cap`
    voted windows known on the host, the full step limited to those
    (global_vote_limits).
The region x mesh composition (mesh=...) still applies both caps per
region (ROADMAP D12).

This realizes the reference's genome-streaming axis (SURVEY.md §2.3 last
row) as a partition instead of a stream; communication is one small
per-read-result merge per batch instead of the reference's per-batch P2P
candidate broadcasts.
"""

from __future__ import annotations

from typing import List

import jax
import numpy as np

from ..config import ProgramOptions
from ..io.genome import Genome
from ..pipeline.engine import CoarseMapper, CoarseResults, SENTINEL
from ..ops import shd
from .segments import (Segment, partition_windows, regions_for_base_cap,
                       whole_chromosome_segments)

# a single mapper's staged bases must index in int32; leave headroom for
# margins and plane packing
SINGLE_MAPPER_BASE_CAP = 2**31 - 2**27


def bin_chromosomes(genome: Genome, n_regions: int) -> List[List[int]]:
    """Balanced greedy binning of chromosome ids by length."""
    order = sorted(range(genome.num_chromosomes),
                   key=lambda c: -genome.chromosome_length(c))
    loads = [0] * n_regions
    bins: List[List[int]] = [[] for _ in range(n_regions)]
    for c in order:
        r = min(range(n_regions), key=lambda i: loads[i])
        bins[r].append(c)
        loads[r] += genome.chromosome_length(c)
    for b in bins:
        b.sort()  # keep genome order within a region
    return bins


def plan_regions(genome: Genome, opts: ProgramOptions, n_regions: int,
                 partition: str = "auto") -> List[List[Segment]]:
    """Region plan as per-region segment lists.

    partition: 'chromosome' bins whole chromosomes (requires n_regions <=
    num chromosomes), 'window' cuts the global window sequence into equal
    contiguous spans, 'auto' picks chromosome binning when it is feasible
    AND every bin fits the staged-base cap, else window cuts (possibly
    with MORE regions than asked, to respect the cap)."""
    from .segments import staged_bases
    margin = opts.max_read_length

    def chrom_plan():
        bins = bin_chromosomes(genome, n_regions)
        return [whole_chromosome_segments(genome, opts, b) for b in bins]

    if partition == "chromosome":
        assert n_regions <= genome.num_chromosomes, (
            "chromosome partition bins whole chromosomes; use "
            "partition='window' for more regions than chromosomes")
        return chrom_plan()
    if partition == "window":
        regions = partition_windows(genome, opts, n_regions)
    else:
        assert partition == "auto", partition
        if n_regions <= genome.num_chromosomes:
            regions = chrom_plan()
        else:
            regions = partition_windows(genome, opts, n_regions)
    if any(staged_bases(genome, opts, r, margin) >= SINGLE_MAPPER_BASE_CAP
           for r in regions):
        regions = regions_for_base_cap(
            genome, opts, SINGLE_MAPPER_BASE_CAP, margin, n_min=n_regions)
    return regions


def local_to_global(mapper: CoarseMapper, chrom_gwin_base: np.ndarray,
                    local: np.ndarray) -> np.ndarray:
    """Global window ordinals (int64) of a region mapper's local window
    ordinals; monotone, so a region's ascending ids stay ascending."""
    base = mapper.seg_local_base
    seg_gwin0 = np.array(
        [chrom_gwin_base[s.chrom_id] + s.win_start for s in mapper.segments],
        dtype=np.int64)
    seg = np.searchsorted(base, local, side="right") - 1
    return seg_gwin0[seg] + (local - base[seg])


def apply_global_probe_cap(mappers: List[CoarseMapper],
                           chrom_gwin_base: np.ndarray,
                           probe_cap: int) -> None:
    """Cut every region's index to the values one index over the whole
    genome would gather.

    One index gathers the first `probe_cap` values of a key, ascending in
    window order.  Per table, the keys whose values over all regions
    exceed the cap are found; each region keeps the values of such a key
    that rank below the cap genome-wide (a prefix of its own ascending
    row, possibly empty), and the region holding the key's first value
    lists it with its genome-wide count in CsrIndex.overflow_keys.  Keys
    stay in place, so the probe directory is unchanged; the direct-probe
    table is rebuilt over the new offsets."""
    import dataclasses

    import jax.numpy as jnp

    from ..index import minhash_index as mi

    host = [dict(keys=np.asarray(m.index.keys),
                 offsets=np.asarray(m.index.offsets).copy(),
                 values=np.asarray(m.index.values).copy(),
                 num_keys=np.asarray(m.index.num_keys)) for m in mappers]
    n_tab = host[0]["keys"].shape[0]
    owned = [[(np.zeros(0, np.uint32), np.zeros(0, np.int32))] * n_tab
             for _ in mappers]
    changed = False
    for t in range(n_tab):
        keys = [h["keys"][t, :h["num_keys"][t]] for h in host]
        counts = [np.diff(h["offsets"][t, :h["num_keys"][t] + 1])
                  for h in host]
        uk, inv = np.unique(np.concatenate(keys), return_inverse=True)
        total = np.bincount(inv, weights=np.concatenate(counts),
                            minlength=len(uk)).astype(np.int64)
        heavy = uk[total > probe_cap]
        if not len(heavy):
            continue
        changed = True
        # every value of a heavy key as (key, global ordinal, region, slot)
        parts = []
        for r, (m, h) in enumerate(zip(mappers, host)):
            j = np.nonzero(np.isin(keys[r], heavy))[0]
            c = counts[r][j]
            rows = np.repeat(np.arange(len(j)), c)
            at = (np.repeat(h["offsets"][t, j].astype(np.int64), c)
                  + np.arange(c.sum()) - np.repeat(np.cumsum(c) - c, c))
            parts.append((keys[r][j][rows],
                          local_to_global(m, chrom_gwin_base,
                                          h["values"][t, at].astype(np.int64)),
                          np.full(len(rows), r), j[rows]))
        key, gord, reg, slot = (np.concatenate(x) for x in zip(*parts))
        order = np.lexsort((gord, key))
        key, reg, slot = key[order], reg[order], slot[order]
        first = np.r_[True, key[1:] != key[:-1]]
        rank = np.arange(len(key)) - np.maximum.accumulate(
            np.where(first, np.arange(len(key)), 0))
        keep = rank < probe_cap
        for r, h in enumerate(host):
            nk = h["num_keys"][t]
            heavy_slot = np.zeros(nk, bool)
            heavy_slot[slot[reg == r]] = True
            kept = np.bincount(slot[keep & (reg == r)], minlength=nk)
            new_cnt = np.where(heavy_slot, kept, counts[r])
            old_off = h["offsets"][t, :nk].astype(np.int64)
            new_off = np.zeros(nk + 1, np.int64)
            np.cumsum(new_cnt, out=new_off[1:])
            at = (np.repeat(old_off, new_cnt) + np.arange(new_off[-1])
                  - np.repeat(new_off[:-1], new_cnt))
            row = h["values"][t, at]
            h["values"][t] = mi.SENTINEL
            h["values"][t, :len(row)] = row
            h["offsets"][t, :nk + 1] = new_off
            h["offsets"][t, nk + 1:] = new_off[-1]
            mine = first & (reg == r)
            okeys = key[mine]
            owned[r][t] = (okeys, total[np.searchsorted(uk, okeys)].astype(
                np.int32))
    if not changed:
        return
    for m, h, own in zip(mappers, host, owned):
        idx = m.index
        d = max(1, max(len(k) for k, _ in own))
        okeys = np.full((n_tab, d), mi.SENTINEL, np.uint32)
        ocount = np.zeros((n_tab, d), np.int32)
        for t, (k, c) in enumerate(own):
            okeys[t, :len(k)] = k
            ocount[t, :len(c)] = c
        with jax.default_device(next(iter(idx.keys.devices()))):
            m.index = dataclasses.replace(
                idx, offsets=jnp.asarray(h["offsets"]),
                values=jnp.asarray(h["values"]),
                cuckoo_keys=None, cuckoo_payload=None,
                overflow_keys=(jnp.asarray(okeys), jnp.asarray(ocount),
                               jnp.asarray(np.array([len(k) for k, _ in own],
                                                    np.int32))))
            if idx.cuckoo_keys is not None:
                assert m.index.build_cuckoo(), m.index.cuckoo_fallback_reason


def global_vote_limits(mappers: List[CoarseMapper],
                       chrom_gwin_base: np.ndarray, votes, n: int,
                       kcap: int):
    """Per-region candidate limits that apply the vote cap genome-wide.

    votes: per region (ids [n_pad, kcap] ascending local ids, SENTINEL-
    padded; num_kept [n_pad]) from the votes-only step.  One device keeps
    a read's first `kcap` voted windows in window order; those are the
    `kcap` smallest global ordinals among the regions' first `kcap` each.
    Returns (limits: per region [n_pad] int32, the number of each read's
    ids to keep; vote_overflow: reads with more than kcap voted windows
    over all regions)."""
    big = np.int64(2**62)
    glob = []
    for m, (ids, _) in zip(mappers, votes):
        ids = np.asarray(ids)[:n].astype(np.int64)
        real = ids != np.int64(SENTINEL)
        glob.append(np.where(
            real, local_to_global(m, chrom_gwin_base, np.where(real, ids, 0)),
            big))
    kth = np.partition(np.concatenate(glob, axis=1), kcap - 1,
                       axis=1)[:, kcap - 1]
    n_pad = np.asarray(votes[0][0]).shape[0]
    limits = [np.pad((g <= kth[:, None]).sum(axis=1), (0, n_pad - n)
                     ).astype(np.int32) for g in glob]
    kept = sum(np.asarray(k)[:n].astype(np.int64) for _, k in votes)
    return limits, int((kept > kcap).sum())


def region_key_payload(mapper: CoarseMapper, packed: np.ndarray,
                       chrom_gwin_base: np.ndarray):
    """Merge key + payload for one region's packed per-read results.

    packed: [N, 6] rows (ori, ham, shift, segment idx, pos, local gwin)
    from the region mapper's device step.  Returns
      key      [N] int64: (hamming << 40) | global window ordinal
               (2**62 when unmapped) — the associative merge key,
      payload  [N, 6] int32: ori, ham, shift, TRUE chrom id, pos,
               bs_strand,
      gwin_global [N] int64 (-1 when unmapped).
    Shared by the host-side merge below and the multi-host collective
    (parallel/multihost.py::merge_region_results)."""
    ori = packed[:, 0]
    ham = packed[:, 1]
    mapped = ori != shd.NONE
    segs = mapper.segments
    seg_chrom = np.array([s.chrom_id for s in segs], dtype=np.int32)
    seg_gwin0 = np.array(
        [chrom_gwin_base[s.chrom_id] + s.win_start for s in segs],
        dtype=np.int64)
    seg_local0 = mapper.seg_local_base[:-1]
    seg_c = np.where(mapped, packed[:, 3], 0)
    in_seg = np.where(
        mapped, packed[:, 5].astype(np.int64) - seg_local0[seg_c], 0)
    gwin_global = np.where(mapped, seg_gwin0[seg_c] + in_seg, -1)
    key = np.where(mapped, (ham.astype(np.int64) << 40) + gwin_global,
                   np.int64(2**62))
    payload = np.stack(
        [ori, ham, packed[:, 2], seg_chrom[seg_c] * mapped, packed[:, 4],
         packed[:, 6]],
        axis=1).astype(np.int32)
    return key, payload, gwin_global


class RegionShardedMapper:
    """One CoarseMapper per region + deterministic cross-region merge.

    Per-region mappers are placed on devices round-robin via
    jax.default_device (regions > devices is allowed: several regions
    share a device and run from its queue); the merge is a pure argmin
    reduction (host-side here; its collective form over a "region" mesh
    axis is parallel/multihost.py::merge_region_results_across_hosts)."""

    def __init__(self, genome: Genome, opts: ProgramOptions, n_regions: int,
                 devices=None, partition: str = "auto", mesh=None):
        self.opts = opts
        self.genome = genome
        self.mesh = mesh
        self.regions = plan_regions(genome, opts, n_regions, partition)
        self.n_regions = len(self.regions)
        devs = list(jax.devices()) if devices is None else list(devices)

        # global window-ordinal offset of each chromosome
        self.chrom_gwin_base = np.zeros(genome.num_chromosomes, dtype=np.int64)
        t = 0
        for c in range(genome.num_chromosomes):
            self.chrom_gwin_base[c] = t
            t += genome.num_windows_in_chromosome(
                c, opts.kmer_length, opts.window_size)

        self.mappers: List[CoarseMapper] = []
        # the cuckoo direct-probe tables cost ~2.5x the CSR index in device
        # memory; with >2 co-resident regions per device they would crowd
        # out the read pool, so those configurations keep the bit-identical
        # binary-search probe (a fixed rule; ROADMAP D11 derives it from
        # the device's bytes_limit)
        if mesh is not None:
            # region x mesh composition: every region's tables shard over
            # the SAME (data x table) mesh (so a pod can hold GRCh38:
            # regions bound the staged-base/int32 limits, the table axis
            # bounds per-device index HBM).  Per-device burden is
            # regions / table-axis index shards.
            from .sharded import ShardedCoarseMapper
            regions_per_dev = -(-self.n_regions // mesh.shape["table"])
            direct_probe = regions_per_dev <= 2
            for segs in self.regions:
                self.mappers.append(ShardedCoarseMapper(
                    genome, opts, mesh, segments=segs,
                    build_direct_probe=direct_probe))
        else:
            regions_per_dev = -(-self.n_regions // len(devs))
            direct_probe = regions_per_dev <= 2
            for r, segs in enumerate(self.regions):
                with jax.default_device(devs[r % len(devs)]):
                    self.mappers.append(CoarseMapper(
                        genome, opts, segments=segs,
                        build_direct_probe=direct_probe))
            if self.n_regions > 1:
                apply_global_probe_cap(self.mappers, self.chrom_gwin_base,
                                       opts.probe_cap)

    # every region engine supports the fused STEP-2 score+traceback pass
    # (segment-aware _ensure_genome_s2); the merge below re-selects the
    # winning region's score/tb rows per read
    supports_fused_scores = True

    def map_reads(self, read_bases: np.ndarray,
                  read_lengths: np.ndarray,
                  with_scores: bool = False) -> CoarseResults:
        opts = self.opts
        n = len(read_lengths)
        out = CoarseResults(
            orientation=np.full(n, shd.NONE, dtype=np.int8),
            hamming=np.zeros(n, dtype=np.int32),
            shift=np.zeros(n, dtype=np.int32),
            chromosome_id=np.zeros(n, dtype=np.int32),
            position=np.zeros(n, dtype=np.int32),
            global_window_id=np.full(n, SENTINEL, dtype=np.uint32),
            stats={"probe_overflow": 0, "vote_overflow": 0,
                   "pair_budget_overflow": 0, "probe_tail_overflow": 0,
                   "probe_head_overflow": 0},
            bs_strand=np.zeros(n, dtype=np.int8))
        best_key = np.full(n, 2**62, dtype=np.int64)
        # region-sharded global ordinals exceed uint32 for >2 Gbp genomes;
        # expose the full-width ordinal alongside the uint32 field
        out_gwin64 = np.full(n, -1, dtype=np.int64)

        staged = []
        for mapper in self.mappers:
            mapper.ensure_empty_drops()
            staged.append(mapper.stage_reads_device(read_bases,
                                                    read_lengths))
        # the genome-wide vote cap: every region's vote first (enqueued
        # on all devices before the host waits), then each read's limits
        limits = [{}] * self.n_regions
        vote_overflow = None
        if self.mesh is None and self.n_regions > 1:
            votes = [m._map_reads_device(*st, opts.batchsize,
                                         votes_only=True)
                     for m, st in zip(self.mappers, staged)]
            lim, vote_overflow = global_vote_limits(
                self.mappers, self.chrom_gwin_base, votes, n,
                opts.candidates_per_read_cap)
            limits = [{"all_limits": x} for x in lim]

        # phase 1: ENQUEUE every region's device work without any host
        # sync — async dispatch lets each region's device queue execute
        # concurrently (replaces the serial per-region loop; reference
        # analog: per-GPU private streams, multigpuminhasher.cuh:641-738)
        pending = []
        for mapper, st, kw in zip(self.mappers, staged, limits):
            if with_scores:
                packed_dev, ovf_dev, sc_dev, to_dev, ts_dev = \
                    mapper._map_reads_device_scored(*st, opts.batchsize,
                                                    **kw)
                pending.append((packed_dev, ovf_dev, mapper,
                                (sc_dev, to_dev, ts_dev)))
            else:
                packed_dev, ovf_dev, _ = mapper._map_reads_device(
                    *st, opts.batchsize, **kw)
                pending.append((packed_dev, ovf_dev, mapper, None))

        # phase 2: fetch per-region results (device work already done or
        # in flight) and merge by the deterministic (hamming, global
        # window ordinal) key
        win_region = np.full(n, -1, dtype=np.int32)
        region_scores = []
        for r_i, (packed_dev, ovf_dev, mapper, sc) in enumerate(pending):
            if sc is not None:
                region_scores.append((
                    np.asarray(sc[0])[:, :2 * n], np.asarray(sc[1])[:2 * n],
                    np.asarray(sc[2])[:2 * n]))
            packed = np.asarray(packed_dev)[:n]
            ovf = np.asarray(ovf_dev)
            out.stats["probe_overflow"] += int(ovf[0])
            out.stats["vote_overflow"] += int(ovf[1])
            out.stats["pair_budget_overflow"] += int(ovf[2])
            out.stats["probe_tail_overflow"] += int(ovf[3])
            out.stats["probe_head_overflow"] += (int(ovf[4])
                                                 if len(ovf) > 4 else 0)
            key, payload, gwin_global = region_key_payload(
                mapper, packed, self.chrom_gwin_base)
            better = key < best_key
            best_key = np.where(better, key, best_key)
            win_region[better] = r_i
            out.orientation[better] = payload[better, 0].astype(np.int8)
            out.hamming[better] = payload[better, 1]
            out.shift[better] = payload[better, 2]
            out.chromosome_id[better] = payload[better, 3]
            out.position[better] = payload[better, 4]
            out.bs_strand[better] = payload[better, 5].astype(np.int8)
            out_gwin64[better] = gwin_global[better]
            out.global_window_id[better] = (
                gwin_global[better] & 0xFFFFFFFF).astype(np.uint32)
        out.global_window_id64 = out_gwin64
        if vote_overflow is not None:
            out.stats["vote_overflow"] = vote_overflow
        # probe surfacing (engine._fallback_stats): the direct probe
        # counts only when EVERY region has it
        out.stats["cuckoo_direct_probe"] = min(
            m._fallback_stats()["cuckoo_direct_probe"] for m in self.mappers)
        if with_scores:
            # per-read selection of the winning region's fused STEP-2
            # score/traceback rows (pair columns 2i, 2i+1 of read i)
            e = max(t.shape[1] for _, t, _ in region_scores)
            scores = np.zeros((10, 2 * n), np.int16)
            tb_ops = np.zeros((2 * n, e), np.uint8)
            tb_st = np.zeros(2 * n, np.int8)
            for r_i, (sc, to, ts) in enumerate(region_scores):
                rows = np.nonzero(win_region == r_i)[0]
                if len(rows) == 0:
                    continue
                cols = np.repeat(2 * rows, 2)
                cols[1::2] += 1
                scores[:, cols] = sc[:, cols]
                tb_ops[cols, :to.shape[1]] = to[cols]
                tb_st[cols] = ts[cols]
            if getattr(opts, "step2_device_traceback", True):
                return out, (scores, tb_ops, tb_st)
            return out, scores
        return out
