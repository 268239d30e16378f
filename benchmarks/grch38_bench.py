"""Full-GRCh38-scale end-to-end run on one device.

The reference's production target is GRCh38 + ERR194147 (reference:
download.sh:3-13, startbefehl.txt:1-3; 6-GPU SLURM shape scriptJob:10-17).
This benchmark runs the SAME scale on ONE device: a faithful synthetic
GRCh38 — all 24 nuclear chromosomes at their true GRCh38 lengths, chrM
(16.6 kb) and a handful of unplaced-contig-sized sequences to stress the
small-contig window/segment math — with >=1M planted BS reads, mapped
end-to-end (coarse -> STEP-2 SAM -> STEP-3 VCF) and scored for
concordance against the planted truth.

The regions STREAM through the device sequentially, so the device never
holds more than one region's index: each region's window
index is built on-chip, all reads coarse-map against it, the per-read
(hamming, global-window) argmin merges into the running best
(region_key_payload — the same deterministic merge the resident
RegionShardedMapper uses), and the region's buffers are freed before the
next build.  Index arrays are padded to a common shape so every region
reuses ONE compiled executable.  This is the single-chip projection of
the multi-device region layout; per-read results are identical by the
merge's associativity (parallel/region_sharded.py docstring).

Usage:  python benchmarks/grch38_bench.py [n_reads] [n_regions]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# GRCh38 primary-assembly chromosome lengths (GCA_000001405.15)
GRCH38_LENGTHS = {
    "chr1": 248956422, "chr2": 242193529, "chr3": 198295559,
    "chr4": 190214555, "chr5": 181538259, "chr6": 170805979,
    "chr7": 159345973, "chr8": 145138636, "chr9": 138394717,
    "chr10": 133797422, "chr11": 135086622, "chr12": 133275309,
    "chr13": 114364328, "chr14": 107043718, "chr15": 101991189,
    "chr16": 90338345, "chr17": 83257441, "chr18": 80373285,
    "chr19": 58617616, "chr20": 64444167, "chr21": 46709983,
    "chr22": 50818468, "chrX": 156040895, "chrY": 57227415,
    "chrM": 16569,
    # unplaced-contig-sized stress entries (GL000-class lengths)
    "chrUn_GL000195v1": 182896, "chrUn_GL000219v1": 179198,
    "chrUn_GL000220v1": 161802,
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def synth_genome(rng):
    from hashreadmapper_tpu.io.genome import Genome
    # HRM_GRCH38_SCALE=N divides every length by N (script smoke testing
    # only; the recorded run uses scale 1)
    scale = int(os.environ.get("HRM_GRCH38_SCALE", "1"))
    g = Genome.__new__(Genome)
    g.names = list(GRCH38_LENGTHS.keys())
    g.seqs_ascii = []
    g.bases = []
    t0 = time.perf_counter()
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    for name, L in GRCH38_LENGTHS.items():
        L = max(1000, L // scale)
        b = rng.integers(0, 4, size=L, dtype=np.int8)
        g.bases.append(b)
        g.seqs_ascii.append(lut[b])
    total = sum(len(b) for b in g.bases)
    log(f"synth genome: {total/1e9:.2f} Gbp, {len(g.names)} sequences "
        f"({time.perf_counter()-t0:.0f}s)")
    return g, total


def plant_reads(rng, genome, n_reads, read_len):
    lengths = np.array([len(b) for b in genome.bases], dtype=np.int64)
    big = lengths >= 4 * read_len
    p = np.where(big, lengths, 0).astype(np.float64)
    p /= p.sum()
    chroms = rng.choice(len(lengths), size=n_reads, p=p)
    reads = np.empty((n_reads, read_len), np.int8)
    starts = np.empty(n_reads, np.int64)
    order = np.argsort(chroms, kind="stable")
    for c in np.unique(chroms):
        rows = order[np.searchsorted(chroms[order], [c, c + 1])[0]:
                     np.searchsorted(chroms[order], [c, c + 1])[1]]
        s = rng.integers(0, lengths[c] - read_len, size=len(rows))
        starts[rows] = s
        src = genome.bases[c]
        reads[rows] = src[s[:, None] + np.arange(read_len)[None, :]]
    # 1% substitutions, 50% RC, then 90% C->T in read space
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    conv = (reads == 1) & (rng.random(reads.shape) < 0.9)
    reads[conv] = 3
    return reads, chroms, starts, rc


def pad_index_like(index, u_max, v_max):
    """Pad one region's CSR/cuckoo arrays so all regions share ONE jit
    executable (the index arrays are jit arguments; different shapes
    would recompile per region)."""
    import jax.numpy as jnp
    f, u = index.keys.shape
    du = u_max - u
    dv = v_max - index.values.shape[1]
    if du:
        index.keys = jnp.pad(index.keys, ((0, 0), (0, du)),
                             constant_values=np.uint32(0xFFFFFFFF))
        last = index.offsets[:, -1:]
        index.offsets = jnp.concatenate(
            [index.offsets, jnp.repeat(last, du, axis=1)], axis=1)
    if dv:
        index.values = jnp.pad(index.values, ((0, 0), (0, dv)),
                               constant_values=np.uint32(0xFFFFFFFF))
    return index


def main():
    import jax
    import jax.numpy as jnp

    from hashreadmapper_tpu.config import ProgramOptions
    from hashreadmapper_tpu.index.minhash_index import build_probe_buckets
    from hashreadmapper_tpu.io.readstore import ReadStorage, pack_rows
    from hashreadmapper_tpu.parallel.region_sharded import (
        SINGLE_MAPPER_BASE_CAP, plan_regions, region_key_payload)
    from hashreadmapper_tpu.pipeline import mapping
    from hashreadmapper_tpu.pipeline.engine import CoarseMapper
    from hashreadmapper_tpu.pipeline.records import (MappingRecords,
                                                     emit_sam, emit_vcf)

    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20
    n_regions_req = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    read_len, batch = 100, 4096
    n_reads = (n_reads // batch) * batch
    log(f"device: {jax.devices()[0]}")

    rng = np.random.default_rng(38)
    genome, total_bases = synth_genome(rng)
    reads, t_chrom, t_start, t_rc = plant_reads(rng, genome, n_reads,
                                                read_len)
    lengths = np.full(n_reads, read_len, np.int32)

    # caps via HRM_G38_CAPS="probe,kcap,pair,tail,head".  At 3.1 Gbp the
    # CT-collapsed 16-mer space is ~72x oversubscribed; the flagship's
    # head budget (sized for a 43% found rate) drops probes wholesale
    # here (first recorded run: mapped 40.3% with head 18, tail 4) — the
    # at-scale default is the repeat-regime recommendation (PERF.md):
    # probe 32 / kcap 16 / pair 8, tail+head compaction OFF.
    caps = os.environ.get("HRM_G38_CAPS", "32,16,8,0,0")
    probe_cap, kcap, pairb, tailb, headb = (int(x) for x in
                                            caps.split(","))
    opts = ProgramOptions(
        kmer_length=16, num_hash_functions=16, window_size=128,
        min_table_hits=4, batchsize=batch, max_hamming_percent=0.05,
        probe_cap=probe_cap, candidates_per_read_cap=kcap,
        max_read_length=128,
        threads=4, three_n_seeding=True, shd_pairs_per_read_budget=pairb,
        probe_tail_budget_per_read=tailb,
        probe_head_budget_per_read=headb)

    regions = plan_regions(genome, opts, n_regions_req)
    # descending window count: the FIRST region then fixes the padded
    # index shape, so every later region reuses its compiled executable
    # (the merge is order-independent)
    regions.sort(key=lambda segs: -sum(s.num_windows() for s in segs))
    log(f"{len(regions)} regions "
        f"(cap {SINGLE_MAPPER_BASE_CAP/1e9:.2f} Gbp/region)")

    # global window ordinal base per chromosome (merge key space)
    chrom_gwin_base = np.zeros(genome.num_chromosomes, dtype=np.int64)
    t = 0
    for c in range(genome.num_chromosomes):
        chrom_gwin_base[c] = t
        t += genome.num_windows_in_chromosome(c, opts.kmer_length,
                                              opts.window_size)

    padded = np.pad(reads, ((0, 0), (0, opts.max_read_length - read_len))
                    ).astype(np.int8)

    # running best per read
    best_key = np.full(n_reads, np.int64(2**62))
    best_payload = np.zeros((n_reads, 6), np.int32)
    best_payload[:, 0] = 3                     # NONE orientation
    best_gwin64 = np.full(n_reads, -1, np.int64)

    u_max = v_max = 0
    stats_sum = {}
    t_build = t_map = 0.0
    idx_bytes = 0
    t_round0 = time.perf_counter()
    for ri, segs in enumerate(regions):
        t0 = time.perf_counter()
        # binary-search probe: the cuckoo direct-probe tables cost ~2.5x
        # the CSR index in device memory, and region i's buffers are
        # freed lazily while region i+1 builds, so with cuckoo on the
        # transient co-residency can exceed a small device's memory
        mapper = CoarseMapper(genome, opts, segments=segs,
                              build_direct_probe=False)
        # pad to the largest index seen so every region hits the same
        # compiled executable (regions are near-equal window spans, so
        # the first region's size is within ~1% of the max; grow u/v max
        # monotonically and live with one recompile if a later region
        # exceeds it)
        u_max = max(u_max, mapper.index.keys.shape[1])
        v_max = max(v_max, mapper.index.values.shape[1])
        pad_index_like(mapper.index, u_max, v_max)
        mapper.index.build_buckets()
        dt_b = time.perf_counter() - t0
        t_build += dt_b
        idx_bytes += mapper.index.memory_bytes()
        t0 = time.perf_counter()
        res = mapper.map_reads(padded, lengths)
        dt_m = time.perf_counter() - t0
        t_map += dt_m
        for k, v in res.stats.items():
            stats_sum[k] = stats_sum.get(k, 0) + v
        packed = np.stack(
            [res.orientation.astype(np.int32), res.hamming, res.shift,
             res.chromosome_id, res.position,
             res.global_window_id.astype(np.int64).astype(np.int32),
             (res.bs_strand if res.bs_strand is not None
              else np.zeros(n_reads)).astype(np.int32)], axis=1)
        key, payload, gwin_global = region_key_payload(
            mapper, packed, chrom_gwin_base)
        better = key < best_key
        best_key = np.where(better, key, best_key)
        best_payload[better] = payload[better]
        best_gwin64[better] = gwin_global[better]
        n_mapped_r = int((res.orientation != 3).sum())
        log(f"[region {ri}] windows={mapper.table.num_windows} "
            f"build {dt_b:.1f}s map {dt_m:.1f}s mapped {n_mapped_r}")
        # the jitted methods' cache holds `self` (a static arg), so the
        # mapper OBJECT outlives `del` — null the big device references
        # so the arrays free even while the husk stays cached (ROADMAP D5)
        mapper.index = None
        mapper.table = None
        mapper._genome_s2 = None
        mapper.dropped = None
        del mapper, res
        import gc
        gc.collect()
    t_coarse_total = time.perf_counter() - t_round0

    ori = best_payload[:, 0].astype(np.int8)
    n_mapped = int((ori != 3).sum())
    log(f"coarse merged: {n_mapped}/{n_reads} mapped; "
        f"build {t_build:.0f}s map {t_map:.0f}s "
        f"(wall {t_coarse_total:.0f}s); stats {stats_sum}")

    # STEP 2 + 3 on the merged winners (host-staged pairs; the windows
    # gather from the full host genome, so no region needs re-staging)
    genome_rc = genome.reverse_complement()
    store = ReadStorage(pack_rows(reads, lengths, (read_len + 15) // 16),
                        lengths, np.zeros(n_reads, bool))
    t0 = time.perf_counter()
    recs = mapping.run_cssw(
        genome, genome_rc, ori, best_payload[:, 4],
        best_payload[:, 3], store, opts,
        best_payload[:, 5].astype(np.int8), None, True)
    t_step2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    sam_stats = emit_sam(recs, genome, "/tmp/grch38_out.SAM",
                         threads=opts.threads)
    emit_vcf(recs, genome, "/tmp/grch38_out")
    t_emit = time.perf_counter() - t0
    log(f"STEP2 {t_step2:.0f}s, SAM+VCF {t_emit:.0f}s ({sam_stats})")

    # concordance vs planted truth (coarse window position within one
    # window of the planted start; chromosome exact)
    m = ori != 3
    pos_ok = (np.abs(best_payload[:, 4].astype(np.int64) - t_start)
              <= opts.window_size)
    chrom_ok = best_payload[:, 3] == t_chrom
    conc = float((m & pos_ok & chrom_ok).sum()) / max(1, int(m.sum()))
    e2e_wall = t_coarse_total + t_step2 + t_emit
    print(__import__("json").dumps({
        "genome_bases": total_bases,
        "n_sequences": genome.num_chromosomes,
        "n_regions": len(regions),
        "n_reads": n_reads,
        "index_bytes_total": int(idx_bytes),
        "build_s": round(t_build, 1),
        "coarse_map_s": round(t_map, 1),
        "step2_s": round(t_step2, 1),
        "e2e_wall_s": round(e2e_wall, 1),
        "e2e_reads_per_s": round(n_reads / e2e_wall, 1),
        "mapped_frac": round(n_mapped / n_reads, 4),
        "concordance_of_mapped": round(conc, 4),
        "sam": sam_stats,
    }))


if __name__ == "__main__":
    main()
