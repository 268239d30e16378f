"""Whole-GRCh38-scale smoke: map reads against a >2^31-base genome.

Proves the >2 Gbp capability: a synthetic
multi-chromosome genome larger than the int32 staged-gather limit routes
through RegionShardedMapper's intra-chromosome window partition, and reads
planted ON the cut boundaries map to exact positions.

Runs on whatever backend is active (CPU by default here: the partition +
merge logic is backend-independent; per-region device placement is
round-robin, so ONE device suffices).

Usage: python benchmarks/big_genome_smoke.py [total_gbp] [n_reads]
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

from hashreadmapper_tpu.config import ProgramOptions
from hashreadmapper_tpu.io.genome import Genome
from hashreadmapper_tpu.parallel.region_sharded import RegionShardedMapper
from hashreadmapper_tpu.parallel.segments import partition_windows


def main():
    total_bases = int(float(sys.argv[1]) * 1e9) if len(sys.argv) > 1 \
        else 2_300_000_000
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    read_len = 100
    # 3 chromosomes with a region count that is not a multiple of 3
    # guarantees INTRA-chromosome cuts (the capability under test)
    n_chrom = 3
    clen = total_bases // n_chrom
    rng = np.random.default_rng(0)

    print(f"genome: {n_chrom} x {clen/1e9:.2f} Gbp "
          f"(total {n_chrom*clen/1e9:.2f} Gbp)", flush=True)
    t0 = time.time()
    # build each chromosome as random bases directly (bytes -> str once)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    chroms = []
    for c in range(n_chrom):
        codes = rng.integers(0, 4, clen, dtype=np.uint8)
        chroms.append(lut[codes].tobytes().decode("ascii"))
        del codes
    genome = Genome([f"chr{c+1}" for c in range(n_chrom)], chroms)
    del chroms
    print(f"genome built in {time.time()-t0:.0f}s", flush=True)

    opts = ProgramOptions(
        kmer_length=16, num_hash_functions=4, window_size=128,
        min_table_hits=2, batchsize=512, max_hamming_percent=0.05,
        probe_cap=16, candidates_per_read_cap=8, max_read_length=read_len)

    # figure out where the cuts will fall so reads can be planted ON them
    n_regions = int(sys.argv[3]) if len(sys.argv) > 3 else \
        max(len(jax.devices()), -(-total_bases // (2**31 - 2**27)))
    regions = partition_windows(genome, opts, n_regions)
    cut_positions = []  # (chrom, base pos) of intra-chromosome cut points
    for r in regions:
        s = r[0]
        if s.win_start != 0:
            cut_positions.append((s.chrom_id,
                                  s.win_start * opts.window_stride))
    print(f"{n_regions} regions, {len(cut_positions)} intra-chromosome cuts",
          flush=True)

    # plant reads: half uniform, half straddling cut points
    bases = np.zeros((n_reads, read_len), dtype=np.int8)
    lens = np.full(n_reads, read_len, dtype=np.int32)
    truth = np.zeros((n_reads, 2), dtype=np.int64)  # (chrom, pos)
    for i in range(n_reads):
        if cut_positions and i % 2 == 0:
            c, cut = cut_positions[(i // 2) % len(cut_positions)]
            pos = cut - read_len // 2 + (i % read_len) - read_len // 2
            pos = max(0, min(pos, genome.chromosome_length(c) - read_len))
        else:
            c = int(rng.integers(0, n_chrom))
            pos = int(rng.integers(0, clen - read_len))
        seq = genome.bases[c][pos:pos + read_len].astype(np.int8)
        if i % 3 == 0:  # reverse-complement a third
            seq = (3 - seq)[::-1].copy()
        bases[i] = seq
        truth[i] = (c, pos)

    t0 = time.time()
    mapper = RegionShardedMapper(genome, opts, n_regions)
    print(f"region mappers + indexes built in {time.time()-t0:.0f}s",
          flush=True)

    t0 = time.time()
    res = mapper.map_reads(bases, lens)
    dt = time.time() - t0
    mapped = res.orientation != 3
    # coarse window position must cover the planted location
    win_lo = res.position.astype(np.int64)
    win_hi = win_lo + opts.window_size + read_len
    pos_ok = (mapped & (res.chromosome_id == truth[:, 0])
              & (truth[:, 1] >= win_lo - read_len) & (truth[:, 1] < win_hi))
    print(f"mapped {mapped.sum()}/{n_reads} in {dt:.0f}s "
          f"({n_reads/dt:.0f} reads/s); "
          f"exact-region positions {pos_ok.sum()}/{mapped.sum()}",
          flush=True)
    # cut-straddling reads specifically
    cut_reads = np.arange(n_reads) % 2 == 0 if cut_positions else \
        np.zeros(n_reads, dtype=bool)
    if cut_reads.any():
        print(f"cut-boundary reads: {int((mapped & cut_reads).sum())}"
              f"/{int(cut_reads.sum())} mapped, "
              f"{int((pos_ok & cut_reads).sum())} exact", flush=True)
    # the smoke proves int32-safety + cut-boundary correctness: every
    # mapped read must land exactly; recall at this reduced hash count
    # (F=4 for build speed) is lower than the bench config's 97.5%
    assert pos_ok.sum() >= 0.99 * mapped.sum(), "position concordance <99%"
    assert mapped.sum() >= 0.6 * n_reads, "mapping rate <60%"
    print("BIG GENOME SMOKE OK", flush=True)


if __name__ == "__main__":
    main()
