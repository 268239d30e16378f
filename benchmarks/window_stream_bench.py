"""Window-stream (reference-orientation) throughput on the device.

Times pipeline/window_stream.py (device-side window-base gather).  The
reference's own architecture indexes the READS and streams genome
windows through the index (reference: src/gpu/main_gpu.cu:484-514).

Usage: python benchmarks/window_stream_bench.py [genome_mbp] [n_reads]
Wall-clock timing is honest: map_genome's host merge fetches every
per-batch result before returning.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from hashreadmapper_tpu.config import ProgramOptions
    from hashreadmapper_tpu.io.genome import Genome
    from hashreadmapper_tpu.pipeline.window_stream import WindowStreamMapper

    genome_mbp = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 49_152
    read_len = 100

    log(f"device: {jax.devices()[0]}")
    rng = np.random.default_rng(3)
    g_len = genome_mbp * 1_000_000
    chrom_bases = rng.integers(0, 4, size=g_len, dtype=np.int8)
    chrom = (np.frombuffer(b"ACGT", dtype=np.uint8)[
        chrom_bases.astype(np.uint8)]).tobytes().decode("ascii")
    genome = Genome([f"chr{genome_mbp}M"], [chrom])
    starts = rng.integers(0, g_len - read_len, size=n_reads)
    reads = chrom_bases[starts[:, None] + np.arange(read_len)[None, :]].copy()
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    conv = (reads == 1) & (rng.random(reads.shape) < 0.9)
    reads[conv] = 3
    lengths = np.full(n_reads, read_len, np.int32)

    opts = ProgramOptions(
        kmer_length=16, num_hash_functions=16, window_size=128,
        min_table_hits=4, batchsize=4096, max_hamming_percent=0.05,
        probe_cap=16, candidates_per_read_cap=8, max_read_length=128,
        three_n_seeding=True,
        # pair compaction + two-tier/head-compacted probe in the window
        # orientation (bit-identical; counters asserted below)
        shd_pairs_per_read_budget=4, probe_tail_budget_per_read=4,
        probe_head_budget_per_read=18)

    t0 = time.perf_counter()
    mapper = WindowStreamMapper(reads, lengths, opts)
    log(f"read-index build ({n_reads:,} reads): "
        f"{time.perf_counter()-t0:.1f}s")

    t0 = time.perf_counter()
    res = mapper.map_genome(genome)      # compile + first pass
    log(f"map_genome(first, incl compile): {time.perf_counter()-t0:.1f}s")
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = mapper.map_genome(genome)
        rates.append(n_reads / (time.perf_counter() - t0))
    for k in ("pair_budget_overflow", "probe_tail_overflow",
              "probe_head_overflow"):
        assert res.stats.get(k, 0) == 0, (k, res.stats)
    m = res.orientation != 3
    exact = int((res.position[m] + res.shift[m] == starts[m]).sum())
    n_windows = -(-(g_len - opts.kmer_length + 1) // opts.window_size)
    wps = n_windows * float(np.median(rates)) / n_reads
    print(f"window_stream: {genome_mbp} Mbp / {n_reads:,} reads: "
          f"{'/'.join(f'{r:,.0f}' for r in rates)} -> "
          f"{float(np.median(rates)):,.0f} reads/s "
          f"({wps:,.0f} windows/s); mapped {int(m.sum()):,} "
          f"({100*m.mean():.1f}%), exact {exact:,}", flush=True)


if __name__ == "__main__":
    main()
