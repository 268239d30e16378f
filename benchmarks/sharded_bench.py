"""Sharded-vs-single per-device throughput.

Runs the same 3N workload through the single-chip inverted engine and
through ShardedCoarseMapper on a 1x1 mesh of the SAME chip, so the
difference is pure sharded-path overhead (shard_map + all_gather on a
1-element axis + the non-pool host driver).  With more real devices the
same script benches true (data x table) meshes.

Usage: python benchmarks/sharded_bench.py [genome_mbp] [data] [table]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hashreadmapper_tpu.config import ProgramOptions
    from hashreadmapper_tpu.io.genome import Genome
    from hashreadmapper_tpu.parallel.sharded import (ShardedCoarseMapper,
                                                     make_mesh)
    from hashreadmapper_tpu.pipeline.engine import CoarseMapper

    genome_mbp = float(sys.argv[1]) if len(sys.argv) > 1 else 8.0
    n_data = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    n_table = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    n_dev = n_data * n_table
    assert len(jax.devices()) >= n_dev, (
        f"need {n_dev} devices, have {len(jax.devices())}")

    rng = np.random.default_rng(3)
    g_len = int(genome_mbp * 1e6)
    batch, read_len = 2048, 100
    chrom_bases = rng.integers(0, 4, size=g_len, dtype=np.int8)
    chrom = (np.frombuffer(b"ACGT", dtype=np.uint8)[
        chrom_bases.astype(np.uint8)]).tobytes().decode()
    genome = Genome(["chrS"], [chrom])
    opts = ProgramOptions(
        kmer_length=16, num_hash_functions=16, window_size=128,
        min_table_hits=4, batchsize=batch, max_hamming_percent=0.05,
        probe_cap=16, candidates_per_read_cap=8, max_read_length=128,
        three_n_seeding=True, shd_pairs_per_read_budget=4,
        probe_tail_budget_per_read=4)

    n_reads = batch * n_data * 8
    reads = chrom_bases[rng.integers(0, g_len - read_len, n_reads)[:, None]
                        + np.arange(read_len)[None, :]].copy()
    conv = (reads == 1) & (rng.random(reads.shape) < 0.9)
    reads[conv] = 3
    reads = np.pad(reads, ((0, 0), (0, 28))).astype(np.int8)
    lens = np.full(n_reads, read_len, np.int32)

    # --- single-chip engine, steady per-batch rate ---
    t0 = time.time()
    single = CoarseMapper(genome, opts)
    single.ensure_empty_drops()
    print(f"single index build {time.time()-t0:.1f}s", flush=True)
    bdev = jax.block_until_ready(jnp.asarray(reads[:batch]))
    ldev = jax.block_until_ready(jnp.asarray(lens[:batch]))
    vdev = jax.block_until_ready(jnp.ones(batch, bool))
    step = lambda: single._map_batch(bdev, ldev, vdev, single.dropped[0],
                                     single.dropped[1])
    jax.block_until_ready(step())
    t0 = time.perf_counter()
    for _ in range(10):
        out = step()
    jax.block_until_ready(out)
    t_single = (time.perf_counter() - t0) / 10
    print(f"single-chip: {t_single*1e3:.2f} ms/batch -> "
          f"{batch/t_single:,.0f} reads/s/chip", flush=True)

    # --- sharded mapper on (n_data x n_table) mesh ---
    mesh = make_mesh(n_data, n_table)
    t0 = time.time()
    sharded = ShardedCoarseMapper(genome, opts, mesh)
    print(f"sharded index build {time.time()-t0:.1f}s "
          f"(per-device shard bytes: {sharded.index_memory_per_device()})",
          flush=True)
    gb = batch * n_data
    data_sh = NamedSharding(mesh, P("data"))
    args = [jax.device_put(jnp.asarray(x), data_sh)
            for x in (reads[:gb], lens[:gb], np.ones(gb, bool))]
    jax.block_until_ready(args)
    jax.block_until_ready(sharded.map_batch(*args))
    t0 = time.perf_counter()
    for _ in range(10):
        out = sharded.map_batch(*args)
    jax.block_until_ready(out)
    t_shard = (time.perf_counter() - t0) / 10
    rps = gb / t_shard
    print(f"sharded ({n_data}x{n_table}): {t_shard*1e3:.2f} ms/batch "
          f"({gb} reads) -> {rps:,.0f} reads/s total, "
          f"{rps/n_dev:,.0f} reads/s/chip "
          f"({rps/n_dev/(batch/t_single)*100:.0f}% of single-chip)",
          flush=True)


if __name__ == "__main__":
    main()
