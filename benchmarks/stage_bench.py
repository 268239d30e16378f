"""Coarse-step stage microbenchmark on the active backend.

Times each stage of the jitted mapping step separately (signatures, CSR
probe, vote, SHD) plus the fused step, with varied pre-staged inputs and
block_until_ready around every timed region (see PERF.md measurement
pitfalls).

Usage: python benchmarks/stage_bench.py [genome_mbp] [--threeN]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def timeit(fn, args, n=20):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    import jax
    import jax.numpy as jnp

    from hashreadmapper_tpu.config import ProgramOptions
    from hashreadmapper_tpu.index import minhash_index as mi
    from hashreadmapper_tpu.io.genome import Genome
    from hashreadmapper_tpu.ops import minhash
    from hashreadmapper_tpu.pipeline.engine import CoarseMapper

    genome_mbp = float(sys.argv[1]) if len(sys.argv) > 1 else 8.0
    three_n = "--threeN" in sys.argv
    g_len = int(genome_mbp * 1e6)
    read_len, batch = 100, 2048

    rng = np.random.default_rng(3)
    chrom_bases = rng.integers(0, 4, size=g_len, dtype=np.int8)
    chrom = (np.frombuffer(b"ACGT", dtype=np.uint8)[
        chrom_bases.astype(np.uint8)]).tobytes().decode("ascii")
    genome = Genome(["chrS"], [chrom])
    opts = ProgramOptions(
        kmer_length=16, num_hash_functions=16, window_size=128,
        min_table_hits=4, batchsize=batch, max_hamming_percent=0.05,
        probe_cap=16, candidates_per_read_cap=8, max_read_length=128,
        three_n_seeding=three_n, shd_pairs_per_read_budget=4,
        probe_tail_budget_per_read=4)
    t0 = time.time()
    mapper = CoarseMapper(genome, opts)
    mapper.ensure_empty_drops()
    print(f"index build {time.time()-t0:.1f}s; "
          f"{mapper.index.memory_bytes()/1e6:.0f} MB", flush=True)

    starts = rng.integers(0, g_len - read_len, size=batch)
    reads = chrom_bases[starts[:, None] + np.arange(read_len)[None, :]].copy()
    if three_n:
        conv = (reads == 1) & (rng.random(reads.shape) < 0.9)
        reads[conv] = 3
    reads = np.pad(reads, ((0, 0), (0, 28))).astype(np.int8)
    lens = np.full(batch, read_len, np.int32)
    bdev = jax.block_until_ready(jnp.asarray(reads))
    ldev = jax.block_until_ready(jnp.asarray(lens))
    vdev = jax.block_until_ready(jnp.ones(batch, bool))

    i = mapper.index
    hash_ids = mapper._hash_ids_dev

    # stage 1: signatures
    if three_n:
        def sigs_fn(b, l):
            ct = jnp.where(b == 1, jnp.int8(3), b)
            from hashreadmapper_tpu.ops import encode
            rc = encode.revcomp_bases(b, l)
            ga = jnp.where(rc == 2, jnp.int8(0), rc)
            s1, v = minhash.minhash_signatures(ct, l, 16, hash_ids,
                                               canonical=False)
            s2, _ = minhash.minhash_signatures(ga, l, 16, hash_ids,
                                               canonical=False)
            return jnp.concatenate([s1, s2], axis=1), v
    else:
        def sigs_fn(b, l):
            return minhash.minhash_signatures(b, l, 16, hash_ids)
    sigs_j = jax.jit(sigs_fn)
    t_sig = timeit(sigs_j, (bdev, ldev))
    sigs, sv = sigs_j(bdev, ldev)
    sigs = jax.block_until_ready(sigs)

    # stage 2: probe
    def probe_fn(s, v):
        return mi.probe_tables(i.keys, i.offsets, i.values, i.num_keys,
                               s, v, opts.probe_cap,
                               dropped_keys=mapper.dropped,
                               bucket_start=i.bucket_start,
                               probe_steps=i.probe_steps,
                               fnc_layout=True,
                               tail_budget=batch
                               * opts.probe_tail_budget_per_read)
    probe_j = jax.jit(probe_fn)
    t_probe = timeit(probe_j, (sigs, vdev))
    cand, counts, *_drops = probe_j(sigs, vdev)
    cand = jax.block_until_ready(cand)

    # stage 3: vote
    def vote_fn(c):
        return mi.vote_candidates(c.transpose(1, 0, 2), opts.min_table_hits,
                                  opts.candidates_per_read_cap)
    vote_j = jax.jit(vote_fn)
    t_vote = timeit(vote_j, (cand,))

    # fused step
    def step(b, l, v):
        return mapper._map_batch(b, l, v, mapper.dropped[0], mapper.dropped[1])
    t_step = timeit(step, (bdev, ldev, vdev), n=10)

    dens = float((np.asarray(cand) != 0xFFFFFFFF).mean())
    print(f"mode={'3N' if three_n else 'parity'} batch={batch}")
    print(f"signatures: {t_sig*1e3:7.2f} ms")
    print(f"probe:      {t_probe*1e3:7.2f} ms  (cand density {dens:.3f})")
    print(f"vote:       {t_vote*1e3:7.2f} ms")
    print(f"fused step: {t_step*1e3:7.2f} ms "
          f"-> {batch/t_step:,.0f} reads/s", flush=True)


if __name__ == "__main__":
    main()
