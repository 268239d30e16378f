"""Benchmark: BS-read mapping throughput on one GPU (3N configuration).

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "reads/s", "vs_baseline": R,
   "device": {...}, ...}

The flagship metric is the 3N (bisulfite) configuration on 90%-converted
reads — the project's actual workload (reference README.md:1 "3N hash based
readmapper for C->T BS conversion") — measured over the jitted coarse map
step (signatures -> CSR probe -> vote -> SHD -> per-read best) with the
read pool device-resident.  Extra keys report the end-to-end rate
(coarse + STEP-2 fine alignment/SAM + STEP-3 VCF, reference phase timers
src/gpu/main_gpu.cu:1147-1154) and the parity-mode coarse rate.  "device"
names the platform, kind and count JAX reports, and the card's name and
power limit from nvidia-smi.

Baseline provenance: the reference publishes no numbers (BASELINE.md).  The
documented estimate is its production SLURM shape — 10M reads / 6 GPUs
within a 20-minute walltime request (reference: scriptJob:10-17,40) — i.e.
>=8333 reads/s aggregate, ~1389 reads/s per GPU (an ESTIMATE, not a
measurement).  vs_baseline = value / 1389.

Without a GPU the bench exits non-zero before measuring; a failed stage
is listed under "error" and makes the exit code non-zero.
"""

import json
import sys
import time

import numpy as np

REFERENCE_READS_PER_SEC_PER_CHIP = 1389.0


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def make_genome_and_reads(rng, genome_len, n_reads, read_len, three_n,
                          chrom_name="chrB"):
    """One random chromosome and reads drawn from it: 1% substitutions,
    half reverse-complemented, 90% C->T in read space when three_n, and
    10% replaced by random junk.  Returns (genome, reads [N, L] int8,
    planted starts)."""
    from hashreadmapper_tpu.io.genome import Genome

    chrom_bases = rng.integers(0, 4, size=genome_len, dtype=np.int8)
    chrom = np.frombuffer(b"ACGT", np.uint8)[chrom_bases].tobytes().decode()
    genome = Genome([chrom_name], [chrom])

    starts = rng.integers(0, genome_len - read_len, size=n_reads)
    reads = chrom_bases[starts[:, None] + np.arange(read_len)[None, :]].copy()
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    if three_n:
        # bisulfite converts the sequenced strand: 90% of Cs read as T,
        # applied in READ space (after any reverse-complement)
        conv = (reads == 1) & (rng.random(reads.shape) < 0.9)
        reads[conv] = 3
    junk = rng.random(n_reads) < 0.10
    reads[junk] = rng.integers(0, 4, size=(int(junk.sum()), read_len),
                               dtype=np.int8)
    return genome, reads, starts


def coarse_rate(genome, reads, opts, label, reps=3):
    """Steady-state coarse rate over the device-resident read pool.

    One dispatch (lax.scan over the pool, engine.map_pool_scanned) timed
    through the host fetch of its result, which waits for the device.  The
    reported value is the median of `reps` repetitions; per-rep rates go
    to stderr so the run-to-run spread stays visible.
    """
    import jax
    import jax.numpy as jnp

    from hashreadmapper_tpu.pipeline.engine import CoarseMapper

    n_reads, read_len = reads.shape
    batch = opts.batchsize
    n_batches = n_reads // batch

    t0 = time.perf_counter()
    mapper = CoarseMapper(genome, opts)
    log(f"[{label}] index build: {time.perf_counter()-t0:.2f}s, "
        f"{mapper.index.memory_bytes()/1e6:.1f} MB, "
        f"{mapper.table.num_windows} windows")

    f = opts.num_hash_functions * (2 if opts.three_n_seeding else 1)
    dropped = (jnp.full((f, 1), jnp.uint32(0xFFFFFFFF), dtype=jnp.uint32),
               jnp.zeros((f,), dtype=jnp.int32))
    padded = np.pad(reads, ((0, 0), (0, opts.max_read_length - read_len)))
    all_bases = jnp.asarray(padded)
    all_lens = jnp.asarray(np.full(n_reads, read_len, dtype=np.int32))
    all_valid = jnp.ones((n_reads,), dtype=bool)
    np.asarray(all_bases)   # force the upload to finish before timing

    mapper.dropped = dropped

    def run_all():
        # one dispatch and one fetch, which waits for the device
        packed_dev, ovf_dev = mapper.map_pool_scanned(
            all_bases, all_lens, all_valid, n_batches * batch, batch)
        return np.asarray(packed_dev), np.asarray(ovf_dev)

    t0 = time.perf_counter()
    packed, ovf = run_all()
    log(f"[{label}] compile+first pass: {time.perf_counter()-t0:.2f}s")

    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        packed, ovf = run_all()
        dt = time.perf_counter() - t0
        rates.append(n_reads / dt)
    rps = float(np.median(rates))

    assert ovf[2] == 0, f"pair budget overflowed ({ovf[2]} dropped pairs)"
    assert ovf[3] == 0, f"probe tail budget overflowed ({ovf[3]} probes)"
    if len(ovf) > 4:
        assert ovf[4] == 0, f"probe head budget overflowed ({ovf[4]} probes)"
    n_mapped = int((packed[:, 0] != 3).sum())
    log(f"[{label}] {n_reads} reads x{reps}: "
        f"{'/'.join(f'{r:,.0f}' for r in rates)} reads/s (median {rps:,.0f})"
        f"; mapped {n_mapped}/{n_reads}; overflow {ovf.tolist()}")
    return rps, mapper, packed, n_reads / rps, ovf


def bench_options(three_n, probe_cap=16):
    """The bench configuration: README command widths (k=16, 16 tables,
    window 128, minTableHits 4) at batch 4096, with the compaction and
    two-tier probe budgets on.  Those are bit-identical while their
    overflow counters stay 0 (asserted in coarse_rate)."""
    from hashreadmapper_tpu.config import ProgramOptions

    return ProgramOptions(
        kmer_length=16, num_hash_functions=16, window_size=128,
        min_table_hits=4, batchsize=4096, max_hamming_percent=0.05,
        probe_cap=probe_cap, candidates_per_read_cap=8,
        max_read_length=128, threads=4, three_n_seeding=three_n,
        shd_pairs_per_read_budget=4, probe_tail_budget_per_read=4,
        # a read has at most 2F = 32 found probes; 18 covers the found
        # rate of these reads (asserted via the head overflow counter)
        probe_head_budget_per_read=18)


def card_label():
    """`name, power.limit` of the first card, from nvidia-smi (a child
    process, so it stays off JAX)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def device_info():
    """JAX's view of the device plus the card's name and power limit."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_label()}


def main():
    """Every stage is contained: a failing stage is logged, listed under
    "error", and the remaining stages still run; the one JSON line always
    reaches stdout, and the exit code is non-zero if any stage failed."""
    import traceback

    import jax

    from hashreadmapper_tpu.utils.jaxcache import configure_compile_cache

    configure_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found "
                 f"{jax.devices()[0].platform}")
    result = {
        "metric": "bs_reads_coarse_mapped_per_sec_per_chip",
        "value": 0.0,
        "unit": "reads/s",
        "vs_baseline": 0.0,
        "device": device_info(),
    }
    errors = []

    def stage(name, fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - reported, exit code set
            traceback.print_exc(file=sys.stderr)
            errors.append(f"{name}: {type(e).__name__}: {e}")
            return None

    stage("all", lambda: _run_stages(result, stage))
    if errors:
        result["error"] = "; ".join(errors)
    print(json.dumps(result))
    return 1 if errors else 0


def _run_stages(result, stage):
    import os
    import tempfile

    import jax

    from hashreadmapper_tpu.io.readstore import ReadStorage, pack_rows
    from hashreadmapper_tpu.pipeline import mapping

    log(f"device: {jax.devices()[0]} ({result['device']['card']})")
    rng = np.random.default_rng(0)
    genome_len = 8_000_000
    read_len = 100
    batch = bench_options(True).batchsize
    n_reads = batch * 12
    out_dir = tempfile.mkdtemp(prefix="hrm_bench_")
    out_base = os.path.join(out_dir, "bench_out")
    # --- flagship: 3N configuration on 90%-converted BS reads ---
    genome, reads, _ = make_genome_and_reads(
        rng, genome_len, n_reads, read_len, three_n=True)
    opts3 = bench_options(True)
    flagship = stage("coarse3n", lambda: coarse_rate(genome, reads, opts3,
                                                     "3N"))
    if flagship is None:
        mapper = packed = None
    else:
        rps_3n, mapper, packed, t_coarse, ovf3 = flagship
        result["value"] = round(rps_3n, 1)
        result["vs_baseline"] = round(
            rps_3n / REFERENCE_READS_PER_SEC_PER_CHIP, 2)
        # the flagship cap drops probe hits past probe_cap=16; report the
        # count and the mapped-rate delta vs an overflow-free cap below
        result["probe_overflow_3n"] = int(ovf3[0])

    def e2e():
        # --- end-to-end: the pipelined driver path (chunked coarse +
        # STEP 2 overlap, pipeline/driver.py::_pipelined_sw) -> SAM ->
        # VCF, measured wall-clock over all reads (reference "process
        # mapping"/"process variant calling" phases,
        # main_gpu.cu:1147-1154) ---
        from hashreadmapper_tpu.pipeline.driver import _pipelined_sw

        genome_rc = genome.reverse_complement()
        lengths = np.full(n_reads, read_len, np.int32)
        n_mapped_3n = int((packed[:, 0] != 3).sum())
        store = ReadStorage(
            pack_rows(reads, lengths, (read_len + 15) // 16),
            lengths, np.zeros(n_reads, bool))
        opts3.step2_pipeline_chunk = 8192
        padded = np.pad(
            reads, ((0, 0), (0, opts3.max_read_length - read_len))
        ).astype(np.int8)
        # warm the STEP-2 kernels at the FULL read-pool shape: the
        # streaming path's staged pool is an argument shape, so a smaller
        # warm pass would leave the full-size kernels to compile in rep 0
        _pipelined_sw(mapper, padded, store, genome, genome_rc, opts3)
        from hashreadmapper_tpu.pipeline.records import (MappingRecords,
                                                         emit_sam, emit_vcf)
        import gc
        e2e_rates = []
        for rep in range(3):        # median of 3; collect rep i's
            # buffers before rep i+1 starts
            gc.collect()
            t0 = time.perf_counter()
            results3, aas = _pipelined_sw(mapper, padded, store, genome,
                                          genome_rc, opts3)
            t_map = time.perf_counter() - t0
            if isinstance(aas, MappingRecords):
                sam_stats = emit_sam(aas, genome, out_base + ".SAM",
                                     threads=4)
                t_sam = time.perf_counter() - t0
                emit_vcf(aas, genome, out_base)
            else:
                sam_stats = mapping.print_to_sam(aas, genome,
                                                 out_base + ".SAM")
                t_sam = time.perf_counter() - t0
                mapping.do_vc(aas, genome, out_base)
            t_e2e = time.perf_counter() - t0
            log(f"[e2e] rep {rep}: map {t_map:.2f}s "
                f"sam +{t_sam - t_map:.2f}s vcf +{t_e2e - t_sam:.2f}s")
            e2e_rates.append(n_reads / t_e2e)
        rps_e2e = float(np.median(e2e_rates))
        log(f"[e2e] pipelined STEP1+2+3 ({sam_stats}); "
            f"{'/'.join(f'{r:,.0f}' for r in e2e_rates)} -> "
            f"e2e {rps_e2e:,.0f} reads/s")
        n3 = int((results3.orientation != 3).sum())
        assert n3 == n_mapped_3n, "pipelined coarse diverged from pool"
        result["e2e_sam_vcf_reads_per_sec"] = round(rps_e2e, 1)

    if mapper is not None:
        stage("e2e", e2e)

    def overflow_free_delta():
        # mapped-rate delta vs an overflow-free probe cap: same reads,
        # probe_cap high enough that nothing is
        # dropped (reference maxResultsPerMap=65535 drops nothing at this
        # genome's repeat structure either, options.hpp:36).  Only the
        # mapped fraction matters here, not the rate.
        opts_full = bench_options(True, probe_cap=128)
        rps_f, _m, packed_f, _t, ovf_f = coarse_rate(
            genome, reads, opts_full, "3N-nofull", reps=1)
        assert ovf_f[0] == 0, (
            f"probe_cap=128 still overflows ({int(ovf_f[0])})")
        mapped_cap = int((packed[:, 0] != 3).sum())
        mapped_full = int((packed_f[:, 0] != 3).sum())
        agree = float(np.mean(
            (packed[:, 0] == packed_f[:, 0])
            & ((packed[:, 4] == packed_f[:, 4]) | (packed_f[:, 0] == 3))))
        log(f"[overflow] mapped cap16 {mapped_cap} vs overflow-free "
            f"{mapped_full} ({mapped_cap - mapped_full:+d}); "
            f"agreement {agree:.4f}")
        result["mapped_delta_vs_overflow_free"] = mapped_cap - mapped_full
        result["mapped_rate_overflow_free"] = round(
            mapped_full / n_reads, 4)

    if packed is not None:
        stage("overflow_free", overflow_free_delta)

    def parity():
        # --- parity-mode coarse rate ---
        genome_p, reads_p, _ = make_genome_and_reads(
            rng, genome_len, n_reads, read_len, three_n=False)
        rps_parity, _, _, _, _ = coarse_rate(
            genome_p, reads_p, bench_options(False), "parity")
        result["parity_coarse_reads_per_sec"] = round(rps_parity, 1)

    stage("parity", parity)


if __name__ == "__main__":
    sys.exit(main())
