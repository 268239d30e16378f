"""Multi-process region-sharded mapping: a CPU-only topology rehearsal.

Rehearses the multi-host merge (parallel/multihost.py: regions span the
global device set of several jax.distributed processes, merged with the
region-mesh collective) on virtual CPU devices.  It says nothing about
speed.  On GPUs one process drives all local cards — as the reference's
SLURM `scriptJob` runs one process driving 6 GPUs — through run_pipeline
with --mesh or --regions; never start one process per card.

Modes:
  launcher (default):    spawns --nprocs local CPU worker processes with a
                         localhost coordinator and aggregates their JSON.
                             python benchmarks/multihost_bench.py --nprocs 2
  worker:                set --worker; topology from flags or from SLURM
                         (SLURM_PROCID/SLURM_NTASKS).

Each worker maps the full replicated read set against its local regions
(one region per addressable device), merges across processes, and checks
planted-read positions on the merged results.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--worker", action="store_true")
    p.add_argument("--proc", type=int, default=None)
    p.add_argument("--nprocs", type=int, default=None)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--devices-per-proc", type=int, default=2,
                   help="virtual CPU devices per process")
    p.add_argument("--genome-mbp", type=float, default=2.0)
    p.add_argument("--reads", type=int, default=4096)
    p.add_argument("--batchsize", type=int, default=512)
    return p.parse_args()


def launcher(args):
    nprocs = args.nprocs or 2
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    cmd_base = [sys.executable, os.path.abspath(__file__), "--worker",
                "--nprocs", str(nprocs), "--coordinator", coord,
                "--devices-per-proc", str(args.devices_per_proc),
                "--genome-mbp", str(args.genome_mbp),
                "--reads", str(args.reads),
                "--batchsize", str(args.batchsize)]
    t0 = time.time()
    procs = [subprocess.Popen(cmd_base + ["--proc", str(i)],
                              stdout=subprocess.PIPE, text=True, env=env)
             for i in range(nprocs)]
    outs = [p.communicate()[0] for p in procs]
    wall = time.time() - t0
    rows = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out)
            raise SystemExit(f"worker {i} failed rc={p.returncode}")
        rows.append(json.loads(
            [ln for ln in out.splitlines() if ln.startswith("{")][-1]))
    agg = {
        "nprocs": nprocs,
        "devices_total": nprocs * args.devices_per_proc,
        "wall_s": round(wall, 2),
        "map_s_max": max(r["map_s"] for r in rows),
        "mapped_frac": rows[0]["mapped_frac"],
        "exact_frac": rows[0]["exact_frac"],
        "merge_identical_across_procs": len(
            {r["merged_digest"] for r in rows}) == 1,
    }
    print(json.dumps(agg))


def worker(args):
    proc = args.proc if args.proc is not None else int(
        os.environ.get("SLURM_PROCID", 0))
    nprocs = args.nprocs or int(os.environ.get("SLURM_NTASKS", 1))
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
            f"{args.devices_per_proc}").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    # initialize the distributed runtime BEFORE any import that touches a
    # device (engine.py materializes module-level constants)
    from hashreadmapper_tpu.parallel import multihost
    if nprocs > 1:
        multihost.initialize(args.coordinator, nprocs, proc)

    from hashreadmapper_tpu.config import ProgramOptions
    from hashreadmapper_tpu.io.genome import Genome
    from hashreadmapper_tpu.parallel.region_sharded import region_key_payload
    from hashreadmapper_tpu.parallel.segments import partition_windows
    from hashreadmapper_tpu.pipeline.engine import CoarseMapper

    n_dev = len(jax.devices())

    # deterministic dataset, identical on every process
    g_len = int(args.genome_mbp * 1e6)
    read_len = 100
    rng = np.random.default_rng(123)
    chrom_bases = rng.integers(0, 4, size=g_len, dtype=np.int8)
    chrom = (np.frombuffer(b"ACGT", dtype=np.uint8)[
        chrom_bases.astype(np.uint8)]).tobytes().decode("ascii")
    genome = Genome(["chrM"], [chrom])
    n_reads = args.reads
    starts = rng.integers(0, g_len - read_len, size=n_reads)
    reads = chrom_bases[starts[:, None] + np.arange(read_len)[None, :]].copy()
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    reads = np.pad(reads, ((0, 0), (0, 28))).astype(np.int8)
    lens = np.full(n_reads, read_len, dtype=np.int32)

    opts = ProgramOptions(
        kmer_length=16, num_hash_functions=16, window_size=128,
        min_table_hits=4, batchsize=args.batchsize,
        max_hamming_percent=0.05, probe_cap=16,
        candidates_per_read_cap=8, max_read_length=128)

    regions = partition_windows(genome, opts, n_dev)
    chrom_gwin_base = np.zeros(1, dtype=np.int64)
    mesh = multihost.region_mesh()
    global_devs = list(jax.devices())

    mappers, staged = [], []
    t0 = time.time()
    for d in mesh.local_devices:
        gidx = global_devs.index(d)
        with jax.default_device(d):
            m = CoarseMapper(genome, opts, segments=regions[gidx])
            m.ensure_empty_drops()
            staged.append(m.stage_reads_device(reads, lens))
            mappers.append(m)
    build_s = time.time() - t0

    def run_local():
        packed = []
        # enqueue every region before any host sync (async dispatch)
        outs = []
        for m, (ab, al, av, n_pad) in zip(mappers, staged):
            with jax.default_device(m.table.genome_hi.device):
                outs.append(m._map_reads_device(ab, al, av, n_pad,
                                                opts.batchsize))
        for (pk, _, _) in outs:
            packed.append(np.asarray(pk)[:n_reads])
        return packed

    run_local()                      # compile warm-up
    t0 = time.time()
    packed = run_local()
    map_s = time.time() - t0

    local_keys, local_payloads = [], []
    for m, pk in zip(mappers, packed):
        key, payload, _ = region_key_payload(m, pk, chrom_gwin_base)
        local_keys.append(key)
        local_payloads.append(payload)
    t0 = time.time()
    if nprocs > 1 or n_dev > 1:
        merged_key, merged_payload = multihost.merge_region_results(
            mesh, local_keys, local_payloads)
    else:
        merged_key, merged_payload = local_keys[0], local_payloads[0]
    merge_s = time.time() - t0

    mapped = merged_key < 2**62
    exact = (merged_payload[mapped, 4] + merged_payload[mapped, 2]
             == starts[mapped])
    import hashlib
    digest = hashlib.sha256(merged_key.tobytes()
                            + merged_payload.tobytes()).hexdigest()[:16]
    print(json.dumps({
        "proc": proc, "nprocs": nprocs, "local_devices": len(mappers),
        "build_s": round(build_s, 2), "map_s": round(map_s, 3),
        "merge_s": round(merge_s, 3),
        "reads_per_s": round(n_reads / map_s),
        "mapped_frac": round(float(mapped.mean()), 4),
        "exact_frac": round(float(exact.mean()), 4),
        "merged_digest": digest,
    }), flush=True)


if __name__ == "__main__":
    a = parse_args()
    if a.worker:
        worker(a)
    else:
        launcher(a)
