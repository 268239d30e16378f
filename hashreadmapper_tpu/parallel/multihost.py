"""Multi-host runtime (jax.distributed over DCN).

The reference is strictly single-process multi-GPU (SURVEY.md §2.3: CUDA P2P
only, no MPI/NCCL).  This framework's multi-host story:

  * `initialize()` wraps jax.distributed.initialize — after it, the global
    device set spans all hosts and meshes can be built over `jax.devices()`
    with NVLink inside a host and the network across hosts.
  * data-parallel read layout: reads are partitioned per PROCESS (each host
    ingests its own shard of the input files, `process_read_slice`); coarse
    results are per-read and disjoint across hosts, so no merge is needed.
  * region-sharded genome layout: every host maps the (replicated) read
    batch against ITS genome regions; the global best per read is the min
    over regions of the associative key (hamming << 40 | global window
    ordinal) — `merge_region_results` runs that reduction as a shard_map
    collective over a "region" mesh axis (pmin for the key, winner-masked
    pmax for the payload), so the result is bit-equal to the single-process
    RegionShardedMapper merge (parallel/region_sharded.py phase 2) on any
    process count.

Exercised for real by tests/test_multihost.py: a 2-process CPU
`jax.distributed` harness (localhost coordinator) whose merged results are
asserted equal to the single-process whole-genome mapper's.

On device the key is decomposed into three int32 components (hamming,
window-ordinal high bits, low bits) reduced lexicographically with staged
pmin — no 64-bit device arithmetic, so jax_enable_x64 is NOT required.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

INT32_MIN = -(2**31)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with explicit or env-derived topology."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def process_read_slice(num_reads: int, num_processes: int,
                       process_id: int) -> Tuple[int, int]:
    """Contiguous per-process read range [start, stop).

    Mirrors the even-share row partitioning of the reference's
    MultiGpu2dArray (multigpuarray.cuh:1315-1345) at host granularity."""
    per = (num_reads + num_processes - 1) // num_processes
    start = min(process_id * per, num_reads)
    stop = min(start + per, num_reads)
    return start, stop


def region_mesh(devices=None):
    """1-D 'region' mesh over the global device set (one region/device)."""
    import jax
    import numpy as np

    devs = np.array(jax.devices() if devices is None else devices)
    return jax.sharding.Mesh(devs, ("region",))


def merge_region_results(mesh, local_keys: Sequence, local_payloads: Sequence):
    """Cross-host min-reduction of per-region results.

    local_keys: one [N] int64 array per ADDRESSABLE device of `mesh`, in
    `mesh.local_devices` order — this process's regions' best keys
    ((hamming << 40) | global window ordinal; 2**62 = unmapped).
    local_payloads: matching [N, P] int32 payload rows (orientation,
    hamming, shift, chrom, pos, ... — any int32 fields; negative values
    are fine, losers are masked with INT32_MIN, not -1).

    Returns (merged_key [N] int64, merged_payload [N, P] int32) as numpy,
    identical on every process.  Keys are unique per (read, window) since
    regions partition the windows, so the winner mask selects exactly one
    region's payload (all regions agree on the unmapped filler row).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = local_keys[0].shape[0]
    p = local_payloads[0].shape[1]
    r = mesh.devices.size

    def split_key(k):
        """int64 key -> int32 components (ham, gwin_hi, gwin_lo)."""
        k = np.asarray(k, dtype=np.int64)
        ham = (k >> 40).astype(np.int32)
        g = k & ((1 << 40) - 1)
        return np.stack([ham, (g >> 31).astype(np.int32),
                         (g & 0x7FFFFFFF).astype(np.int32)], axis=1)

    key_sh = NamedSharding(mesh, P("region"))
    pay_sh = NamedSharding(mesh, P("region"))
    key_parts = [jax.device_put(split_key(k)[None], d)
                 for k, d in zip(local_keys, mesh.local_devices)]
    pay_parts = [jax.device_put(np.asarray(q, dtype=np.int32)[None], d)
                 for q, d in zip(local_payloads, mesh.local_devices)]
    gkey = jax.make_array_from_single_device_arrays((r, n, 3), key_sh,
                                                    key_parts)
    gpay = jax.make_array_from_single_device_arrays((r, n, p), pay_sh,
                                                    pay_parts)

    def reduce_fn(key, payload):          # key [1, N, 3], payload [1, N, P]
        key, payload = key[0], payload[0]
        big = jnp.int32(2**31 - 1)
        # staged lexicographic pmin over the int32 components
        b0 = jax.lax.pmin(key[:, 0], "region")
        m = key[:, 0] == b0
        b1 = jax.lax.pmin(jnp.where(m, key[:, 1], big), "region")
        m = m & (key[:, 1] == b1)
        b2 = jax.lax.pmin(jnp.where(m, key[:, 2], big), "region")
        m = m & (key[:, 2] == b2)
        masked = jnp.where(m[:, None], payload, jnp.int32(INT32_MIN))
        return (jnp.stack([b0, b1, b2], axis=1),
                jax.lax.pmax(masked, "region"))

    fn = jax.shard_map(reduce_fn, mesh=mesh,
                       in_specs=(P("region"), P("region")),
                       out_specs=(P(), P()), check_vma=False)
    out_key, out_pay = jax.jit(fn)(gkey, gpay)
    # replicated outputs: every process can read its addressable shard
    kc = np.asarray(out_key.addressable_data(0)).astype(np.int64)
    merged_key = (kc[:, 0] << 40) | (kc[:, 1] << 31) | kc[:, 2]
    p_local = np.asarray(out_pay.addressable_data(0))
    return merged_key, p_local
