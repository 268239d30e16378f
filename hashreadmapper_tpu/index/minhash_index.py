"""Static CSR minhash index in device memory + fixed-shape probe/vote kernels.

Design (SURVEY.md §7.1): the reference's warpcore open-addressing tables
converge to a compacted CSR after build anyway (reference:
include/gpu/gpuhashtable.cuh:726-833 — key->slot table + offsets[] + values[]);
the CPU path is CSR from the start (include/cpuhashtable.hpp:465-679).  We
build that CSR directly with sort/group-by (the GroupByKey design,
include/groupbykey.hpp:68-158) and probe it on device with a vectorized
binary search + capped gather — no probing loops, fully static shapes.

The engine runs in the *genome-index* orientation (BASELINE.json north
star): the index maps signature -> window ids and reads stream through as
queries.  Candidate sets are identical to the reference's inverted
orientation because signature equality is symmetric; the reference's
max-results-per-map key dropping (which happens on the READ side there,
groupbykey.hpp:60-67) is reproduced exactly via `dropped_keys` masks computed
from the read-signature histogram (see build_dropped_keys).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

SENTINEL = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass
class CsrIndex:
    """One CSR hash table per hash function, padded to uniform widths.

    keys:     [F, U] uint32, ascending per row, padded with SENTINEL
    offsets:  [F, U+1] int32 value offsets per key (CSR)
    values:   [F, V] uint32 item ids, grouped by key, ascending within key
    num_keys: [F] int32
    """
    keys: jnp.ndarray
    offsets: jnp.ndarray
    values: jnp.ndarray
    num_keys: jnp.ndarray
    kmer_length: int
    hash_ids: np.ndarray
    # optional radix probe directory (build_probe_buckets)
    bucket_start: Optional[jnp.ndarray] = None
    probe_steps: int = 0
    bucket_bits: int = 16
    # optional cuckoo direct-probe table (build_cuckoo): a query costs two
    # key gathers + one packed (offset, count) gather instead of
    # log2(bucket) binary-search passes
    cuckoo_keys: Optional[jnp.ndarray] = None      # [F, 2^bits] uint32
    cuckoo_payload: Optional[jnp.ndarray] = None   # [F, 2^bits] off<<10|cnt
    cuckoo_bits: int = 0
    cuckoo_seeds: Tuple[int, int] = (0, 0)
    # why the last build_cuckoo call fell back to the binary search
    # (None = cuckoo built / never attempted); surfaced in run stats so a
    # silent production perf regression is visible (PERF.md gap #5)
    cuckoo_fallback_reason: Optional[str] = None
    # region mode only (parallel/region_sharded.py): the keys whose first
    # value in genome order lies in this region's index and whose values
    # over the whole genome exceed the probe cap, with that genome-wide
    # count ([F, D] uint32 SENTINEL-padded, [F, D] int32, [F] int32)
    overflow_keys: Optional[Tuple[jnp.ndarray, jnp.ndarray,
                                  jnp.ndarray]] = None

    def build_buckets(self) -> None:
        # size the radix directory so buckets average ~2 keys: the probe's
        # binary search then needs only 1-3 gather passes regardless of
        # index scale (a 2.2M-key chr1 table at the old fixed 16 bits cost
        # 6-7 passes).  Capped at 22 bits (dir = F x 16 MB) — small next to
        # the value arrays it accelerates.
        n_keys = max(1, int(jnp.max(self.num_keys)))
        self.bucket_bits = int(np.clip(np.ceil(np.log2(n_keys)), 12, 22))
        self.bucket_start = build_probe_buckets(self.keys, self.num_keys,
                                                self.bucket_bits)
        sizes = self.bucket_start[:, 1:] - self.bucket_start[:, :-1]
        max_bucket = int(jnp.max(sizes))
        self.probe_steps = max(1, int(np.ceil(np.log2(max_bucket + 1))))

    def build_cuckoo(self) -> bool:
        """Host-built 2-choice cuckoo slot table over the CSR keys.

        The static-shape analog of the reference's warpcore open addressing
        (gpuhashtable.cuh:726-833): slots are assigned once on the host
        (native/cuckoo.cpp — kicking is sequential) and queried with three
        fixed-shape vector gathers.  The payload packs (value offset << 10
        | min(count, 1023)): counts saturate at 1023, so this path is only
        valid when probe_cap < 1023 and no max_values_per_key rule applies
        (probe_tables asserts).  Returns False (leaving the binary-search
        path in place) when the native builder is unavailable, a table is
        too big for the 22-bit offset field, or insertion fails.
        """
        built, reason = build_cuckoo_arrays(
            np.asarray(self.keys), np.asarray(self.offsets),
            np.asarray(self.num_keys), int(self.values.shape[1]))
        if built is None:
            self.cuckoo_fallback_reason = reason
            return False
        self.cuckoo_fallback_reason = None
        ck, payload, bits, seeds = built
        self.cuckoo_keys = jnp.asarray(ck)
        self.cuckoo_payload = jnp.asarray(payload)
        self.cuckoo_bits = bits
        self.cuckoo_seeds = seeds
        return True

    @property
    def num_tables(self) -> int:
        return int(self.keys.shape[0])

    def memory_bytes(self) -> int:
        total = (self.keys.nbytes + self.offsets.nbytes + self.values.nbytes
                 + self.num_keys.nbytes)
        for a in (self.bucket_start, self.cuckoo_keys, self.cuckoo_payload,
                  *(self.overflow_keys or ())):
            if a is not None:
                total += a.nbytes
        return total

    def save(self, path: str) -> None:
        """Index artifact (replaces --save-hashtables-to,
        reference: gpuminhasherconstruction.cu:311-319)."""
        np.savez_compressed(
            path,
            keys=np.asarray(self.keys), offsets=np.asarray(self.offsets),
            values=np.asarray(self.values), num_keys=np.asarray(self.num_keys),
            kmer_length=self.kmer_length, hash_ids=self.hash_ids)

    @classmethod
    def load(cls, path: str) -> "CsrIndex":
        d = np.load(path)
        return cls(jnp.asarray(d["keys"]), jnp.asarray(d["offsets"]),
                   jnp.asarray(d["values"]), jnp.asarray(d["num_keys"]),
                   int(d["kmer_length"]), d["hash_ids"])


def build_cuckoo_arrays(keys_np: np.ndarray, offs_np: np.ndarray,
                        nk: np.ndarray, v_cols: int):
    """Numpy cuckoo-table arrays for CsrIndex.build_cuckoo (and for the
    sharded mapper, which device_puts them with a table sharding instead
    of staging them on one device).  Returns ((keys [F, 2^bits] uint32,
    payload [F, 2^bits] uint32, bits, (seed1, seed2)), None) or
    (None, reason)."""
    from .. import native
    if native.cuckoo_build(np.zeros(0, np.uint32), 8, 0, 0) is None:
        return None, "native cuckoo builder unavailable"
    if v_cols >= (1 << 22):
        return None, (f"value array width {v_cols} exceeds the 22-bit "
                      "payload offset field")
    max_keys = int(nk.max()) if len(nk) else 0
    if max_keys == 0:
        return None, "empty index"
    f = keys_np.shape[0]
    base_bits = max(10, int(np.ceil(np.log2(max(2 * max_keys, 2)))))
    for attempt in range(4):
        bits = min(base_bits + (attempt + 1) // 2, 26)
        seed1 = 0x5D588B65 * (attempt + 1) & 0xFFFFFFFF
        seed2 = 0x2545F491 * (attempt + 1) & 0xFFFFFFFF
        ck = np.full((f, 1 << bits), SENTINEL, dtype=np.uint32)
        payload = np.zeros((f, 1 << bits), dtype=np.uint32)
        ok = True
        for t in range(f):
            kt = keys_np[t, :nk[t]]
            if (kt == SENTINEL).any():   # SENTINEL doubles as "empty"
                return None, "a key equals the SENTINEL/empty marker"
            slots = native.cuckoo_build(kt, bits, seed1, seed2)
            if slots is None:
                ok = False
                break
            off0 = offs_np[t, :nk[t]].astype(np.int64)
            cnt = offs_np[t, 1:nk[t] + 1].astype(np.int64) - off0
            ck[t, slots] = kt
            payload[t, slots] = ((off0.astype(np.uint32) << 10)
                                 | np.minimum(cnt, 1023).astype(np.uint32))
        if ok:
            return (ck, payload, bits, (seed1, seed2)), None
    return None, "cuckoo insertion failed after 4 seed attempts"


def build_csr_index(signatures: np.ndarray, valid: np.ndarray,
                    kmer_length: int, hash_ids: Sequence[int],
                    max_values_per_key: Optional[int] = None) -> CsrIndex:
    """Host (numpy) CSR build: sort by key, group, optionally drop full keys.

    Args:
      signatures: [N, F] uint32 signatures of the indexed items.
      valid: [N] bool; invalid items are not inserted (reference inserts only
        valid signatures, fakegpuminhasher.cuh:639-668).
      max_values_per_key: keys with MORE values than this lose all values
        (reference: groupbykey.hpp:60-67).  None = keep everything.
    """
    n, f = signatures.shape
    keys_l, offs_l, vals_l, nkeys = [], [], [], []
    ids = np.arange(n, dtype=np.uint32)
    for t in range(f):
        sig_t = signatures[valid, t]
        val_t = ids[valid]
        order = np.lexsort((val_t, sig_t))
        sig_s, val_s = sig_t[order], val_t[order]
        ukeys, starts, counts = np.unique(
            sig_s, return_index=True, return_counts=True)
        dropping = (max_values_per_key is not None
                    and (counts > max_values_per_key).any())
        if dropping:
            keep = counts <= max_values_per_key
            ukeys, starts, counts = ukeys[keep], starts[keep], counts[keep]
        offsets = np.zeros(len(ukeys) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        if dropping and len(ukeys):
            # vectorized re-pack of surviving keys' value runs
            idx = (np.repeat(starts, counts)
                   + np.arange(offsets[-1], dtype=np.int64)
                   - np.repeat(offsets[:-1], counts))
            vals_packed = val_s[idx]
        else:
            vals_packed = val_s if len(ukeys) else val_s[:0]
        keys_l.append(ukeys.astype(np.uint32))
        offs_l.append(offsets)
        vals_l.append(vals_packed.astype(np.uint32))
        nkeys.append(len(ukeys))

    u_max = max(1, max(len(kk) for kk in keys_l))
    v_max = max(1, max(len(vv) for vv in vals_l))
    keys = np.full((f, u_max), SENTINEL, dtype=np.uint32)
    offsets = np.zeros((f, u_max + 1), dtype=np.int32)
    values = np.full((f, v_max), SENTINEL, dtype=np.uint32)
    for t in range(f):
        u = len(keys_l[t])
        keys[t, :u] = keys_l[t]
        offsets[t, :u + 1] = offs_l[t]
        offsets[t, u + 1:] = offs_l[t][-1]
        values[t, :len(vals_l[t])] = vals_l[t]
    return CsrIndex(
        keys=jnp.asarray(keys), offsets=jnp.asarray(offsets),
        values=jnp.asarray(values),
        num_keys=jnp.asarray(np.array(nkeys, dtype=np.int32)),
        kmer_length=kmer_length,
        hash_ids=np.asarray(hash_ids, dtype=np.uint32))


def build_dropped_keys(signatures: np.ndarray, valid: np.ndarray,
                       max_values_per_key: int) -> np.ndarray:
    """Per-table sorted arrays of signature keys exceeding the value cap.

    Emulates the reference's read-index key dropping in the inverted
    orientation: a (query, table) probe whose own signature is a dropped key
    must be skipped, because in the reference that table never stored any of
    those reads (groupbykey.hpp:60-67).

    Returns ([F, D] uint32 padded with SENTINEL, [F] int32 counts).
    """
    n, f = signatures.shape
    dropped = []
    for t in range(f):
        sig_t = signatures[valid, t]
        ukeys, counts = np.unique(sig_t, return_counts=True)
        dropped.append(ukeys[counts > max_values_per_key].astype(np.uint32))
    d_max = max(1, max(len(d) for d in dropped))
    out = np.full((f, d_max), SENTINEL, dtype=np.uint32)
    for t in range(f):
        out[t, :len(dropped[t])] = dropped[t]
    return out, np.array([len(d) for d in dropped], dtype=np.int32)


@jax.jit
def _build_one_table_device(sigs_col: jnp.ndarray, valid: jnp.ndarray):
    """Device CSR build for one table (static shapes, padded to N items).

    Returns (keys[N] asc + SENTINEL pad, offsets[N+1], values[N], num_keys).
    The reference's GroupByKey is exactly this radix-sort + reduce_by_key
    (groupbykey.hpp:68-158); the warpcore path also compacts to this CSR
    (gpuhashtable.cuh:726-833).
    """
    n = sigs_col.shape[0]
    ids = jnp.arange(n, dtype=jnp.uint32)
    key_in = jnp.where(valid, sigs_col, jnp.uint32(SENTINEL))
    order = jnp.argsort(key_in, stable=True)
    keys_sorted = key_in[order]
    vals_sorted = ids[order]

    is_real = keys_sorted != jnp.uint32(SENTINEL)
    prev = jnp.concatenate([jnp.full((1,), SENTINEL, dtype=jnp.uint32),
                            keys_sorted[:-1]])
    iota = jnp.arange(n, dtype=jnp.int32)
    is_start = ((keys_sorted != prev) | (iota == 0)) & is_real
    rank = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    num_keys = jnp.max(jnp.where(is_start, rank + 1, 0))

    keys_u = jnp.full((n,), SENTINEL, dtype=jnp.uint32)
    keys_u = keys_u.at[jnp.where(is_start, rank, n)].set(
        keys_sorted, mode="drop")
    n_valid = jnp.sum(is_real.astype(jnp.int32))
    offsets = jnp.full((n + 1,), 0, dtype=jnp.int32)
    offsets = offsets.at[jnp.where(is_start, rank, n + 1)].set(
        iota, mode="drop")
    offsets = offsets.at[jnp.minimum(num_keys, n)].set(n_valid)
    values = jnp.where(is_real, vals_sorted, jnp.uint32(SENTINEL))
    return keys_u, offsets, values, num_keys


def build_csr_index_device(signatures, valid, kmer_length: int,
                           hash_ids) -> CsrIndex:
    """All-device CSR build: one vmapped sort/scatter per table.

    No key dropping (used for the window index, whose keys are never capped
    — see build_csr_index for the capped host build).  Arrays stay on device;
    padded key width U equals the item count N.
    """
    sigs = jnp.asarray(signatures)
    v = jnp.asarray(valid)
    keys, offsets, values, num_keys = jax.vmap(
        _build_one_table_device, in_axes=(1, None))(sigs, v)
    return CsrIndex(keys=keys, offsets=offsets, values=values,
                    num_keys=num_keys, kmer_length=kmer_length,
                    hash_ids=np.asarray(hash_ids, dtype=np.uint32))


# ---------------------------------------------------------------------------
# device probe
# ---------------------------------------------------------------------------

def _row_searchsorted(keys_row: jnp.ndarray, queries: jnp.ndarray
                      ) -> jnp.ndarray:
    return jnp.searchsorted(keys_row, queries, side="left")


def _sorted_member(keys: jnp.ndarray, num: jnp.ndarray, queries: jnp.ndarray):
    """Per-table membership of [F, N] queries in the ascending [F, D]
    rows `keys` (first num[f] entries valid).  Returns (hit [F, N] bool,
    column [F, N] int32 clipped into the row)."""
    idx = jax.vmap(_row_searchsorted)(keys, queries)
    idx_c = jnp.minimum(idx, keys.shape[1] - 1)
    hit = ((jnp.take_along_axis(keys, idx_c, axis=1) == queries)
           & (idx < num[:, None]))
    return hit, idx_c


BUCKET_BITS = 16   # default directory width (CsrIndex.build_buckets adapts)


def build_probe_buckets(keys: jnp.ndarray, num_keys: jnp.ndarray,
                        bits: int = BUCKET_BITS) -> jnp.ndarray:
    """Per-table first-level radix directory over the top `bits` bits.

    bucket_start[f, b] = index of the first key in table f whose top bits
    are >= b; bucket_start[f, 2^bits] = num_keys[f].  Narrows the probe's
    binary search from log2(U) to log2(max bucket size) gather steps.
    Built on device (one vmapped searchsorted per table).
    """
    f, u = keys.shape
    tops = jnp.arange((1 << bits) + 1, dtype=jnp.uint32) << (32 - bits)
    # search each boundary value in each table's key row
    starts = jax.vmap(lambda kr: jnp.searchsorted(kr, tops[:-1], side="left")
                      )(keys)
    starts = jnp.minimum(starts.astype(jnp.int32), num_keys[:, None])
    return jnp.concatenate([starts, num_keys[:, None]], axis=1)


def _bucketed_lower_bound(keys: jnp.ndarray, bucket_start: jnp.ndarray,
                          queries: jnp.ndarray, steps: int) -> jnp.ndarray:
    """Branchless lower_bound per (table, query) with a radix head start.

    keys: [F, U]; bucket_start: [F, 2^bits + 1]; queries: [F, N].  The
    directory width is recovered from bucket_start's static shape.
    """
    bits = int(bucket_start.shape[1] - 1).bit_length() - 1
    b = (queries >> (32 - bits)).astype(jnp.int32)
    lo = jnp.take_along_axis(bucket_start, b, axis=1)
    hi = jnp.take_along_axis(bucket_start, b + 1, axis=1)
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        kmid = jnp.take_along_axis(keys, jnp.minimum(mid, keys.shape[1] - 1),
                                   axis=1)
        go_right = active & (kmid < queries)
        new_lo = jnp.where(go_right, mid + 1, lo)
        new_hi = jnp.where(active & ~go_right, mid, hi)
        lo, hi = new_lo, new_hi
    return lo


@partial(jax.jit, static_argnames=("probe_cap", "probe_steps",
                                   "max_values_per_key", "fnc_layout",
                                   "tail_budget", "head_budget",
                                   "cuckoo_bits", "cuckoo_seeds"))
def probe_tables(index_keys: jnp.ndarray, index_offsets: jnp.ndarray,
                 index_values: jnp.ndarray, index_num_keys: jnp.ndarray,
                 sigs: jnp.ndarray, sig_valid: jnp.ndarray,
                 probe_cap: int,
                 dropped_keys: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
                 bucket_start: Optional[jnp.ndarray] = None,
                 probe_steps: int = 0,
                 max_values_per_key: int = 0,
                 fnc_layout: bool = False,
                 tail_budget: int = 0,
                 head_budget: int = 0,
                 cuckoo: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
                 cuckoo_bits: int = 0,
                 cuckoo_seeds: Tuple[int, int] = (0, 0),
                 overflow_keys: Optional[Tuple[jnp.ndarray, jnp.ndarray,
                                               jnp.ndarray]] = None):
    """Capped CSR lookup of [N, F] query signatures.

    Returns:
      cand: [N, F, probe_cap] uint32 item ids (SENTINEL where empty),
            ascending within each (n, f) as in the CSR rows.
      counts: [N, F] int32 true match counts (before capping) for overflow
            accounting (reference semantics have no cap here; parity tests
            must choose probe_cap >= max count).
    With fnc_layout=True the probe's NATIVE layouts come back untransposed
    (cand [F, N, C], counts [F, N]).

    tail_budget > 0 enables the two-tier value gather: measured probe hits
    average ~1.2 values, so the head gather fetches only 4 slots per
    (table, query) and the rare count>4 probes are compacted (<= tail_budget
    of them) and gather their remaining probe_cap-4 slots separately —
    ~3x fewer gathered elements, bit-identical while tail_drops is 0.
    Probes compacted out beyond the budget keep their first 4 values only.
    Adds (tail_drops, head_drops) to the returns.

    head_budget > 0 (requires the two-tier mode) additionally compacts the
    FOUND probes before the head gather (misses otherwise pay the same
    gather as hits); bit-identical
    while head_drops is 0.  Probes compacted out past head_budget lose all
    their values, so callers must assert/report head_drops like the other
    budget counters.

    overflow_keys (CsrIndex.overflow_keys, region mode) replaces the
    counts of the listed keys by their genome-wide counts, so counts >
    probe_cap counts each over-cap probe once over all regions.
    """
    n, f = sigs.shape
    sigs_t = sigs.T  # [F, N]
    if cuckoo is not None:
        # cuckoo direct probe: two key gathers + one packed payload gather
        # (build_cuckoo).  Counts saturate at 1023 in the payload, so the
        # drop-all rule (which compares against maxValuesPerKey) must use
        # the binary path, and probe_cap must stay below the saturation.
        assert max_values_per_key == 0 and probe_cap < 1023
        c_keys, c_payload = cuckoo
        s1 = jnp.uint32(cuckoo_seeds[0])
        s2 = jnp.uint32(cuckoo_seeds[1])
        sh = jnp.uint32(32 - cuckoo_bits)
        p1 = (((sigs_t ^ s1) * jnp.uint32(0x9E3779B1)) >> sh).astype(
            jnp.int32)
        p2 = (((sigs_t ^ s2) * jnp.uint32(0x85EBCA77)) >> sh).astype(
            jnp.int32)
        hit1 = jnp.take_along_axis(c_keys, p1, axis=1) == sigs_t
        hit2 = jnp.take_along_axis(c_keys, p2, axis=1) == sigs_t
        # SENTINEL doubles as the empty-slot marker in c_keys: a (valid)
        # query signature equal to SENTINEL would match empty slots, so
        # mask it out explicitly rather than rely on the zero payload.
        found = ((hit1 | hit2) & sig_valid[None, :]
                 & (sigs_t != jnp.uint32(0xFFFFFFFF)))
        pay = jnp.take_along_axis(c_payload, jnp.where(hit1, p1, p2),
                                  axis=1)
        off0 = jnp.where(found, (pay >> 10).astype(jnp.int32), 0)
        cnt = (pay & jnp.uint32(1023)).astype(jnp.int32)
        if dropped_keys is not None:
            found = found & ~_sorted_member(*dropped_keys, sigs_t)[0]
        counts = jnp.where(found, cnt, 0)                        # [F, N]
    else:
        if bucket_start is not None:
            idx = _bucketed_lower_bound(index_keys, bucket_start, sigs_t,
                                        probe_steps)             # [F, N]
        else:
            idx = jax.vmap(_row_searchsorted)(index_keys, sigs_t)  # [F, N]
        idx_c = jnp.minimum(idx, index_keys.shape[1] - 1)
        found_key = jnp.take_along_axis(index_keys, idx_c, axis=1)  # [F, N]
        found = (found_key == sigs_t) & (idx < index_num_keys[:, None])
        found = found & sig_valid[None, :]
        if dropped_keys is not None:
            found = found & ~_sorted_member(*dropped_keys, sigs_t)[0]

        off0 = jnp.take_along_axis(index_offsets, idx_c, axis=1)
        off1 = jnp.take_along_axis(index_offsets, idx_c + 1, axis=1)
        if max_values_per_key > 0:
            # GroupByKey drop-all semantics evaluated lazily at probe time
            # (reference: groupbykey.hpp:60-67): over-full keys yield
            # nothing
            found = found & ((off1 - off0) <= max_values_per_key)
        counts = jnp.where(found, off1 - off0, 0)                # [F, N]

    v_cols = index_values.shape[1]
    cap_eff = jnp.minimum(counts, probe_cap)                     # [F, N]
    two_tier = (tail_budget > 0 and probe_cap > 4
                and f * v_cols < 2**31)
    c1 = 4 if two_tier else probe_cap

    head_drops = jnp.int32(0)
    if head_budget > 0 and two_tier:
        # found-compacted head gather: fewer than half of the probes hit
        # on the bench shape, but the dense head gather below gathers
        # for every (f, n) including misses.  Compact the
        # found probes (<= head_budget of them, same machinery as the
        # tail tier) and gather c1 slots for those only — bit-identical
        # while head_drops stays 0 (probes compacted out past the budget
        # would lose ALL their values, so the counter must be asserted
        # like the other budgets).
        found_f = (counts > 0).reshape(-1)                       # [F*N]
        fi = found_f.astype(jnp.int32)
        frank = jnp.cumsum(fi) - 1
        n_found = jnp.sum(fi)
        fslot = jnp.where(found_f & (frank < head_budget), frank,
                          head_budget)
        fsel = jnp.zeros((head_budget + 1,), jnp.int32).at[fslot].set(
            jnp.arange(f * n, dtype=jnp.int32), mode="drop")[:head_budget]
        fsel_valid = jnp.arange(head_budget, dtype=jnp.int32) < n_found
        ff = fsel // n
        off0_f = jnp.take(off0.reshape(-1), fsel)
        cap_f = jnp.take(cap_eff.reshape(-1), fsel)
        slot = jnp.arange(c1, dtype=jnp.int32)
        gh = ff[:, None] * v_cols + off0_f[:, None] + slot[None, :]
        inh = (slot[None, :] < cap_f[:, None]) & fsel_valid[:, None]
        vh = jnp.take(index_values.reshape(-1),
                      jnp.clip(gh, 0, f * v_cols - 1).reshape(-1))
        vh = jnp.where(inh, vh.reshape(head_budget, c1),
                       jnp.uint32(SENTINEL))
        head = jnp.full((f * n + 1, c1), SENTINEL, dtype=jnp.uint32).at[
            jnp.where(fsel_valid, fsel, f * n)].set(
                vh, mode="drop")[:f * n].reshape(f, n, c1)
        head_drops = jnp.maximum(n_found - head_budget, 0)
    else:
        # head gather: first c1 values of every (f, n)
        slot = jnp.arange(c1, dtype=jnp.int32)
        gidx = off0[:, :, None] + slot[None, None, :]            # [F, N, c1]
        in_range = slot[None, None, :] < cap_eff[:, :, None]
        gidx = jnp.clip(gidx, 0, v_cols - 1)
        vals = jax.vmap(jnp.take)(index_values, gidx.reshape(f, -1))
        head = jnp.where(in_range, vals.reshape(f, n, c1),
                         jnp.uint32(SENTINEL))

    tail_drops = jnp.int32(0)
    if two_tier:
        # compact the rare count>4 probes; gather their tail slots flat
        big = (counts > c1).reshape(-1)                          # [F*N]
        bi = big.astype(jnp.int32)
        rank = jnp.cumsum(bi) - 1
        n_big = jnp.sum(bi)
        bslot = jnp.where(big & (rank < tail_budget), rank, tail_budget)
        sel = jnp.zeros((tail_budget + 1,), jnp.int32).at[bslot].set(
            jnp.arange(f * n, dtype=jnp.int32), mode="drop")[:tail_budget]
        sel_valid = jnp.arange(tail_budget, dtype=jnp.int32) < n_big
        f_sel = sel // n
        off0_sel = jnp.take(off0.reshape(-1), sel)
        cap_sel = jnp.take(cap_eff.reshape(-1), sel)
        slot2 = jnp.arange(c1, probe_cap, dtype=jnp.int32)
        g2 = f_sel[:, None] * v_cols + off0_sel[:, None] + slot2[None, :]
        in2 = (slot2[None, :] < cap_sel[:, None]) & sel_valid[:, None]
        v2 = jnp.take(index_values.reshape(-1),
                      jnp.clip(g2, 0, f * v_cols - 1).reshape(-1))
        v2 = jnp.where(in2, v2.reshape(tail_budget, probe_cap - c1),
                       jnp.uint32(SENTINEL))
        tail = jnp.full((f * n + 1, probe_cap - c1), SENTINEL,
                        dtype=jnp.uint32).at[
            jnp.where(sel_valid, sel, f * n)].set(
                v2, mode="drop")[:f * n].reshape(f, n, probe_cap - c1)
        cand = jnp.concatenate([head, tail], axis=2)
        tail_drops = jnp.maximum(n_big - tail_budget, 0)
    else:
        cand = head

    if overflow_keys is not None:
        okeys, ocount, onum = overflow_keys
        ohit, ocol = _sorted_member(okeys, onum, sigs_t)
        counts = jnp.where(ohit & found,
                           jnp.take_along_axis(ocount, ocol, axis=1), counts)

    if tail_budget > 0:
        if fnc_layout:
            return cand, counts, tail_drops, head_drops
        return cand.transpose(1, 0, 2), counts.T, tail_drops, head_drops
    if fnc_layout:
        return cand, counts
    return cand.transpose(1, 0, 2), counts.T


# ---------------------------------------------------------------------------
# device vote (min-table-hits frequency filter)
# ---------------------------------------------------------------------------

def _bitonic_merge_two(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Merge two ascending [..., W] uint32 arrays into [..., 2W] ascending.

    a ++ reverse(b) is bitonic; log2(2W) compare-exchange stages finish the
    merge — all vectorized min/max, no XLA sort."""
    w = a.shape[-1]
    y = jnp.concatenate([a, b[..., ::-1]], axis=-1)
    s = w
    total = 2 * w
    while s >= 1:
        shape = y.shape[:-1] + (total // (2 * s), 2, s)
        z = y.reshape(shape)
        lo = jnp.minimum(z[..., 0, :], z[..., 1, :])
        hi = jnp.maximum(z[..., 0, :], z[..., 1, :])
        y = jnp.stack([lo, hi], axis=-2).reshape(y.shape)
        s //= 2
    return y


def _merge_sorted_lists(cand: jnp.ndarray) -> jnp.ndarray:
    """[N, F, C] with each (n, f) list ascending -> [N, F*C] ascending.

    Tree of bitonic merges; requires C a power of two (F halved per round,
    odd counts keep a carry list)."""
    n, f, c = cand.shape
    lists = [cand[:, i, :] for i in range(f)]
    while len(lists) > 1:
        nxt = []
        for i in range(0, len(lists) - 1, 2):
            nxt.append(_bitonic_merge_two(lists[i], lists[i + 1]))
        if len(lists) % 2:
            nxt.append(lists[-1])
        # merging unequal widths: pad the shorter with SENTINEL to match
        widths = {x.shape[-1] for x in nxt}
        if len(widths) > 1:
            m = max(widths)
            nxt = [x if x.shape[-1] == m else jnp.pad(
                x, ((0, 0), (0, m - x.shape[-1])),
                constant_values=SENTINEL) for x in nxt]
        lists = nxt
    return lists[0][:, :f * c] if lists[0].shape[-1] > f * c else lists[0]


@partial(jax.jit, static_argnames=("min_table_hits", "out_cap"))
def vote_candidates(cand: jnp.ndarray, min_table_hits: int, out_cap: int
                    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Frequency-filtered distinct candidates per query row.

    Equivalent to keepDistinctByFrequency / keepDistinct (reference:
    include/gpu/minhashqueryfilter.cuh:123-279): sort the concatenated
    per-table matches, keep distinct ids occurring in >= min_table_hits
    tables, ascending id order.

    Args:
      cand: [N, F, C] uint32 with SENTINEL padding.
    Returns:
      (ids [N, out_cap] uint32 SENTINEL-padded, hit_counts [N, out_cap] int32,
       num_kept [N] int32 — may exceed out_cap; overflow = num_kept > out_cap).
    """
    n, f, c = cand.shape
    m = f * c
    if c & (c - 1) == 0 and c > 0:
        # per-(n, f) lists are ascending (CSR values are id-sorted): a
        # bitonic merge tree beats a full sort by ~an order of magnitude
        flat = _merge_sorted_lists(cand)
    else:
        flat = jnp.sort(cand.reshape(n, m), axis=1)              # SENTINEL last
    prev = jnp.concatenate(
        [jnp.full((n, 1), SENTINEL, dtype=flat.dtype), flat[:, :-1]], axis=1)
    is_start = (flat != prev) | (jnp.arange(m)[None, :] == 0)
    is_start = is_start & (flat != SENTINEL)

    # run length of each start = next start position - own position
    iota = jnp.arange(m, dtype=jnp.int32)[None, :]
    start_pos = jnp.where(is_start | (flat == SENTINEL), iota, jnp.int32(m))
    # next boundary at-or-after i+1:
    suffix_min = jax.lax.cummin(start_pos[:, ::-1], axis=1)[:, ::-1]
    nxt = jnp.concatenate(
        [suffix_min[:, 1:], jnp.full((n, 1), m, dtype=jnp.int32)], axis=1)
    run_len = nxt - iota

    if min_table_hits > 1:
        keep = is_start & (run_len >= min_table_hits)
    else:
        keep = is_start
    rank = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1
    num_kept = jnp.where(keep, rank + 1, 0).max(axis=1)

    out_ids = jnp.full((n, out_cap), SENTINEL, dtype=jnp.uint32)
    out_cnt = jnp.zeros((n, out_cap), dtype=jnp.int32)
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], (n, m))
    slot = jnp.where(keep, rank, out_cap)  # out-of-bounds slots get dropped
    out_ids = out_ids.at[rows, slot].set(flat, mode="drop")
    out_cnt = out_cnt.at[rows, slot].set(run_len, mode="drop")
    return out_ids, out_cnt, num_kept
