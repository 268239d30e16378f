"""Multi-device coarse mapping: sharded index + data-parallel read streaming.

JAX re-expression of the reference's multi-GPU layer:

  * hash-table sharding over the "table" mesh axis mirrors
    MultiGpuMinhasher::Layout::EvenShare round-robining tables over GPUs
    (reference: include/gpu/multigpuminhasher.cuh:277-303); the reference's
    cudaMemcpyPeerAsync broadcast + partial-result merge (:650-755) becomes
    an implicit replicated query batch + jax.lax.all_gather (NCCL);
  * read-batch sharding over the "data" mesh axis mirrors the read-storage
    row sharding of MultiGpu2dArray (multigpuarray.cuh:1315-1345);
  * the per-read best-hit merge stays device-local because each read's
    candidates are complete after the table all_gather.

The genome and window geometry are replicated (the per-host replication
fast path, like SingleGpuMinhasher::makeCopy, singlegpuminhasher.cuh:289).
For genomes whose index exceeds the mesh's aggregate HBM (or >2 Gbp), this
composes with genome-region sharding: RegionShardedMapper(mesh=...) builds
one ShardedCoarseMapper per region (each region's tables sharded over the
same mesh) and merges per-read bests across regions — the production path
the reference selects automatically with >1 GPU
(src/gpu/gpuminhasherconstruction.cu:297-309).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ProgramOptions
from ..index import minhash_index as mi
from ..io.genome import Genome
from ..ops import minhash, shd
from ..pipeline.engine import CoarseMapper, CoarseResults

SENTINEL = np.uint32(0xFFFFFFFF)


def make_mesh(data: int, table: int,
              devices: Optional[np.ndarray] = None) -> Mesh:
    if devices is None:
        devs = np.array(jax.devices()[:data * table]).reshape(data, table)
    else:
        devs = np.asarray(devices).reshape(data, table)
    return Mesh(devs, axis_names=("data", "table"))


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


class ShardedCoarseMapper:
    """Table-sharded, data-parallel coarse mapper over a 2D mesh.

    Drop-in with CoarseMapper for the production driver: map_reads returns
    CoarseResults (orientation/position/bs_strand/stats), stages the read
    pool on device once per map_reads call (batches slice it on device),
    and fetches one packed result array at the end.
    """

    def __init__(self, genome: Genome, opts: ProgramOptions, mesh: Mesh,
                 segments=None, build_direct_probe: bool = True):
        self.mesh = mesh
        self.opts = opts
        n_table = mesh.shape["table"]
        # 3N mode doubles the table count (CT + GA key spaces, engine.py)
        self.n_tables = opts.num_hash_functions * (
            2 if opts.three_n_seeding else 1)
        assert self.n_tables % n_table == 0, (
            "table count must divide evenly over the table axis")
        # geometry only — the index is built per table shard below, so no
        # device ever stages the full table set (the reference's
        # MultiGpuMinhasher also inserts into each GPU's own tables,
        # multigpuminhasher.cuh:391-483; contrast the reference's staging-
        # free incremental build, gpuminhasherconstruction.cu:123-242);
        # segments (region composition) pass straight through to the
        # geometry so chromosome_id reports segment indices and
        # global_window_id local ordinals, exactly like CoarseMapper.
        self.base = CoarseMapper(genome, opts, build_index=False,
                                 segments=segments)
        table_spec = NamedSharding(mesh, P("table"))
        repl = NamedSharding(mesh, P())
        self.keys, self.offsets, self.values, self.num_keys = \
            self._build_index_sharded()
        # cuckoo direct-probe shards (host-built from the shard keys, put
        # back with the table sharding — never staged whole on one device)
        self._use_cuckoo = False
        self.cuckoo_bits = 0
        self.cuckoo_seeds = (0, 0)
        self.cuckoo_fallback_reason: Optional[str] = None
        built = None
        if opts.probe_cap < 1023 and build_direct_probe:
            built, reason = mi.build_cuckoo_arrays(
                np.asarray(self.keys), np.asarray(self.offsets),
                np.asarray(self.num_keys), int(self.values.shape[1]))
            if built is None:
                self.cuckoo_fallback_reason = reason
        if built is not None:
            ck, payload, bits, seeds = built
            self.cuckoo_keys = jax.device_put(ck, table_spec)
            self.cuckoo_payload = jax.device_put(payload, table_spec)
            self.cuckoo_bits = bits
            self.cuckoo_seeds = seeds
            self._use_cuckoo = True
        else:
            # shape placeholders keep the shard_map arity uniform
            dummy = np.zeros((self.n_tables, 2), dtype=np.uint32)
            self.cuckoo_keys = jax.device_put(dummy, table_spec)
            self.cuckoo_payload = jax.device_put(dummy, table_spec)
        self.genome_hi = jax.device_put(self.base.table.genome_hi, repl)
        self.genome_lo = jax.device_put(self.base.table.genome_lo, repl)
        self.win_pos = jax.device_put(self.base.table.win_pos, repl)
        self.win_chrom = jax.device_put(self.base.table.win_chrom, repl)
        self.chrom_offset = jax.device_put(self.base.table.chrom_offset, repl)
        self.chrom_len = jax.device_put(self.base.table.chrom_len, repl)
        self.hash_ids = jax.device_put(
            jnp.asarray(self.base.hash_ids), repl)
        f = self.n_tables
        self.dropped_keys = jax.device_put(
            jnp.full((f, 1), jnp.uint32(0xFFFFFFFF)), table_spec)
        self.dropped_num = jax.device_put(
            jnp.zeros((f,), dtype=jnp.int32), table_spec)
        self._drops_set = False
        self._compile_steps()
        self._warned_fallback = False

    # region-composition hooks (region_sharded.region_key_payload reads
    # the segment geometry off the mapper)
    @property
    def segments(self):
        return self.base.segments

    @property
    def seg_local_base(self):
        return self.base.seg_local_base

    @property
    def table(self):
        return self.base.table

    def _build_index_sharded(self, sig_batch: int = 4096):
        """Per-shard device CSR build: the window stream is hashed in
        superbatches, signatures land column-sharded over the "table" axis,
        and each shard sorts/compacts ONLY its own tables under shard_map —
        the full index never exists on any single device.
        (Reference analog: per-GPU incremental inserts + local compaction,
        gpuminhasherconstruction.cu:123-242, singlegpuminhasher.cuh:380-526.)
        """
        opts = self.opts
        mesh = self.mesh
        col_sh = NamedSharding(mesh, P(None, "table"))
        repl = NamedSharding(mesh, P())
        hash_ids = jnp.arange(opts.num_hash_functions, dtype=jnp.uint32)

        from ..pipeline.engine import window_bases_device
        sig_parts, valid_parts = [], []
        for gstart, lens, n in self.base.iter_window_superbatch_starts(
                sig_batch):
            bdev = window_bases_device(
                self.base.table.genome_concat, jnp.asarray(gstart),
                opts.window_size)
            ldev = jnp.asarray(lens)
            if opts.three_n_seeding:
                s_ct, v = minhash.minhash_signatures_chunked(
                    jnp.where(bdev == 1, jnp.int8(3), bdev), ldev,
                    opts.kmer_length, hash_ids, sig_batch, canonical=False)
                s_ga, _ = minhash.minhash_signatures_chunked(
                    jnp.where(bdev == 2, jnp.int8(0), bdev), ldev,
                    opts.kmer_length, hash_ids, sig_batch, canonical=False)
                s = jnp.concatenate([s_ct, s_ga], axis=1)     # [n, 2F]
            else:
                s, v = minhash.minhash_signatures_chunked(
                    bdev, ldev, opts.kmer_length, hash_ids, sig_batch)
            # only this (bounded) superbatch is ever resident unsharded
            sig_parts.append(jax.device_put(s[:n], col_sh))
            valid_parts.append(jax.device_put(v[:n], repl))

        concat = jax.jit(lambda *xs: jnp.concatenate(xs, axis=0),
                         out_shardings=col_sh)
        concat_r = jax.jit(lambda *xs: jnp.concatenate(xs, axis=0),
                           out_shardings=repl)
        sigs = concat(*sig_parts) if len(sig_parts) > 1 else sig_parts[0]
        valid = (concat_r(*valid_parts) if len(valid_parts) > 1
                 else valid_parts[0])

        def build_local(sigs_local, valid_repl):
            return jax.vmap(mi._build_one_table_device,
                            in_axes=(1, None))(sigs_local, valid_repl)

        mapped = _shard_map(build_local, mesh,
                            in_specs=(P(None, "table"), P()),
                            out_specs=(P("table"),) * 4)
        return jax.jit(mapped)(sigs, valid)

    def index_memory_per_device(self) -> dict:
        """Bytes of index shard data per device (accounting hook for the
        no-full-index-staging invariant)."""
        out = {}
        for arr in (self.keys, self.offsets, self.values, self.num_keys):
            for s in arr.addressable_shards:
                d = str(s.device)
                out[d] = out.get(d, 0) + int(np.prod(s.data.shape)) * \
                    s.data.dtype.itemsize
        return out

    def memory_bytes(self) -> int:
        """Total index bytes across the mesh (driver reporting)."""
        return sum(self.index_memory_per_device().values())

    def set_read_drops(self, read_sigs: np.ndarray,
                       read_valid: np.ndarray) -> None:
        assert not self.opts.three_n_seeding, (
            "read-key-drop emulation is a parity-mode feature (the 3N index "
            "has no reference counterpart to emulate, see engine.map_reads)")
        dk, dn = mi.build_dropped_keys(
            read_sigs, read_valid, self.opts.max_results_per_map)
        table_spec = NamedSharding(self.mesh, P("table"))
        self.dropped_keys = jax.device_put(jnp.asarray(dk), table_spec)
        self.dropped_num = jax.device_put(jnp.asarray(dn), table_spec)
        self._drops_set = True
        self._compile_steps()  # dropped shapes may have changed

    def ensure_read_drops(self, read_bases: np.ndarray,
                          read_lengths: np.ndarray,
                          precomputed_sigs: Optional[np.ndarray] = None
                          ) -> None:
        """Dropped-keys mask from the FULL read set (parity mode); mirrors
        CoarseMapper.ensure_read_drops so the chunked/pipelined driver can
        treat both mappers uniformly."""
        opts = self.opts
        if opts.three_n_seeding or self._drops_set:
            return
        n = read_bases.shape[0]
        if precomputed_sigs is None:
            hash_ids = jnp.asarray(self.base.hash_ids)
            sig_list, val_list = [], []
            for start in range(0, n, opts.batchsize):
                stop = min(start + opts.batchsize, n)
                s, v = minhash.minhash_signatures(
                    jnp.asarray(read_bases[start:stop]),
                    jnp.asarray(read_lengths[start:stop]),
                    opts.kmer_length, hash_ids)
                sig_list.append(np.asarray(s))
                val_list.append(np.asarray(v))
            precomputed_sigs = np.concatenate(sig_list)
            pre_valid = np.concatenate(val_list)
        else:
            pre_valid = read_lengths >= opts.kmer_length
        self.set_read_drops(precomputed_sigs, pre_valid)

    def ensure_empty_drops(self) -> None:
        """Region-composition hook; the table-sharded empty mask is already
        in place from __init__."""

    def _compile_steps(self):
        mapped = self._build_step()
        self._step = jax.jit(mapped)

        def step_at(keys, offsets, values, num_keys, cuckoo_k, cuckoo_p,
                    dropped_keys, dropped_num, genome_hi, genome_lo,
                    win_pos, win_chrom, chrom_offset, chrom_len, hash_ids,
                    pool_bases, pool_lens, pool_valid, i):
            # the pool is [n_batches, bsz*D, L] sharded P(None, "data"):
            # indexing axis 0 is shard-local, no collective
            rb = jax.lax.dynamic_index_in_dim(pool_bases, i, 0,
                                              keepdims=False)
            rl = jax.lax.dynamic_index_in_dim(pool_lens, i, 0,
                                              keepdims=False)
            rv = jax.lax.dynamic_index_in_dim(pool_valid, i, 0,
                                              keepdims=False)
            return mapped(keys, offsets, values, num_keys, cuckoo_k,
                          cuckoo_p, dropped_keys, dropped_num, genome_hi,
                          genome_lo, win_pos, win_chrom, chrom_offset,
                          chrom_len, hash_ids, rb, rl, rv)

        self._step_at = jax.jit(step_at)

    def _build_step(self):
        opts = self.opts
        mesh = self.mesh

        def step(keys, offsets, values, num_keys, cuckoo_k, cuckoo_p,
                 dropped_keys, dropped_num,
                 genome_hi, genome_lo, win_pos, win_chrom, chrom_offset,
                 chrom_len, hash_ids, read_bases, read_len, read_valid):
            """Runs per (data, table) shard via shard_map."""
            b, lr = read_bases.shape
            kcap = opts.candidates_per_read_cap

            if opts.three_n_seeding:
                # CT sigs of the read + GA sigs of its RC, one fused pass
                # (minhash.signatures_3n_pair)
                sigs, sig_valid = minhash.signatures_3n_pair(
                    read_bases, read_len, opts.kmer_length, hash_ids)
            else:
                sigs, sig_valid = minhash.minhash_signatures(
                    read_bases, read_len, opts.kmer_length, hash_ids)
            sig_valid = sig_valid & read_valid

            # probe only the local tables with the matching sig columns
            n_table = jax.lax.axis_size("table")
            t_idx = jax.lax.axis_index("table")
            f_local = self.n_tables // n_table
            tail_budget = b * opts.probe_tail_budget_per_read
            cuckoo_kw = {}
            if self._use_cuckoo:
                cuckoo_kw = dict(cuckoo=(cuckoo_k, cuckoo_p),
                                 cuckoo_bits=self.cuckoo_bits,
                                 cuckoo_seeds=self.cuckoo_seeds)

            def probe_gather(sig_block):
                local_sigs = jax.lax.dynamic_slice_in_dim(
                    sig_block, t_idx * f_local, f_local, axis=1)
                if tail_budget > 0:
                    cl, nl, td, _hd = mi.probe_tables(
                        keys, offsets, values, num_keys, local_sigs,
                        sig_valid, opts.probe_cap,
                        dropped_keys=(dropped_keys, dropped_num),
                        fnc_layout=True, tail_budget=tail_budget,
                        **cuckoo_kw)
                else:
                    cl, nl = mi.probe_tables(
                        keys, offsets, values, num_keys, local_sigs,
                        sig_valid, opts.probe_cap,
                        dropped_keys=(dropped_keys, dropped_num),
                        fnc_layout=True, **cuckoo_kw)
                    td = jnp.int32(0)
                # merge per-table partials: the reference P2P-gathers
                # per-GPU counts/values (multigpuminhasher.cuh:740-907);
                # here one all_gather re-assembles [F, N, C]
                return (jax.lax.all_gather(cl, "table", axis=0, tiled=True),
                        jax.lax.all_gather(nl, "table", axis=0, tiled=True),
                        td)

            cand, counts, tail_drops = probe_gather(sigs)
            head_drops = jnp.int32(0)  # head compaction off on the mesh
            if opts.undirectional:
                # PBAT strands: mirrored query spaces vs the same tables
                # (engine.py's undirectional block, sharded)
                sigs_u, _ = minhash.signatures_3n_pair(
                    read_bases, read_len, opts.kmer_length, hash_ids,
                    mirror=True)
                cand_u, counts_u, td_u = probe_gather(sigs_u)
                cand = jnp.concatenate([cand, cand_u], axis=0)
                counts = jnp.concatenate([counts, counts_u], axis=0)
                tail_drops = tail_drops + td_u

            ids, hit_cnt, num_kept = mi.vote_candidates(
                cand.transpose(1, 0, 2), opts.min_table_hits, kcap)

            from ..pipeline.engine import coarse_pairs_best
            (out_ori32, out_ham, out_shift, out_chrom, out_pos, best_gwin,
             has, _ori, out_strand, pair_drops) = coarse_pairs_best(
                ids, read_bases, read_len, opts, lr, genome_hi, genome_lo,
                win_pos, win_chrom, chrom_offset, chrom_len)
            out_gwin = jnp.where(has, best_gwin, -1)  # -1 == SENTINEL bits

            # one packed [B, 7] result per shard — layout matches the
            # single-device engine's packed output (engine.py:600-603)
            packed = jnp.stack(
                [out_ori32, out_ham, out_shift, out_chrom, out_pos,
                 out_gwin, out_strand], axis=1)
            # per-counter overflow: probe/vote/pair are identical on every
            # table shard (computed from gathered data) -> table-mean; tail
            # is a pre-gather per-shard count -> table-sum.  All differ per
            # data shard -> data-sum, so the [4] output is mesh-replicated.
            rep3 = jnp.stack([jnp.sum(counts > opts.probe_cap),
                              jnp.sum(num_kept > kcap), pair_drops])
            rep3 = jax.lax.psum(rep3, "table") // n_table
            tail = jax.lax.psum(tail_drops, "table")
            head = jax.lax.psum(head_drops, "table")
            overflow = jax.lax.psum(
                jnp.concatenate([rep3, tail[None], head[None]]), "data")
            return packed, overflow

        data_spec = P("data")
        table_spec = P("table")
        repl = P()
        return _shard_map(
            step, mesh,
            in_specs=(table_spec, table_spec, table_spec, table_spec,
                      table_spec, table_spec, table_spec, table_spec,
                      repl, repl, repl, repl, repl, repl, repl,
                      data_spec, data_spec, data_spec),
            out_specs=(data_spec, repl))

    def map_batch(self, read_bases: jnp.ndarray, read_len: jnp.ndarray,
                  read_valid: jnp.ndarray):
        """One mesh batch ([batchsize * data] rows) -> (packed [B, 7] int32,
        overflow [4] int32) device arrays."""
        return self._step(
            self.keys, self.offsets, self.values, self.num_keys,
            self.cuckoo_keys, self.cuckoo_payload,
            self.dropped_keys, self.dropped_num,
            self.genome_hi, self.genome_lo, self.win_pos, self.win_chrom,
            self.chrom_offset, self.chrom_len, self.hash_ids,
            read_bases, read_len, read_valid)

    def stage_reads_device(self, read_bases: np.ndarray,
                           read_lengths: np.ndarray):
        """Upload the read set once as a [n_batches, bsz*D, L] pool sharded
        over the data axis; per-batch slicing happens on device (no
        per-batch H2D — the reference's device-resident read storage,
        multigpureadstorage.cuh)."""
        opts = self.opts
        n, lr = read_bases.shape
        if lr < opts.max_read_length:
            read_bases = np.pad(
                read_bases, ((0, 0), (0, opts.max_read_length - lr)))
        d = self.mesh.shape["data"]
        bsz = opts.batchsize * d
        n_batches = max(1, -(-n // bsz))
        n_pad = n_batches * bsz
        bases = np.pad(read_bases.astype(np.int8), ((0, n_pad - n), (0, 0)))
        lens = np.pad(read_lengths.astype(np.int32), (0, n_pad - n))
        valid = np.arange(n_pad) < n
        pool_sh = NamedSharding(self.mesh, P(None, "data"))
        lq = bases.shape[1]
        pool_b = jax.device_put(bases.reshape(n_batches, bsz, lq), pool_sh)
        pool_l = jax.device_put(lens.reshape(n_batches, bsz), pool_sh)
        pool_v = jax.device_put(valid.reshape(n_batches, bsz), pool_sh)
        return pool_b, pool_l, pool_v, n_pad

    # fused STEP-2 score+traceback over the mesh: the tail is pure
    # data-parallelism (no table-axis communication — the pair scoring
    # reads only the replicated genome), so it runs as its own shard_map
    # over "data" with everything else replicated
    supports_fused_scores = True

    def _ensure_scored_tail(self):
        if getattr(self, "_scored_tail", None) is None:
            from ..pipeline.engine import build_genome_s2, fused_step2_scores
            s2 = build_genome_s2(self.base.genome, self.opts, self.segments)
            self._genome_s2 = jax.device_put(
                jnp.asarray(s2), NamedSharding(self.mesh, P()))
            opts = self.opts

            def tail(chrom_offset, chrom_len, genome_s2, rb, rl, packed):
                return fused_step2_scores(opts, chrom_offset, chrom_len,
                                          genome_s2, rb, rl, packed)

            self._scored_tail = jax.jit(_shard_map(
                tail, self.mesh,
                in_specs=(P(), P(), P(), P("data"), P("data"), P("data")),
                out_specs=(P(None, "data"), P("data"), P("data"))))
        return self._scored_tail

    def _map_reads_device_scored(self, pool_b, pool_l, pool_v, n_pad: int,
                                 bsz_unused: int):
        """Scored variant of _map_reads_device (same contract as
        CoarseMapper._map_reads_device_scored, so RegionShardedMapper and
        the pipelined driver can drive either mapper)."""
        tail = self._ensure_scored_tail()
        pk, ov, sc, to, ts = [], [], [], [], []
        for i in range(pool_b.shape[0]):
            packed, ovf = self._step_at(
                self.keys, self.offsets, self.values, self.num_keys,
                self.cuckoo_keys, self.cuckoo_payload,
                self.dropped_keys, self.dropped_num,
                self.genome_hi, self.genome_lo, self.win_pos,
                self.win_chrom, self.chrom_offset, self.chrom_len,
                self.hash_ids, pool_b, pool_l, pool_v, jnp.int32(i))
            s, t_o, t_s = tail(self.chrom_offset, self.chrom_len,
                               self._genome_s2, pool_b[i], pool_l[i],
                               packed)
            pk.append(packed)
            ov.append(ovf)
            sc.append(s)
            to.append(t_o)
            ts.append(t_s)
        return (jnp.concatenate(pk, axis=0), jnp.stack(ov).sum(axis=0),
                jnp.concatenate(sc, axis=1), jnp.concatenate(to, axis=0),
                jnp.concatenate(ts, axis=0))

    def _map_reads_device(self, pool_b, pool_l, pool_v, n_pad: int,
                          bsz_unused: int, collect_candidates: bool = False):
        """Dispatch every batch asynchronously; results stay ON DEVICE as
        one packed [n_pad, 7] array + [4] overflow (same contract as
        CoarseMapper._map_reads_device, so RegionShardedMapper can drive
        either mapper)."""
        assert not collect_candidates, (
            "candidate collection is a single-device instrumentation mode")
        packed_parts, ovf_parts = [], []
        for i in range(pool_b.shape[0]):
            packed, ovf = self._step_at(
                self.keys, self.offsets, self.values, self.num_keys,
                self.cuckoo_keys, self.cuckoo_payload,
                self.dropped_keys, self.dropped_num,
                self.genome_hi, self.genome_lo, self.win_pos,
                self.win_chrom, self.chrom_offset, self.chrom_len,
                self.hash_ids, pool_b, pool_l, pool_v, jnp.int32(i))
            packed_parts.append(packed)
            ovf_parts.append(ovf)
        packed_dev = (jnp.concatenate(packed_parts)
                      if len(packed_parts) > 1 else packed_parts[0])
        ovf_dev = jnp.stack(ovf_parts).sum(axis=0)
        return packed_dev, ovf_dev, []

    def _fallback_stats(self) -> dict:
        import sys
        stats = {"cuckoo_direct_probe": int(self._use_cuckoo)}
        if not self._warned_fallback:
            self._warned_fallback = True
            if self.cuckoo_fallback_reason:
                print(f"note: cuckoo direct probe disabled "
                      f"({self.cuckoo_fallback_reason}); binary-search "
                      f"probe in use", file=sys.stderr)
        return stats

    def map_reads(self, read_bases: np.ndarray, read_lengths: np.ndarray,
                  emulate_read_key_drop: bool = True,
                  with_scores: bool = False) -> CoarseResults:
        """Map all reads over the mesh; returns CoarseResults exactly like
        CoarseMapper.map_reads (bs_strand + per-counter stats included), so
        STEP 2 rescoring — including undirectional PBAT — works unchanged.
        with_scores: also return the fused STEP-2 (scores, tb_ops,
        tb_status) bundle (CoarseMapper.map_reads contract)."""
        opts = self.opts
        n = len(read_lengths)
        if with_scores and n == 0:
            empty = np.zeros((10, 0), np.int16)
            if getattr(opts, "step2_device_traceback", True):
                empty = (empty, np.zeros((0, 1), np.uint8),
                         np.zeros((0,), np.int8))
            return self.map_reads(read_bases, read_lengths,
                                  emulate_read_key_drop), empty
        if n == 0:
            return CoarseResults(
                orientation=np.full(0, shd.NONE, dtype=np.int8),
                hamming=np.zeros(0, dtype=np.int32),
                shift=np.zeros(0, dtype=np.int32),
                chromosome_id=np.zeros(0, dtype=np.int32),
                position=np.zeros(0, dtype=np.int32),
                global_window_id=np.zeros(0, dtype=np.uint32),
                stats={"probe_overflow": 0, "vote_overflow": 0,
                       "pair_budget_overflow": 0, "probe_tail_overflow": 0,
                       "probe_head_overflow": 0,
                       **self._fallback_stats()},
                bs_strand=np.zeros(0, dtype=np.int8))
        if opts.three_n_seeding:
            emulate_read_key_drop = False
        if emulate_read_key_drop:
            self.ensure_read_drops(read_bases, read_lengths)
        pool_b, pool_l, pool_v, n_pad = self.stage_reads_device(
            read_bases, read_lengths)
        score_bundle = None
        if with_scores:
            packed_dev, ovf_dev, sc_dev, to_dev, ts_dev = \
                self._map_reads_device_scored(pool_b, pool_l, pool_v, n_pad,
                                              opts.batchsize)
            scores = np.asarray(sc_dev)[:, :2 * n]
            if getattr(opts, "step2_device_traceback", True):
                score_bundle = (scores, np.asarray(to_dev)[:2 * n],
                                np.asarray(ts_dev)[:2 * n])
            else:
                score_bundle = scores
        else:
            packed_dev, ovf_dev, _ = self._map_reads_device(
                pool_b, pool_l, pool_v, n_pad, opts.batchsize)
        packed = np.asarray(packed_dev)[:n]
        ovf = np.asarray(ovf_dev)
        results = CoarseResults(
            orientation=packed[:, 0].astype(np.int8),
            hamming=packed[:, 1].astype(np.int32),
            shift=packed[:, 2].astype(np.int32),
            chromosome_id=packed[:, 3].astype(np.int32),
            position=packed[:, 4].astype(np.int32),
            global_window_id=packed[:, 5].astype(np.uint32),
            stats={"probe_overflow": int(ovf[0]),
                   "vote_overflow": int(ovf[1]),
                   "pair_budget_overflow": int(ovf[2]),
                   "probe_tail_overflow": int(ovf[3]),
                   "probe_head_overflow": int(ovf[4]) if len(ovf) > 4 else 0,
                   **self._fallback_stats()},
            bs_strand=packed[:, 6].astype(np.int8))
        if with_scores:
            return results, score_bundle
        return results
