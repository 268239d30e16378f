"""End-to-end driver: STEP 1 coarse map -> STEP 2 SAM -> STEP 3 VCF.

Mirrors the reference driver performMappingGpu (reference:
src/gpu/main_gpu.cu:859-1286) with the same phase structure and timers:
STEP1 (read ingest + index + window loop), "process mapping" (CSSW -> SAM),
"process variant calling" (VCF).  The coarse stage runs on the device engine
in the inverted genome-index orientation (pipeline/engine.py).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from ..config import MapperType, ProgramOptions
from ..io.genome import Genome
from ..io.readstore import ReadStorage
from ..utils.timers import PhaseTimers
from . import mapping
from .engine import CoarseMapper, CoarseResults


def _pipelined_sw(mapper, bases: np.ndarray, reads: ReadStorage,
                  genome: Genome, genome_rc: Genome, opts: ProgramOptions):
    """Chunked coarse map + fine alignment with one STEP-2 worker thread.

    The main thread drives the device (coarse chunks); a single worker
    runs each chunk's run_cssw as soon as its coarse results land, so
    STEP 2's CPU portions (CIGAR finish, rescore, record build) hide
    behind the next chunk's device time.  Chunk results are re-based to
    global read ids and concatenated in order.
    """
    from concurrent.futures import ThreadPoolExecutor

    from ..utils.progress import ProgressReporter

    n = reads.num_reads
    chunk = opts.step2_pipeline_chunk
    if hasattr(mapper, "ensure_read_drops"):
        # whole-dataset parity rule; must precede per-chunk mapping
        mapper.ensure_read_drops(bases, reads.lengths)
    res_parts = []
    # the reference's --showProgress counter (every 100k windows,
    # main_gpu.cu:1114-1119); here progress is reads through STEP 1+2
    progress = ProgressReporter(n, label="reads mapped+aligned",
                                enabled=opts.show_progress)
    from .. import native

    # fused coarse+score path: the STEP-2 striped-SW score pass runs inside
    # the coarse device step (engine._step2_scores), so the worker thread
    # never dispatches to the device (no contention with the next chunk's
    # coarse mapping)
    fused = (getattr(mapper, "supports_fused_scores", False)
             and getattr(opts, "step2_device", False) and native.available())
    # dispatch-ahead streaming (plain engine only): enqueue EVERY scored
    # batch up front, then fetch per-chunk slices in order — the per-chunk
    # D2H overlaps the later batches' device compute instead of
    # serializing after it
    stream = fused and isinstance(mapper, CoarseMapper)
    if stream:
        bsz = opts.batchsize
        n_pad = ((n + bsz - 1) // bsz) * bsz
        stream = (chunk % bsz == 0
                  and mapper.read_pool_size(n, bases.shape[1], bsz) >= n_pad)
    from .records import MappingRecords
    # two cssw workers, so one long chunk of host work does not hold up
    # the next (sized before any measurement on the GPU; ROADMAP D2)
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = []
        if stream:
            import jax.numpy as jnp
            if mapper.dropped is None:
                mapper.ensure_empty_drops()
            ab, al, av, n_pad = mapper.stage_reads_device(bases,
                                                          reads.lengths)
            use_tb = getattr(opts, "step2_device_traceback", True)
            b8 = lambda a: __import__("jax").lax.bitcast_convert_type(
                a, jnp.uint8)
            # slim score rows: every score value fits uint8 once the
            # -1-able begin/end rows are shifted +1 (score1/score2
            # saturate at 255; ends < window/read length) — 20 B/read
            # instead of 40 to the host (ROADMAP D2: keep only if a
            # measurement earns it)
            slim = opts.window_size <= 255 and bases.shape[1] <= 255
            sc_off = np.array([0, 1, 1, 0, 1, 1, 1, 0, 0, 0], np.int16)
            sc_off_dev = jnp.asarray(sc_off)
            sc_w = 20 if slim else 40

            # per chunk: dispatch its batches, then enqueue ONE combined
            # uint8 bundle right behind them — the bundle's FIFO position
            # means fetching chunk i waits only for chunk i's compute, and
            # each chunk costs one fetch
            bundles = []
            ovf_parts = []
            n_chunks = 0
            for c0 in range(0, n_pad, chunk):
                c1 = min(c0 + chunk, n_pad)
                pk, sc, to, ts = [], [], [], []
                for s in range(c0, c1, bsz):
                    p, o, s16, t_o, t_s = mapper._map_batch_scored_at(
                        ab, al, av, jnp.int32(s), bsz,
                        mapper.dropped[0], mapper.dropped[1])
                    pk.append(p)
                    ovf_parts.append(o)
                    sc.append(s16)
                    to.append(t_o)
                    ts.append(t_s)
                c = c1 - c0
                sc_cat = jnp.concatenate(sc, axis=1)
                if slim:
                    sc_rows = ((sc_cat + sc_off_dev[:, None])
                               .astype(jnp.uint8).T.reshape(c, 20))
                else:
                    sc_rows = b8(sc_cat.T).reshape(c, 40)
                row = [b8(jnp.concatenate(pk)).reshape(c, 28), sc_rows]
                if use_tb:
                    e = to[0].shape[1]
                    row.append(jnp.concatenate(to).reshape(c, 2 * e))
                    row.append(b8(jnp.concatenate(ts)).reshape(c, 2))
                bundles.append(jnp.concatenate(row, axis=1))
                n_chunks += 1

            for ci, c0 in enumerate(range(0, n, chunk)):
                c1 = min(c0 + chunk, n)
                buf = np.asarray(bundles[ci])[:c1 - c0]
                c = c1 - c0
                packed = buf[:, :28].copy().view(np.int32).reshape(c, 7)
                if slim:
                    scores = (buf[:, 28:48].reshape(2 * c, 10)
                              .astype(np.int16) - sc_off[None, :]).T
                else:
                    scores = (buf[:, 28:68].copy().view(np.int16)
                              .reshape(2 * c, 10).T)
                if use_tb:
                    base = 28 + sc_w
                    e = (buf.shape[1] - base - 2) // 2
                    tb_ops = buf[:, base:base + 2 * e].reshape(2 * c, e)
                    tb_st = (buf[:, base + 2 * e:].copy().view(np.int8)
                             .reshape(2 * c))
                    scores = (scores, tb_ops, tb_st)
                res = CoarseResults(
                    orientation=packed[:, 0].astype(np.int8),
                    hamming=packed[:, 1].astype(np.int32),
                    shift=packed[:, 2].astype(np.int32),
                    chromosome_id=packed[:, 3].astype(np.int32),
                    position=packed[:, 4].astype(np.int32),
                    global_window_id=packed[:, 5].astype(np.uint32),
                    stats={},
                    bs_strand=packed[:, 6].astype(np.int8))
                res_parts.append(res)
                futs.append((c0, c1, ex.submit(
                    mapping.run_cssw, genome, genome_rc, res.orientation,
                    res.position, res.chromosome_id,
                    reads.slice_rows(c0, c1), opts, res.bs_strand, scores,
                    True)))
            ovf = np.asarray(jnp.stack(ovf_parts).sum(axis=0))
            res_parts[0].stats = {
                "probe_overflow": int(ovf[0]), "vote_overflow": int(ovf[1]),
                "pair_budget_overflow": int(ovf[2]),
                "probe_tail_overflow": int(ovf[3]),
                "probe_head_overflow": int(ovf[4]) if len(ovf) > 4 else 0,
                **mapper._fallback_stats()}
        else:
            for c0 in range(0, n, chunk):
                c1 = min(c0 + chunk, n)
                if fused:
                    res, scores = mapper.map_reads(
                        bases[c0:c1], reads.lengths[c0:c1],
                        with_scores=True)
                else:
                    res = mapper.map_reads(bases[c0:c1],
                                           reads.lengths[c0:c1])
                    scores = None
                res_parts.append(res)
                futs.append((c0, c1, ex.submit(
                    mapping.run_cssw, genome, genome_rc, res.orientation,
                    res.position, res.chromosome_id,
                    reads.slice_rows(c0, c1), opts, res.bs_strand, scores,
                    True)))
        parts = []
        for c0, c1, f in futs:
            parts.append((c0, f.result()))
            progress.add(c1 - c0)
        if parts and all(isinstance(p, MappingRecords) for _, p in parts):
            mappingout = MappingRecords.concat([p for _, p in parts])
        else:
            # mixed / AA chunks: read ids in AlignerArguments are
            # chunk-local — rebase to global (records keep them implicit)
            mappingout = []
            for c0, p in parts:
                aas = p.to_aas() if isinstance(p, MappingRecords) else p
                for aa in aas:
                    aa.read_id += c0
                mappingout.extend(aas)
    if opts.show_progress:
        progress.finish()

    stats = {}
    for r in res_parts:
        for k, v in r.stats.items():
            stats[k] = stats.get(k, 0) + v
    cat = lambda field: np.concatenate([getattr(r, field)
                                        for r in res_parts])
    g64 = ([r.global_window_id64 for r in res_parts]
           if all(r.global_window_id64 is not None for r in res_parts)
           else None)
    results = CoarseResults(
        orientation=cat("orientation"), hamming=cat("hamming"),
        shift=cat("shift"), chromosome_id=cat("chromosome_id"),
        position=cat("position"), global_window_id=cat("global_window_id"),
        stats=stats,
        global_window_id64=(np.concatenate(g64) if g64 else None),
        bs_strand=(cat("bs_strand")
                   if all(r.bs_strand is not None for r in res_parts)
                   else None))
    return results, mappingout


def run_pipeline(opts: ProgramOptions,
                 reads: Optional[ReadStorage] = None,
                 genome: Optional[Genome] = None) -> Dict:
    timers = PhaseTimers()

    with timers.phase("STEP1"):
        with timers.phase("build_readstorage"):
            if reads is None:
                if opts.load_binary_reads_from:
                    reads = ReadStorage.load(opts.load_binary_reads_from)
                else:
                    from ..config import SequencePairType
                    reads = ReadStorage.from_files(
                        opts.inputfiles,
                        paired=opts.pair_type == SequencePairType.PAIRED_END,
                        quality_bits=(opts.quality_score_bits
                                      if opts.use_quality_scores else 0))
                if opts.save_binary_reads_to:
                    reads.save(opts.save_binary_reads_to)
        print(f"gpureadstorage: occupied memory: {reads.packed.nbytes}")
        print(f"Reads: {reads.num_reads}")

        if genome is None:
            genome = Genome.from_fasta(opts.genomefile)
        genome_rc = genome.reverse_complement()

        with timers.phase("build_minhasher"):
            if opts.max_read_length < reads.sequence_length_upper_bound():
                opts.max_read_length = reads.sequence_length_upper_bound()
            total_bases = sum(genome.chromosome_length(c)
                              for c in range(genome.num_chromosomes))
            from ..parallel.region_sharded import (
                RegionShardedMapper, SINGLE_MAPPER_BASE_CAP)
            mesh = None
            if opts.mesh_data is not None or opts.mesh_table is not None:
                # production (data x table) mesh mode — the reference
                # selects its multi-GPU minhasher automatically with >1
                # GPU (gpuminhasherconstruction.cu:297-309); here the mesh
                # shape is explicit (--mesh D T)
                import jax
                from ..parallel.sharded import make_mesh
                n_data = opts.mesh_data or 1
                n_table = opts.mesh_table or 1
                assert len(jax.devices()) >= n_data * n_table, (
                    f"--mesh {n_data} {n_table} needs {n_data * n_table} "
                    f"devices, have {len(jax.devices())}")
                assert not (opts.save_hashtables_to
                            or opts.load_hashtables_from), (
                    "mesh-sharded tables do not serialize (the reference's "
                    "warpcore tables cannot either, "
                    "singlegpuminhasher.cuh:1052-1053)")
                mesh = make_mesh(n_data, n_table)
            if opts.num_regions > 1 or total_bases >= SINGLE_MAPPER_BASE_CAP:
                import jax
                n_regions = opts.num_regions or max(
                    1 if mesh is not None else len(jax.devices()),
                    -(-total_bases // SINGLE_MAPPER_BASE_CAP))
                mapper = RegionShardedMapper(genome, opts, n_regions,
                                             mesh=mesh)
                idx_bytes = sum(m.memory_bytes() for m in mapper.mappers)
                n_windows = sum(m.table.num_windows for m in mapper.mappers)
                print(f"window index: {idx_bytes} bytes, {n_windows} windows "
                      f"in {mapper.n_regions} regions"
                      + (f" over a {mesh.shape['data']}x"
                         f"{mesh.shape['table']} mesh" if mesh else ""))
            elif mesh is not None:
                from ..parallel.sharded import ShardedCoarseMapper
                mapper = ShardedCoarseMapper(genome, opts, mesh)
                print(f"window index: {mapper.memory_bytes()} bytes, "
                      f"{mapper.table.num_windows} windows sharded over a "
                      f"{mesh.shape['data']}x{mesh.shape['table']} mesh")
            else:
                mapper = CoarseMapper(
                    genome, opts, load_index_from=opts.load_hashtables_from)
                if opts.save_hashtables_to:
                    mapper.save_index(opts.save_hashtables_to)
                print(f"window index: {mapper.index.memory_bytes()} bytes, "
                      f"{mapper.table.num_windows} windows")

        pipelined = (opts.mapper_type == MapperType.SW
                     and opts.step2_pipeline_chunk > 0
                     and reads.num_reads > opts.step2_pipeline_chunk)
        bases = reads.bases_matrix(opts.max_read_length).astype(np.int8)
        if pipelined:
            # chunked STEP1/STEP2 pipeline: the host side of chunk i's fine
            # alignment overlaps chunk i+1's device coarse mapping (the
            # reference runs the phases strictly sequentially,
            # main_gpu.cu:1147-1154; results are identical — the
            # dropped-keys mask still comes from the full read set)
            with timers.phase("process genome"):
                results, mappingout = _pipelined_sw(
                    mapper, bases, reads, genome, genome_rc, opts)
        else:
            with timers.phase("process genome"):
                results: CoarseResults = mapper.map_reads(bases,
                                                          reads.lengths)
        n_mapped = int((results.orientation != 3).sum())
        print(f"coarse mapped: {n_mapped}/{reads.num_reads} "
              f"stats={results.stats}")

    with timers.phase("process mapping"):
        if opts.mapper_type == MapperType.STHELSE:
            # reference: "please implement your personal mapper"
            # (mappinghandler.cu:82-86, examplewrapper)
            print("please implement your personal mapper")
            timers.print_all()
            return {"results": results, "mappingout": [], "sam_path": None,
                    "vcf_path": None, "timers": timers.totals(),
                    "reads": reads, "genome": genome, "mapper": mapper}
        if opts.mapper_type == MapperType.SW:
            from .records import MappingRecords, emit_sam
            if not pipelined:
                mappingout = mapping.run_cssw(
                    genome, genome_rc, results.orientation, results.position,
                    results.chromosome_id, reads, opts, results.bs_strand,
                    as_records=True)
            sam_path = opts.outputfile + ".SAM"
            if isinstance(mappingout, MappingRecords):
                sam_stats = emit_sam(mappingout, genome, sam_path,
                                     threads=max(1, opts.threads))
            else:
                sam_stats = mapping.print_to_sam(mappingout, genome,
                                                 sam_path)
        else:
            from . import mapping_edlib
            mappingout = mapping_edlib.run_edlib(
                genome, genome_rc, results.orientation, results.position,
                results.chromosome_id, reads, opts)
            sam_path = opts.outputfile + ".SAM"
            sam_stats = mapping_edlib.print_to_edlib_sam(
                mappingout, genome, sam_path)
        print(f"mapped reads: {sam_stats['mapped']}")
        print(f"unmapped reads: {sam_stats['unmapped']}")

    with timers.phase("process variant calling"):
        if opts.mapper_type == MapperType.SW:
            from .records import MappingRecords, emit_vcf
            if isinstance(mappingout, MappingRecords):
                vcf_path = emit_vcf(mappingout, genome, opts.outputfile)
            else:
                vcf_path = mapping.do_vc(mappingout, genome, opts.outputfile)
        else:
            vcf_path = None

    timers.print_all()
    return {
        "results": results,
        "mappingout": mappingout,
        "sam_path": sam_path,
        "vcf_path": vcf_path,
        "timers": timers.totals(),
        "reads": reads,
        "genome": genome,
        "mapper": mapper,
    }
