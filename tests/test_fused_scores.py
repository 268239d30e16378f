"""Fused coarse+STEP-2 score pass (engine._step2_scores) equivalence.

The fused device step must reproduce the standalone STEP-2 dispatch
(pipeline/mapping.py array prep + ops/swdev.py) bit-for-bit, and the
pipelined driver's fused path must emit byte-identical SAM/VCF."""

import numpy as np
import pytest

from hashreadmapper_tpu import native
from hashreadmapper_tpu.config import ProgramOptions
from hashreadmapper_tpu.io.genome import Genome
from hashreadmapper_tpu.io.readstore import ReadStorage, pack_rows
from hashreadmapper_tpu.pipeline import mapping
from hashreadmapper_tpu.pipeline.driver import _pipelined_sw
from hashreadmapper_tpu.pipeline.engine import CoarseMapper

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


def _setup(rng, n_reads=96, genome_len=20000, read_len=72,
           undirectional=False, with_n=True):
    codes = rng.integers(0, 4, size=genome_len, dtype=np.int8)
    chrom = np.array(list("ACGT"))[codes]
    if with_n:
        # sprinkle Ns so the STEP-2 ref path (N -> code 4) is exercised
        npos = rng.integers(0, genome_len, size=genome_len // 500)
        chrom[npos] = "N"
    genome = Genome(["chrF"], ["".join(chrom)])
    starts = rng.integers(0, genome_len - read_len, size=n_reads)
    reads = codes[starts[:, None] + np.arange(read_len)[None, :]].copy()
    sub = rng.random(reads.shape) < 0.02
    reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    conv = (reads == 1) & (rng.random(reads.shape) < 0.8)
    reads[conv] = 3
    if undirectional:
        pbat = rng.random(n_reads) < 0.5
        ga = (reads == 2) & (rng.random(reads.shape) < 0.8)
        reads[pbat & True] = reads[pbat]  # no-op, keep shape
        reads[np.ix_(pbat, np.arange(read_len))] = np.where(
            ga[pbat], 0, reads[pbat])
    junk = rng.random(n_reads) < 0.15
    reads[junk] = rng.integers(0, 4, size=(int(junk.sum()), read_len),
                               dtype=np.int8)
    opts = ProgramOptions(
        kmer_length=16, num_hash_functions=8, window_size=128,
        min_table_hits=2, batchsize=32, max_hamming_percent=0.5,
        probe_cap=16, candidates_per_read_cap=8, max_read_length=96,
        threads=2, three_n_seeding=True, undirectional=undirectional)
    lengths = np.full(n_reads, read_len, np.int32)
    store = ReadStorage(pack_rows(reads, lengths, (read_len + 15) // 16),
                        lengths, np.zeros(n_reads, bool))
    padded = np.pad(reads, ((0, 0), (0, opts.max_read_length - read_len))
                    ).astype(np.int8)
    return genome, opts, store, padded, lengths


@pytest.mark.parametrize("undirectional", [False, True])
def test_fused_scores_match_standalone_dispatch(undirectional):
    rng = np.random.default_rng(3 if undirectional else 2)
    genome, opts, store, padded, lengths = _setup(
        rng, undirectional=undirectional)
    genome_rc = genome.reverse_complement()
    mapper = CoarseMapper(genome, opts)
    res, scores = mapper.map_reads(padded, lengths, with_scores=True)
    # scores bundle = (scores, tb_ops uint8, tb_status) with the fused
    # device traceback (the default)
    assert isinstance(scores, tuple)
    assert scores[0].shape == (10, 2 * store.num_reads)
    assert scores[1].shape[0] == 2 * store.num_reads
    assert scores[1].dtype == np.uint8
    assert int((res.orientation != 3).sum()) > 0

    out_fused = mapping.run_cssw(
        genome, genome_rc, res.orientation, res.position,
        res.chromosome_id, store, opts, res.bs_strand, pre_scores=scores)
    out_plain = mapping.run_cssw(
        genome, genome_rc, res.orientation, res.position,
        res.chromosome_id, store, opts, res.bs_strand)
    assert len(out_fused) == len(out_plain)
    for a, b in zip(out_fused, out_plain):
        for h in range(2):
            x, y = a.alignments[h], b.alignments[h]
            assert (x.sw_score, x.sw_score_next_best, x.ref_begin,
                    x.ref_end, x.query_begin, x.query_end,
                    x.cigar_string, x.mismatches, x.flag) == \
                   (y.sw_score, y.sw_score_next_best, y.ref_begin,
                    y.ref_end, y.query_begin, y.query_end,
                    y.cigar_string, y.mismatches, y.flag), a.read_id
        assert a.num_conversions == b.num_conversions
        assert (a.flag, a.flag_rc) == (b.flag, b.flag_rc)


def _assert_same_alignments(out_fused, out_plain):
    assert len(out_fused) == len(out_plain)
    for a, b in zip(out_fused, out_plain):
        for h in range(2):
            x, y = a.alignments[h], b.alignments[h]
            assert (x.sw_score, x.sw_score_next_best, x.query_begin,
                    x.query_end, x.cigar_string, x.flag) == \
                   (y.sw_score, y.sw_score_next_best, y.query_begin,
                    y.query_end, y.cigar_string, y.flag), a.read_id
        assert a.num_conversions == b.num_conversions


def test_region_sharded_fused_scores_identical():
    """RegionShardedMapper's fused score+traceback bundle (winner-region
    selection) must reproduce the standalone STEP-2 dispatch bit-for-bit
    (the production big-genome path once lost the fusion)."""
    from hashreadmapper_tpu.parallel.region_sharded import (
        RegionShardedMapper)
    rng = np.random.default_rng(21)
    genome, opts, store, padded, lengths = _setup(rng, n_reads=96,
                                                  genome_len=30000)
    genome_rc = genome.reverse_complement()
    rsm = RegionShardedMapper(genome, opts, 3, partition="window")
    assert rsm.supports_fused_scores
    res, bundle = rsm.map_reads(padded, lengths, with_scores=True)
    assert isinstance(bundle, tuple)
    out_fused = mapping.run_cssw(
        genome, genome_rc, res.orientation, res.position,
        res.chromosome_id, store, opts, res.bs_strand, pre_scores=bundle)
    out_plain = mapping.run_cssw(
        genome, genome_rc, res.orientation, res.position,
        res.chromosome_id, store, opts, res.bs_strand)
    _assert_same_alignments(out_fused, out_plain)


def test_mesh_fused_scores_identical():
    """ShardedCoarseMapper's fused bundle over a (data x table) mesh must
    reproduce the standalone STEP-2 dispatch bit-for-bit."""
    import jax
    from hashreadmapper_tpu.parallel.sharded import (ShardedCoarseMapper,
                                                     make_mesh)
    if len(jax.devices()) < 4:
        import pytest as _pytest
        _pytest.skip("needs the 8-device virtual CPU mesh")
    rng = np.random.default_rng(22)
    genome, opts, store, padded, lengths = _setup(rng, n_reads=64)
    genome_rc = genome.reverse_complement()
    mesh = make_mesh(2, 2)
    scm = ShardedCoarseMapper(genome, opts, mesh)
    assert scm.supports_fused_scores
    res, bundle = scm.map_reads(padded, lengths, with_scores=True)
    assert isinstance(bundle, tuple)
    out_fused = mapping.run_cssw(
        genome, genome_rc, res.orientation, res.position,
        res.chromosome_id, store, opts, res.bs_strand, pre_scores=bundle)
    out_plain = mapping.run_cssw(
        genome, genome_rc, res.orientation, res.position,
        res.chromosome_id, store, opts, res.bs_strand)
    _assert_same_alignments(out_fused, out_plain)


def test_streaming_pipelined_driver_sam_identical(tmp_path):
    """The dispatch-ahead streaming path (chunk % batchsize == 0, whole
    pool resident: one uint8 bundle fetch per chunk) must emit byte-
    identical SAM/VCF to the per-chunk map_reads path."""
    rng = np.random.default_rng(17)
    genome, opts, store, padded, lengths = _setup(rng, n_reads=160)
    genome_rc = genome.reverse_complement()
    mapper = CoarseMapper(genome, opts)

    from hashreadmapper_tpu.pipeline.records import MappingRecords

    def as_aas(out):
        return out.to_aas() if isinstance(out, MappingRecords) else out

    opts.step2_pipeline_chunk = 64          # 64 % 32 == 0 -> stream
    res_s, aas_s = _pipelined_sw(mapper, padded, store, genome, genome_rc,
                                 opts)
    assert "probe_overflow" in res_s.stats
    opts.step2_pipeline_chunk = 48          # 48 % 32 != 0 -> per-chunk
    res_p, aas_p = _pipelined_sw(mapper, padded, store, genome, genome_rc,
                                 opts)
    np.testing.assert_array_equal(res_s.orientation, res_p.orientation)
    np.testing.assert_array_equal(res_s.position, res_p.position)
    sam_s = tmp_path / "stream.SAM"
    sam_p = tmp_path / "plain.SAM"
    mapping.print_to_sam(as_aas(aas_s), genome, str(sam_s))
    mapping.print_to_sam(as_aas(aas_p), genome, str(sam_p))
    assert sam_s.read_bytes() == sam_p.read_bytes()


def test_fused_pipelined_driver_sam_identical(tmp_path):
    rng = np.random.default_rng(9)
    genome, opts, store, padded, lengths = _setup(rng, n_reads=128)
    genome_rc = genome.reverse_complement()
    opts.step2_pipeline_chunk = 48
    mapper = CoarseMapper(genome, opts)

    from hashreadmapper_tpu.pipeline.records import MappingRecords

    def as_aas(out):
        return out.to_aas() if isinstance(out, MappingRecords) else out

    res_f, aas_f = _pipelined_sw(mapper, padded, store, genome, genome_rc,
                                 opts)
    aas_f = as_aas(aas_f)
    opts.step2_device = True
    # force the unfused path by hiding the capability
    mapper.supports_fused_scores = False
    res_p, aas_p = _pipelined_sw(mapper, padded, store, genome, genome_rc,
                                 opts)
    aas_p = as_aas(aas_p)
    np.testing.assert_array_equal(res_f.orientation, res_p.orientation)
    np.testing.assert_array_equal(res_f.position, res_p.position)

    sam_f = tmp_path / "fused.SAM"
    sam_p = tmp_path / "plain.SAM"
    mapping.print_to_sam(aas_f, genome, str(sam_f))
    mapping.print_to_sam(aas_p, genome, str(sam_p))
    assert sam_f.read_bytes() == sam_p.read_bytes()
    mapping.do_vc(aas_f, genome, str(tmp_path / "fused"))
    mapping.do_vc(aas_p, genome, str(tmp_path / "plain"))
    assert (tmp_path / "fused.VCF").read_bytes() == \
        (tmp_path / "plain.VCF").read_bytes()
