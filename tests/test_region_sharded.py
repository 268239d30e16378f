"""Genome-region sharding == single-device engine (chromosome binning)."""

import random

import numpy as np
import pytest

import jax

from hashreadmapper_tpu.config import ProgramOptions
from hashreadmapper_tpu.cpu import oracle
from hashreadmapper_tpu.io.genome import Genome
from hashreadmapper_tpu.parallel.region_sharded import (
    RegionShardedMapper, bin_chromosomes)
from hashreadmapper_tpu.pipeline.engine import CoarseMapper


def _dataset(seed=51, n_reads=70, chrom_lens=(600, 350, 500, 280), maxlen=36):
    rng = random.Random(seed)
    chroms = ["".join(rng.choice("ACGT") for _ in range(n))
              for n in chrom_lens]
    reads = []
    for _ in range(n_reads):
        rl = rng.randint(14, maxlen)
        if rng.random() < 0.85:
            c = rng.randrange(len(chroms))
            s = rng.randrange(len(chroms[c]) - rl)
            b = oracle.encode_bases(chroms[c][s:s + rl])
            if rng.random() < 0.5:
                b = oracle.revcomp_bases(b)
        else:
            b = [rng.randrange(4) for _ in range(rl)]
        reads.append(b)
    bases = np.zeros((n_reads, maxlen), dtype=np.int8)
    lens = np.zeros(n_reads, dtype=np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = r
        lens[i] = len(r)
    return chroms, bases, lens


def test_binning_balanced_and_complete():
    g = Genome(["a", "b", "c", "d", "e"],
               ["A" * 100, "A" * 900, "A" * 50, "A" * 500, "A" * 450])
    bins = bin_chromosomes(g, 2)
    assert sorted(sum(bins, [])) == [0, 1, 2, 3, 4]
    loads = [sum(g.chromosome_length(c) for c in b) for b in bins]
    assert max(loads) <= 1100


@pytest.mark.parametrize("n_regions", [2, 4])
def test_region_sharded_matches_single(n_regions):
    if len(jax.devices()) < n_regions:
        pytest.skip("needs devices")
    chroms, bases, lens = _dataset()
    opts = ProgramOptions(
        kmer_length=8, num_hash_functions=8, window_size=32,
        min_table_hits=2, batchsize=32, max_hamming_percent=0.15,
        probe_cap=64, candidates_per_read_cap=32, max_read_length=36)
    genome = Genome([f"c{i}" for i in range(len(chroms))], chroms)

    single = CoarseMapper(genome, opts).map_reads(
        bases.copy(), lens.copy(), emulate_read_key_drop=False)
    sharded = RegionShardedMapper(genome, opts, n_regions).map_reads(
        bases.copy(), lens.copy())

    np.testing.assert_array_equal(sharded.orientation, single.orientation)
    m = single.orientation != 3
    np.testing.assert_array_equal(sharded.hamming[m], single.hamming[m])
    np.testing.assert_array_equal(sharded.shift[m], single.shift[m])
    np.testing.assert_array_equal(sharded.position[m], single.position[m])
    np.testing.assert_array_equal(sharded.chromosome_id[m],
                                  single.chromosome_id[m])
    np.testing.assert_array_equal(sharded.global_window_id[m],
                                  single.global_window_id[m])


# ---------------------------------------------------------------------------
# intra-chromosome window partition (parallel/segments.py)
# ---------------------------------------------------------------------------

def _opts(**kw):
    from hashreadmapper_tpu.config import ProgramOptions
    base = dict(kmer_length=8, num_hash_functions=8, window_size=32,
                min_table_hits=2, batchsize=32, max_hamming_percent=0.15,
                probe_cap=64, candidates_per_read_cap=32, max_read_length=36)
    base.update(kw)
    return ProgramOptions(**base)


def test_partition_windows_covers_all():
    from hashreadmapper_tpu.parallel.segments import partition_windows
    g = Genome(["a", "b"], ["A" * 700, "A" * 300])
    opts = _opts()
    for n in (1, 2, 3, 5, 8):
        regions = partition_windows(g, opts, n)
        assert len(regions) == n and all(regions)
        # exact cover, in genome order, no overlap
        flat = [s for r in regions for s in r]
        cur = {}
        for s in flat:
            assert s.win_start == cur.get(s.chrom_id, 0)
            cur[s.chrom_id] = s.win_stop
        for c in range(g.num_chromosomes):
            assert cur[c] == g.num_windows_in_chromosome(
                c, opts.kmer_length, opts.window_size)


@pytest.mark.parametrize("n_regions", [3, 6])
def test_window_partition_matches_single(n_regions):
    """Intra-chromosome cuts: results equal the uncut single mapper."""
    chroms, bases, lens = _dataset()
    opts = _opts()
    genome = Genome([f"c{i}" for i in range(len(chroms))], chroms)

    single = CoarseMapper(genome, opts).map_reads(
        bases.copy(), lens.copy(), emulate_read_key_drop=False)
    sharded = RegionShardedMapper(
        genome, opts, n_regions, partition="window").map_reads(
        bases.copy(), lens.copy())

    np.testing.assert_array_equal(sharded.orientation, single.orientation)
    m = single.orientation != 3
    for f in ("hamming", "shift", "position", "chromosome_id",
              "global_window_id"):
        np.testing.assert_array_equal(
            getattr(sharded, f)[m], getattr(single, f)[m], err_msg=f)
    np.testing.assert_array_equal(
        sharded.global_window_id64[m],
        single.global_window_id[m].astype(np.int64))


def test_window_partition_single_chromosome():
    """More regions than chromosomes (the >2 Gbp single-chromosome shape)."""
    rng = random.Random(7)
    chrom = "".join(rng.choice("ACGT") for _ in range(1500))
    reads, lens_l = [], []
    for _ in range(60):
        rl = rng.randint(14, 36)
        s = rng.randrange(len(chrom) - rl)
        b = oracle.encode_bases(chrom[s:s + rl])
        if rng.random() < 0.5:
            b = oracle.revcomp_bases(b)
        reads.append(b)
    bases = np.zeros((len(reads), 36), dtype=np.int8)
    lens = np.zeros(len(reads), dtype=np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = r
        lens[i] = len(r)
    genome = Genome(["c0"], [chrom])
    opts = _opts()

    single = CoarseMapper(genome, opts).map_reads(
        bases.copy(), lens.copy(), emulate_read_key_drop=False)
    sharded = RegionShardedMapper(genome, opts, 5).map_reads(
        bases.copy(), lens.copy())

    np.testing.assert_array_equal(sharded.orientation, single.orientation)
    m = single.orientation != 3
    for f in ("hamming", "shift", "position", "chromosome_id",
              "global_window_id"):
        np.testing.assert_array_equal(
            getattr(sharded, f)[m], getattr(single, f)[m], err_msg=f)


def test_window_partition_three_n():
    """3N seeding through the segment path."""
    rng = random.Random(11)
    chroms = ["".join(rng.choice("ACGT") for _ in range(500)),
              "".join(rng.choice("ACGT") for _ in range(400))]
    reads = []
    for _ in range(50):
        rl = rng.randint(16, 36)
        c = rng.randrange(2)
        s = rng.randrange(len(chroms[c]) - rl)
        b = oracle.encode_bases(chroms[c][s:s + rl])
        rc = rng.random() < 0.5
        if rc:
            b = oracle.revcomp_bases(b)
        # bisulfite-convert: C->T on the sequenced strand
        b = [3 if (x == 1 and rng.random() < 0.9) else x for x in b]
        reads.append(b)
    bases = np.zeros((len(reads), 36), dtype=np.int8)
    lens = np.zeros(len(reads), dtype=np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = r
        lens[i] = len(r)
    genome = Genome(["c0", "c1"], chroms)
    opts = _opts(three_n_seeding=True)

    single = CoarseMapper(genome, opts).map_reads(bases.copy(), lens.copy())
    sharded = RegionShardedMapper(
        genome, opts, 4, partition="window").map_reads(
        bases.copy(), lens.copy())

    np.testing.assert_array_equal(sharded.orientation, single.orientation)
    m = single.orientation != 3
    assert m.sum() > 25
    for f in ("hamming", "shift", "position", "chromosome_id"):
        np.testing.assert_array_equal(
            getattr(sharded, f)[m], getattr(single, f)[m], err_msg=f)


# ---------------------------------------------------------------------------
# binding caps: the probe and vote caps hold over the whole genome
# ---------------------------------------------------------------------------

def _repeat_dataset(seed, three_n):
    """Chromosomes built from a few shared units, so keys carry many
    windows (the probe cap binds) and reads vote for many windows (the
    vote cap binds)."""
    rng = random.Random(seed)
    units = ["".join(rng.choice("ACGT") for _ in range(40)) for _ in range(3)]
    chroms = []
    for n_units in (9, 6, 8, 5):
        parts = []
        for _ in range(n_units):
            u = list(rng.choice(units))
            u[rng.randrange(40)] = rng.choice("ACGT")
            parts.append("".join(u) + "".join(
                rng.choice("ACGT") for _ in range(rng.randint(0, 12))))
        chroms.append("".join(parts))
    reads = []
    for _ in range(64):
        rl = rng.randint(20, 36)
        c = rng.randrange(len(chroms))
        s = rng.randrange(len(chroms[c]) - rl)
        b = oracle.encode_bases(chroms[c][s:s + rl])
        if rng.random() < 0.5:
            b = oracle.revcomp_bases(b)
        if three_n:
            b = [3 if (x == 1 and rng.random() < 0.9) else x for x in b]
        reads.append(b)
    bases = np.zeros((len(reads), 36), dtype=np.int8)
    lens = np.zeros(len(reads), dtype=np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = r
        lens[i] = len(r)
    return Genome([f"c{i}" for i in range(len(chroms))], chroms), bases, lens


@pytest.mark.parametrize("three_n", [False, True])
@pytest.mark.parametrize("partition,n_regions",
                         [("window", 3), ("window", 5), ("chromosome", 2),
                          ("chromosome", 4)])
def test_binding_caps_match_single(partition, n_regions, three_n):
    """Probe cap 3 and vote cap 2 bind; the regions still equal one
    mapper, overflow counters included.  Chromosome bins interleave the
    regions in genome order (c0+c2 | c1+c3 with 2 regions)."""
    genome, bases, lens = _repeat_dataset(17 + n_regions, three_n)
    opts = _opts(min_table_hits=1, probe_cap=3, candidates_per_read_cap=2,
                 three_n_seeding=three_n)

    single = CoarseMapper(genome, opts).map_reads(
        bases.copy(), lens.copy(), emulate_read_key_drop=False)
    assert single.stats["probe_overflow"] > 0
    assert single.stats["vote_overflow"] > 0
    sharded = RegionShardedMapper(
        genome, opts, n_regions, partition=partition).map_reads(
        bases.copy(), lens.copy())

    np.testing.assert_array_equal(sharded.orientation, single.orientation)
    m = single.orientation != 3
    assert m.sum() > 20
    for f in ("hamming", "shift", "position", "chromosome_id",
              "global_window_id"):
        np.testing.assert_array_equal(
            getattr(sharded, f)[m], getattr(single, f)[m], err_msg=f)
    for key in ("probe_overflow", "vote_overflow"):
        assert sharded.stats[key] == single.stats[key], key
