"""Window-streaming orientation == inverted engine == oracle."""

import random

import numpy as np

from hashreadmapper_tpu.config import ProgramOptions
from hashreadmapper_tpu.cpu import oracle
from hashreadmapper_tpu.io.genome import Genome
from hashreadmapper_tpu.pipeline.engine import CoarseMapper
from hashreadmapper_tpu.pipeline.window_stream import WindowStreamMapper


def _dataset(seed=33, n_reads=60, chrom_lens=(700, 420), maxlen=40):
    rng = random.Random(seed)
    chroms = ["".join(rng.choice("ACGT") for _ in range(n))
              for n in chrom_lens]
    reads = []
    for _ in range(n_reads):
        rl = rng.randint(14, maxlen)
        if rng.random() < 0.8:
            c = rng.randrange(len(chroms))
            s = rng.randrange(len(chroms[c]) - rl)
            b = oracle.encode_bases(chroms[c][s:s + rl])
            if rng.random() < 0.5:
                b = oracle.revcomp_bases(b)
            if rng.random() < 0.3:
                b[rng.randrange(rl)] = rng.randrange(4)
        else:
            b = [rng.randrange(4) for _ in range(rl)]
        reads.append(b)
    bases = np.zeros((n_reads, maxlen), dtype=np.int8)
    lens = np.zeros(n_reads, dtype=np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = r
        lens[i] = len(r)
    return chroms, bases, lens


def test_window_stream_matches_engine():
    chroms, bases, lens = _dataset()
    opts = ProgramOptions(
        kmer_length=8, num_hash_functions=8, window_size=32,
        min_table_hits=2, batchsize=16, max_hamming_percent=0.15,
        probe_cap=128, candidates_per_read_cap=64, max_read_length=40,
        max_results_per_map=100000)
    genome = Genome([f"c{i}" for i in range(len(chroms))], chroms)

    eng = CoarseMapper(genome, opts).map_reads(bases.copy(), lens.copy())
    ws = WindowStreamMapper(bases.copy(), lens.copy(), opts).map_genome(genome)

    assert ws.stats["probe_overflow"] == 0
    assert ws.stats["vote_overflow"] == 0
    np.testing.assert_array_equal(ws.orientation, eng.orientation)
    mapped = eng.orientation != 3
    np.testing.assert_array_equal(ws.hamming[mapped], eng.hamming[mapped])
    np.testing.assert_array_equal(ws.shift[mapped], eng.shift[mapped])
    np.testing.assert_array_equal(ws.position[mapped], eng.position[mapped])
    np.testing.assert_array_equal(ws.chromosome_id[mapped],
                                  eng.chromosome_id[mapped])


def test_window_stream_respects_key_cap():
    # repetitive reads: tiny max_results_per_map drops over-full read keys
    rng = random.Random(2)
    unit = "".join(rng.choice("ACGT") for _ in range(30))
    chroms = [unit * 8]
    n = 40
    bases = np.zeros((n, 24), dtype=np.int8)
    lens = np.full(n, 24, dtype=np.int32)
    for i in range(n):
        s = rng.randrange(len(chroms[0]) - 24)
        bases[i, :] = oracle.encode_bases(chroms[0][s:s + 24])
    opts = ProgramOptions(
        kmer_length=8, num_hash_functions=8, window_size=32,
        min_table_hits=2, batchsize=16, max_hamming_percent=0.2,
        probe_cap=256, candidates_per_read_cap=128, max_read_length=24,
        max_results_per_map=4)
    genome = Genome(["c0"], chroms)
    eng = CoarseMapper(genome, opts).map_reads(bases.copy(), lens.copy())
    ws = WindowStreamMapper(bases.copy(), lens.copy(), opts).map_genome(genome)
    np.testing.assert_array_equal(ws.orientation, eng.orientation)
    mapped = eng.orientation != 3
    np.testing.assert_array_equal(ws.position[mapped], eng.position[mapped])


def test_window_stream_three_n_matches_engine():
    """3N window-streaming orientation == 3N inverted engine."""
    rng = random.Random(91)
    chroms, bases, lens = _dataset(seed=91)
    # bisulfite-convert the planted reads in place (C->T at 85%)
    for i in range(len(lens)):
        for j in range(lens[i]):
            if bases[i, j] == 1 and rng.random() < 0.85:
                bases[i, j] = 3
    opts = ProgramOptions(
        kmer_length=8, num_hash_functions=8, window_size=32,
        min_table_hits=2, batchsize=16, max_hamming_percent=0.2,
        probe_cap=128, candidates_per_read_cap=64, max_read_length=40,
        three_n_seeding=True)
    genome = Genome([f"c{i}" for i in range(len(chroms))], chroms)

    eng = CoarseMapper(genome, opts).map_reads(bases.copy(), lens.copy())
    assert int((eng.orientation != 3).sum()) > len(lens) // 4
    ws = WindowStreamMapper(bases.copy(), lens.copy(), opts).map_genome(genome)

    np.testing.assert_array_equal(ws.orientation, eng.orientation)
    mapped = eng.orientation != 3
    np.testing.assert_array_equal(ws.hamming[mapped], eng.hamming[mapped])
    np.testing.assert_array_equal(ws.shift[mapped], eng.shift[mapped])
    np.testing.assert_array_equal(ws.position[mapped], eng.position[mapped])
    np.testing.assert_array_equal(ws.chromosome_id[mapped],
                                  eng.chromosome_id[mapped])


def test_window_stream_budgets_match_unbudgeted():
    """Pair compaction + two-tier/head-compacted probe in the window
    orientation are bit-identical while their overflow counters stay 0
    (mirrors the engine's budget equivalence guarantees)."""
    chroms, bases, lens = _dataset()
    base = dict(
        kmer_length=8, num_hash_functions=8, window_size=32,
        min_table_hits=2, batchsize=16, max_hamming_percent=0.15,
        probe_cap=128, candidates_per_read_cap=64, max_read_length=40,
        max_results_per_map=100000)
    genome = Genome([f"c{i}" for i in range(len(chroms))], chroms)
    r0 = WindowStreamMapper(bases.copy(), lens.copy(),
                            ProgramOptions(**base)).map_genome(genome)
    r1 = WindowStreamMapper(bases.copy(), lens.copy(), ProgramOptions(
        **base, shd_pairs_per_read_budget=32,
        probe_tail_budget_per_read=64,
        probe_head_budget_per_read=64)).map_genome(genome)
    assert r1.stats["pair_budget_overflow"] == 0
    assert r1.stats["probe_tail_overflow"] == 0
    assert r1.stats["probe_head_overflow"] == 0
    for f in ("orientation", "hamming", "shift", "position",
              "chromosome_id", "global_window_id"):
        np.testing.assert_array_equal(getattr(r0, f), getattr(r1, f),
                                      err_msg=f)
