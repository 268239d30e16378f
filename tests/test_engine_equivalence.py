"""E2E equivalence: read-streaming engine == reference-orientation oracle.

The engine indexes genome windows and streams reads; the oracle indexes reads
and streams genome windows exactly like the reference driver.  With caps large
enough, results must be IDENTICAL per read: orientation, hamming, shift,
chromosome, window position.
"""

import random

import numpy as np
import pytest

from hashreadmapper_tpu.config import ProgramOptions
from hashreadmapper_tpu.cpu import oracle, reference_pipeline
from hashreadmapper_tpu.io.genome import Genome
from hashreadmapper_tpu.pipeline.engine import CoarseMapper


def _make_genome(rng, chrom_lens):
    chroms = []
    for length in chrom_lens:
        chroms.append("".join(rng.choice("ACGT") for _ in range(length)))
    return chroms


def _make_reads(rng, chroms, n_reads, read_len_range, mutate=True):
    reads = []
    for _ in range(n_reads):
        kind = rng.random()
        rl = rng.randint(*read_len_range)
        if kind < 0.8:
            c = rng.randrange(len(chroms))
            if len(chroms[c]) <= rl:
                start = 0
                rl = min(rl, len(chroms[c]))
            else:
                start = rng.randrange(len(chroms[c]) - rl)
            seq = chroms[c][start:start + rl]
            bases = oracle.encode_bases(seq)
            if rng.random() < 0.5:
                bases = oracle.revcomp_bases(bases)
            if mutate:
                for _ in range(rng.randint(0, 1)):
                    i = rng.randrange(len(bases))
                    bases[i] = rng.randrange(4)
            reads.append(bases)
        else:
            reads.append([rng.randrange(4) for _ in range(rl)])
    return reads


def _opts(**kw):
    defaults = dict(
        kmer_length=8, num_hash_functions=8, window_size=32, min_table_hits=2,
        batchsize=64, max_results_per_map=100000, max_hamming_percent=0.1,
        probe_cap=128, candidates_per_read_cap=64, max_read_length=32)
    defaults.update(kw)
    return ProgramOptions(**defaults)


def _run_both(chroms, reads, opts):
    want = reference_pipeline.coarse_map(
        [oracle.encode_bases(c) for c in chroms], reads, opts)

    genome = Genome(names=[f"chr{i}" for i in range(len(chroms))],
                    sequences=chroms)
    mapper = CoarseMapper(genome, opts)
    n = len(reads)
    bases = np.zeros((n, opts.max_read_length), dtype=np.int8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = r
        lengths[i] = len(r)
    got = mapper.map_reads(bases, lengths)
    assert got.stats["probe_overflow"] == 0, "raise probe_cap for this test"
    assert got.stats["vote_overflow"] == 0, "raise candidate cap for this test"
    return want, got


def _assert_equal(want, got, reads):
    for i, w in enumerate(want):
        assert got.orientation[i] == w.orientation, (
            i, reads[i], w, got.orientation[i])
        if w.orientation != oracle.NONE:
            assert got.hamming[i] == w.hamming_distance, i
            assert got.shift[i] == w.shift, i
            assert got.chromosome_id[i] == w.chromosome_id, i
            assert got.position[i] == w.position, i


def test_engine_matches_oracle_basic():
    rng = random.Random(42)
    chroms = _make_genome(rng, [300, 201])
    reads = _make_reads(rng, chroms, 80, (12, 30))
    opts = _opts()
    want, got = _run_both(chroms, reads, opts)
    n_mapped = sum(1 for w in want if w.orientation != oracle.NONE)
    assert n_mapped >= 30, "test should exercise mapped reads"
    _assert_equal(want, got, reads)


def test_engine_matches_oracle_min_hits_1():
    rng = random.Random(7)
    chroms = _make_genome(rng, [250])
    reads = _make_reads(rng, chroms, 50, (10, 28))
    opts = _opts(min_table_hits=1)
    want, got = _run_both(chroms, reads, opts)
    _assert_equal(want, got, reads)


def test_engine_matches_oracle_with_key_dropping():
    rng = random.Random(3)
    # repetitive genome so identical reads share signatures
    unit = "".join(rng.choice("ACGT") for _ in range(40))
    chroms = [unit * 6]
    reads = _make_reads(rng, chroms, 60, (12, 24), mutate=False)
    # tiny cap: many read keys get dropped in the reference read index
    opts = _opts(max_results_per_map=5, probe_cap=512,
                 candidates_per_read_cap=256)
    want, got = _run_both(chroms, reads, opts)
    _assert_equal(want, got, reads)


def test_engine_short_reads_unmapped():
    chroms = ["ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT"]
    reads = [[0, 1, 2]]  # length 3 < k
    opts = _opts()
    want, got = _run_both(chroms, reads, opts)
    assert want[0].orientation == oracle.NONE
    assert got.orientation[0] == oracle.NONE


@pytest.mark.parametrize("seed", [11, 12])
def test_engine_matches_oracle_three_n(seed):
    """3N seeding on bisulfite reads (C->T in read space, half of them
    reverse-complemented) == the reference-orientation 3N oracle."""
    rng = random.Random(seed)
    chroms = _make_genome(rng, [400, 260])
    reads = [[3 if (b == 1 and rng.random() < 0.9) else b for b in r]
             for r in _make_reads(rng, chroms, 60, (14, 30))]
    opts = _opts(three_n_seeding=True, max_hamming_percent=0.15)
    want, got = _run_both(chroms, reads, opts)
    n_mapped = sum(1 for w in want if w.orientation != oracle.NONE)
    assert n_mapped >= 20, "test should exercise mapped reads"
    _assert_equal(want, got, reads)
