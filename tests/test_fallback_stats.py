"""Probe surfacing: the cuckoo direct probe degrades to the slower
bit-identical binary search when its table cannot be built; that must show
up in CoarseResults.stats (and the reason once on stderr) so a production
perf regression is visible.

Reference behavior being guarded: the warpcore direct table vs the sorted
fallback in gpuhashtable.cuh — the reference has no silent mode switch of
this kind, so neither may we."""

import random

import numpy as np

from hashreadmapper_tpu.config import ProgramOptions
from hashreadmapper_tpu.index import minhash_index as mi
from hashreadmapper_tpu.io.genome import Genome
from hashreadmapper_tpu.pipeline.engine import CoarseMapper


def _tiny(seed=3, n_reads=16, chrom_len=600, maxlen=32):
    rng = random.Random(seed)
    chrom = "".join(rng.choice("ACGT") for _ in range(chrom_len))
    bases = np.zeros((n_reads, maxlen), dtype=np.int8)
    lens = np.full(n_reads, maxlen, dtype=np.int32)
    b2i = {c: i for i, c in enumerate("ACGT")}
    for i in range(n_reads):
        s = rng.randrange(chrom_len - maxlen)
        bases[i] = [b2i[c] for c in chrom[s:s + maxlen]]
    return chrom, bases, lens


def _opts(**kw):
    base = dict(kmer_length=8, num_hash_functions=8, window_size=32,
                min_table_hits=2, batchsize=8, max_hamming_percent=0.15,
                probe_cap=16, candidates_per_read_cap=8, max_read_length=32)
    base.update(kw)
    return ProgramOptions(**base)


def test_stats_carry_fallback_keys():
    chrom, bases, lens = _tiny()
    mapper = CoarseMapper(Genome(["c0"], [chrom]), _opts())
    res = mapper.map_reads(bases, lens)
    assert "cuckoo_direct_probe" in res.stats
    # every stage has one device path: no kernel-choice stats remain
    assert "vote_kernel_fallback" not in res.stats
    assert "sw_kernel_fallback" not in res.stats
    # direct probe reflects whether the cuckoo table was actually built
    assert res.stats["cuckoo_direct_probe"] == int(
        mapper.index.cuckoo_keys is not None)


def test_cuckoo_fallback_reason_on_wide_values(capsys):
    """probe_cap >= 1023 skips the cuckoo build entirely (by design);
    a width overflow must record the reason instead of silently falling
    back to binary search."""
    chrom, bases, lens = _tiny()
    mapper = CoarseMapper(Genome(["c0"], [chrom]), _opts())
    idx = mapper.index
    if idx.cuckoo_keys is None:
        # native builder unavailable in this environment: the reason
        # must say so
        assert idx.cuckoo_fallback_reason is not None
        return
    # rebuild with a value array too wide for the 22-bit offset field
    built, reason = mi.build_cuckoo_arrays(
        np.asarray(idx.keys), np.asarray(idx.offsets),
        np.asarray(idx.num_keys), 1 << 22)
    assert built is None
    assert "22-bit" in reason


def test_fallback_note_prints_once(capsys):
    """The stderr note fires at most once per mapper (and states the
    cuckoo reason when the direct probe is disabled)."""
    chrom, bases, lens = _tiny()
    mapper = CoarseMapper(Genome(["c0"], [chrom]), _opts())
    # force a disabled direct probe with a recorded reason
    mapper.index.cuckoo_keys = None
    mapper.index.cuckoo_fallback_reason = "forced by test"
    mapper.map_reads(bases, lens)
    err1 = capsys.readouterr().err
    assert "forced by test" in err1
    mapper.map_reads(bases, lens)
    assert "forced by test" not in capsys.readouterr().err
