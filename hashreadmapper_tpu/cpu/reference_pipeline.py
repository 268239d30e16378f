"""Oracle end-to-end coarse mapping in the reference's own orientation.

Faithfully mirrors STEP 1 of the reference driver (reference:
src/gpu/main_gpu.cu:859-1286): build a minhash index of the READS, then stream
the genome window-by-window through it, SHD-align candidate reads to extended
windows, and keep the best (first-window-wins) hit per read.  Used as the
equivalence oracle for the engine's inverted (genome-index) orientation.
"""

from __future__ import annotations

from typing import List, Sequence

from ..config import ProgramOptions
from . import oracle


def coarse_map(chromosomes: Sequence[Sequence[int]],
               reads: Sequence[Sequence[int]],
               opts: ProgramOptions) -> List[oracle.MappedRead]:
    """Map every read against the genome; returns one MappedRead per read.

    With opts.three_n_seeding the index has 2F tables: CT-collapsed
    forward k-mer signatures of the read and GA-collapsed ones of its
    reverse complement; each window queries with its own CT and GA
    signatures, and SHD compares each orientation in its collapse space
    (directional 3N, the engine's default 3N mode)."""
    k = opts.kmer_length
    hash_ids = list(range(opts.num_hash_functions))
    three_n = opts.three_n_seeding
    spaces = ("ct", "ga") if three_n else ("", "")

    def read_sig(r):
        if not three_n:
            return oracle.minhash_signature(r, k, hash_ids)
        ct = oracle.minhash_signature(oracle.collapse_bases(r, "ct"), k,
                                      hash_ids, canonical=False)
        ga = oracle.minhash_signature(
            oracle.collapse_bases(oracle.revcomp_bases(r), "ga"), k,
            hash_ids, canonical=False)
        return None if ct is None else ct + ga

    def window_sig(w):
        if not three_n:
            return oracle.minhash_signature(w, k, hash_ids)
        ct = oracle.minhash_signature(oracle.collapse_bases(w, "ct"), k,
                                      hash_ids, canonical=False)
        ga = oracle.minhash_signature(oracle.collapse_bases(w, "ga"), k,
                                      hash_ids, canonical=False)
        return None if ct is None else ct + ga

    # STEP 1a: read index (reference: constructGpuMinhasherFromGpuReadStorage)
    read_sigs = [read_sig(r) for r in reads]
    n_tables = opts.num_hash_functions * (2 if three_n else 1)
    index = oracle.build_index_from_signatures(
        read_sigs, n_tables, opts.max_results_per_map)

    results = [oracle.MappedRead() for _ in reads]

    # STEP 1b: window loop (reference: genome.forEachBatchOfWindows +
    # WindowBatchProcessor).  Batch boundaries don't affect results; iterate
    # windows directly in genome order.
    stride = opts.window_stride
    for chrom_id, chrom in enumerate(chromosomes):
        chrom_len = len(chrom)
        nwin = oracle.num_windows_in_chromosome(chrom_len, k, opts.window_size)
        for wid in range(nwin):
            pos = wid * stride
            wlen = min(chrom_len, pos + opts.window_size) - pos
            window = chrom[pos:pos + wlen]
            sig = window_sig(window)
            cand = oracle.query_candidates(index, sig, opts.min_table_hits)
            for read_id in cand:
                read = reads[read_id]
                loc = oracle.extended_window_location(
                    chrom_len, pos, opts.window_size, len(read) // 2)
                anchor = chrom[loc.start:loc.start + loc.length]
                shd = oracle.shifted_hamming_distance(
                    anchor, read, opts.max_hamming_percent, spaces)
                new = oracle.MappedRead(
                    orientation=shd.orientation,
                    hamming_distance=shd.score,
                    shift=shd.shift - loc.left,
                    chromosome_id=chrom_id,
                    position=pos)
                results[read_id] = oracle.merge_result(results[read_id], new)
    return results
