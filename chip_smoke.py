"""Smoke test of the BS-seq mapper on the GPU: the main path, end to end.

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # phase 5 only, on four cards

Phases (every comparison is exact; everything compared is integer):
  1 device   platform, kind and count as JAX reports them; the card's name
             and power limit (nvidia-smi); the native library, built from
             native/ by `make`; the tests marked `gpu`.
  2 kernels  each device stage against its plain reference at real widths:
             minhash signatures (cpu/oracle), CSR build + probe (a numpy
             index from the same signatures), vote (cpu/oracle), SHD (the
             bit-plane path vs the one-hot scan vs cpu/oracle), the
             striped-SW score pass (native host SSW) and the banded
             traceback (native host banded DP).
  3 small    a seeded 256 kbp genome and 2,048 3N reads through
             run_pipeline: coarse results equal cpu/reference_pipeline,
             and step2_device on/off write byte-identical SAM and VCF.
  4 main     a seeded chromosome of chr1's length and 262,144 100-bp BS
             reads (90% C->T, half reverse-complemented, 10% junk) as
             FASTA and gzipped FASTQ, mapped by the README command through
             the CLI's main: one SAM row per read, >= 80% mapped, >= 99% of
             mapped reads at their planted start, no budget overflow.
  5          (--four-cards only) phase 4's data and command through
             run_pipeline on one card, on a 2x2 (data x table) mesh and in
             4 regions over 4 cards, where the probe and vote caps bind:
             the three SAMs must be byte-identical and the overflow
             counters equal.

The last line of stdout is {"ok": true, "device": {...}}.  Any failure —
no GPU, a phase that fails, a comparison that differs — exits non-zero
without it.  Compiled programs are kept in JAX's persistent cache
(hashreadmapper_tpu/utils/jaxcache.py), so a second run compiles less.
"""

import argparse
import ast
import contextlib
import dataclasses
import gzip
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

CHR1_LEN = 248_956_422        # GRCh38 chr1


@dataclasses.dataclass
class Sizes:
    small_genome: int = 256_000
    small_reads: int = 2048
    main_genome: int = CHR1_LEN
    main_reads: int = 262_144
    read_len: int = 100
    batch: int = 4096          # device batch of the kernel comparisons
    probe_genome: int = 2_000_000


def log(msg):
    print(msg, flush=True)


class Compiles:
    """Backend compile (or persistent-cache fetch) seconds, from JAX's
    own monitoring events."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.count = 0

        def listen(event, duration, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.seconds += duration
                self.count += 1

        jax.monitoring.register_event_duration_secs_listener(listen)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device(card):
    """Device facts, the native library and the card's own tests.  The
    tests run in a child before this process touches the card, so one
    process holds the card at a time."""
    from hashreadmapper_tpu import native

    log(f"[1] card: {card}")
    assert native.available(), "native library did not build (make -C native)"
    log(f"[1] native library: {native._SO_PATH}")
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p",
         "no:cacheprovider", "tests/"], cwd=REPO, env=env,
        capture_output=True, text=True)
    tail = r.stdout.strip().splitlines()[-1:] or [r.stderr[-400:]]
    log(f"[1] gpu-marked tests: rc={r.returncode} {tail[0]} "
        f"({time.perf_counter() - t0:.1f} s)")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert " passed" in tail[0] and "skipped" not in tail[0], tail


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _bs_reads(rng, genome, n, lq, read_len):
    """n reads of read_len from genome (int8 codes), half RC, 90% C->T."""
    starts = rng.integers(0, len(genome) - read_len, n)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]].copy()
    rc = rng.random(n) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    conv = (reads == 1) & (rng.random(reads.shape) < 0.9)
    reads[conv] = 3
    out = np.zeros((n, lq), np.int8)
    out[:, :read_len] = reads
    return out, starts


def check_signatures(sz, rng):
    import jax.numpy as jnp

    from hashreadmapper_tpu.cpu import oracle
    from hashreadmapper_tpu.ops import encode, minhash

    k, f, lq = 16, 16, 160
    genome = rng.integers(0, 4, 1 << 20).astype(np.int8)
    reads, _ = _bs_reads(rng, genome, sz.batch, lq, sz.read_len)
    lens = np.full(sz.batch, sz.read_len, np.int32)
    lens[:4] = [0, k - 1, k, lq]
    hid = np.arange(f, dtype=np.uint32)
    s3n = np.asarray(minhash.signatures_3n_pair(
        jnp.asarray(reads), jnp.asarray(lens), k, jnp.asarray(hid))[0])
    scan = np.asarray(minhash.minhash_signatures(
        jnp.asarray(reads), jnp.asarray(lens), k, jnp.asarray(hid))[0])
    rc_all = np.asarray(encode.revcomp_bases(jnp.asarray(reads),
                                             jnp.asarray(lens)))
    rows = list(range(8)) + list(rng.choice(sz.batch, 40, replace=False))
    for r in rows:
        b = [int(x) for x in reads[r, :lens[r]]]
        rcb = [int(x) for x in rc_all[r, :lens[r]]]
        ct = oracle.minhash_signature(oracle.collapse_bases(b, "ct"), k,
                                      hid.tolist(), canonical=False)
        ga = oracle.minhash_signature(oracle.collapse_bases(rcb, "ga"), k,
                                      hid.tolist(), canonical=False)
        can = oracle.minhash_signature(b, k, hid.tolist())
        want3 = ([0xFFFFFFFF] * 2 * f) if ct is None else ct + ga
        wantc = ([0xFFFFFFFF] * f) if can is None else can
        assert s3n[r].tolist() == want3, f"3N signatures differ, row {r}"
        assert scan[r].tolist() == wantc, f"signatures differ, row {r}"
    log(f"[2] minhash signatures: {len(rows)} rows x ({2 * f} 3N + {f} "
        f"canonical) hashes equal cpu/oracle (batch {sz.batch}, lq {lq})")


def check_probe_and_vote(sz, rng):
    """The engine's 3N window index (device CSR build + cuckoo table) and
    probe at the CLI's widths vs a numpy index built from the same window
    signatures; then the vote vs cpu/oracle.vote_rows."""
    import jax.numpy as jnp

    from hashreadmapper_tpu.cli import options_from_args
    from hashreadmapper_tpu.cpu import oracle
    from hashreadmapper_tpu.index import minhash_index as mi
    from hashreadmapper_tpu.io.genome import Genome
    from hashreadmapper_tpu.ops import minhash
    from hashreadmapper_tpu.pipeline.engine import CoarseMapper

    opts = options_from_args(["-k", "16", "-m", "16", "--windowSize", "128",
                              "--minTableHits", "4", "--threeN",
                              "--batchsize", str(sz.batch)])
    g = rng.integers(0, 4, sz.probe_genome).astype(np.int8)
    genome = Genome(["chrP"], [np.frombuffer(b"ACGT", np.uint8)[g]
                               .tobytes().decode()])
    mapper = CoarseMapper(genome, opts)
    idx = mapper.index
    assert idx.cuckoo_keys is not None, idx.cuckoo_fallback_reason
    k, ws = opts.kmer_length, opts.window_size
    win_pos, _, win_len = mapper._window_geometry()
    wb = g[np.minimum(win_pos[:, None] + np.arange(ws)[None, :], len(g) - 1)]
    hid = jnp.asarray(mapper.hash_ids)
    wsig = np.concatenate([np.asarray(minhash.minhash_signatures(
        jnp.asarray(np.where(wb == a, b, wb).astype(np.int8)),
        jnp.asarray(win_len), k, hid, canonical=False)[0])
        for a, b in ((1, 3), (2, 0))], axis=1)           # [W, 2F] CT | GA

    reads, _ = _bs_reads(rng, g, sz.batch, opts.max_read_length,
                         sz.read_len)
    lens = jnp.full((sz.batch,), sz.read_len, jnp.int32)
    qsig, qvalid = minhash.signatures_3n_pair(jnp.asarray(reads), lens, k,
                                              hid)
    qs = np.asarray(qsig)
    cap = opts.probe_cap
    # numpy reference: per table, (key, window id) sorted; a query's hits
    # are the ids of its key, ascending, first `cap` of them
    n_tab = wsig.shape[1]
    want = np.full((n_tab, sz.batch, cap), 0xFFFFFFFF, np.uint32)
    want_cnt = np.zeros((n_tab, sz.batch), np.int32)
    for t in range(n_tab):
        order = np.lexsort((np.arange(len(wsig)), wsig[:, t]))
        keys, ids = wsig[order, t], order.astype(np.uint32)
        lo = np.searchsorted(keys, qs[:, t], "left")
        hi = np.searchsorted(keys, qs[:, t], "right")
        want_cnt[t] = hi - lo
        take = lo[:, None] + np.arange(cap)[None, :]
        ok = take < np.minimum(hi, lo + cap)[:, None]
        want[t][ok] = ids[np.minimum(take, len(ids) - 1)][ok]
    for label, kw in (("cuckoo", dict(
            cuckoo=(idx.cuckoo_keys, idx.cuckoo_payload),
            cuckoo_bits=idx.cuckoo_bits, cuckoo_seeds=idx.cuckoo_seeds)),
            ("binary search", dict(bucket_start=idx.bucket_start,
                                   probe_steps=idx.probe_steps))):
        cand, cnt = mi.probe_tables(idx.keys, idx.offsets, idx.values,
                                    idx.num_keys, qsig, qvalid, cap,
                                    fnc_layout=True, **kw)
        assert np.array_equal(np.asarray(cand), want), f"{label} probe"
        assert np.array_equal(np.asarray(cnt), want_cnt), f"{label} counts"
    log(f"[2] CSR build + probe ({len(wsig)} windows x {n_tab} tables, "
        f"{sz.batch} reads, cap {cap}; cuckoo and binary search) equal the "
        f"numpy index; {int((want_cnt > 0).sum())} hits")
    cand_nfc = np.asarray(cand).transpose(1, 0, 2)
    got = mi.vote_candidates(jnp.asarray(cand_nfc), opts.min_table_hits,
                             opts.candidates_per_read_cap)
    for a, b in zip(got, oracle.vote_rows(cand_nfc, opts.min_table_hits,
                                          opts.candidates_per_read_cap)):
        assert np.array_equal(np.asarray(a), b), "vote differs from oracle"
    log(f"[2] vote ([{sz.batch}, {n_tab}, {cap}] candidates, min hits "
        f"{opts.min_table_hits}, cap {opts.candidates_per_read_cap}) equals "
        f"cpu/oracle; {int((np.asarray(got[2]) > 0).sum())} reads kept ids")


SHD_MODES = {"parity": (False, False), "3n": (True, False),
             "3n_undirectional": (True, True)}


def check_shd(sz, rng):
    """The packed bit-plane path vs the one-hot scan in every mode; a
    sample vs the pure-Python oracle."""
    import jax.numpy as jnp

    from hashreadmapper_tpu.cpu import oracle
    from hashreadmapper_tpu.ops import bitplanes, shd

    window, lq, p = 128, 160, 4096
    g = rng.integers(0, 4, 1 << 20).astype(np.int8)
    src = rng.integers(0, len(g) - 2 * lq - window, p)
    rl = rng.integers(lq // 2, lq + 1, p).astype(np.int32)
    reads = np.zeros((p, lq), np.int8)
    for i in range(p):
        r = g[src[i]:src[i] + rl[i]].copy()
        if i % 2:
            r = 3 - r[::-1]
        conv = (r == 1) & (rng.random(rl[i]) < 0.9)
        r[conv] = 3
        reads[i, :rl[i]] = r
    pos = np.maximum(src - rng.integers(0, window // 2, p), 0)
    loc = shd.extended_window_location(
        jnp.asarray(pos.astype(np.int32)),
        jnp.full((p,), len(g), jnp.int32), jnp.asarray(rl), window)
    params = shd.ShdParams(window_size=window, max_ext_len=window + lq,
                           max_read_len=lq, max_hamming_percent=0.3)
    gd = jnp.asarray(g)
    g_hi, g_lo = bitplanes.pack_genome_planes(gd)
    valid = jnp.ones((p,), bool)
    for mode, (three_n, und) in SHD_MODES.items():
        want = shd.shd_pairs(gd, loc.start, loc.length, loc.left,
                             jnp.asarray(reads), jnp.asarray(rl), valid,
                             params, three_n=three_n, undirectional=und)
        planes = shd.pack_read_planes(jnp.asarray(reads), jnp.asarray(rl),
                                      three_n, und)
        got = shd.shd_pairs_packed_planes(
            g_hi, g_lo, loc.start, loc.length, loc.left, *planes,
            jnp.asarray(rl), valid, params, three_n=three_n,
            undirectional=und)
        for fld in ("orientation", "hamming", "shift"):
            assert np.array_equal(np.asarray(getattr(got, fld)),
                                  np.asarray(getattr(want, fld))), \
                f"SHD {mode} {fld} differs from the one-hot scan"
        n_map = int((np.asarray(got.orientation) != shd.NONE).sum())
        if mode == "3n":
            got3 = got
        log(f"[2] SHD packed path == one-hot scan, {mode}, {p} planted "
            f"pairs, lq {lq}: {n_map} pass the screen")
    starts, lens, lefts = (np.asarray(loc.start), np.asarray(loc.length),
                           np.asarray(loc.left))
    for i in range(0, p, p // 48):
        w = oracle.shifted_hamming_distance(
            [int(x) for x in g[starts[i]:starts[i] + lens[i]]],
            [int(x) for x in reads[i, :rl[i]]], 0.3, ("ct", "ga"))
        assert int(got3.orientation[i]) == w.orientation, i
        if w.orientation != oracle.NONE:
            assert int(got3.hamming[i]) == w.score, i
            assert int(got3.shift[i]) == w.shift - lefts[i], i
    log("[2] SHD 3N: 48 sampled pairs equal cpu/oracle")


def _step2_pairs(rng, p, lq, lr):
    """3N STEP-2 pairs like the fused path builds them: a CT-collapsed read
    (substitutions, and indels in a third of them) against a CT-collapsed
    window of its source; codes 0..4."""
    q = np.full((p, lq), 4, np.int8)
    f = np.full((p, lr), 4, np.int8)
    rls = np.zeros(p, np.int32)
    fls = np.full(p, lr, np.int32)
    for i in range(p):
        ref = rng.integers(0, 4, lr).astype(np.int8)
        rl = int(rng.integers(60, min(lq, lr) + 1))
        st = int(rng.integers(0, lr - rl + 1))
        seg = list(ref[st:st + rl])
        for _ in range(int(rng.integers(0, 4))):
            seg[int(rng.integers(0, rl))] = int(rng.integers(0, 4))
        if i % 3 == 1:
            d = int(rng.integers(1, 4))
            c = int(rng.integers(5, rl - d))
            seg = seg[:c] + seg[c + d:]
        elif i % 3 == 2:
            c = int(rng.integers(5, rl))
            seg = seg[:c] + list(rng.integers(0, 4, int(
                rng.integers(1, 4)))) + seg[c:]
        if i % 7 == 0:
            seg = list(rng.integers(0, 4, len(seg)))
        read = np.array(seg[:lq], np.int8)
        read[read == 1] = 3
        ref[ref == 1] = 3
        if i % 11 == 0:
            fls[i] = int(rng.integers(lr // 2, lr))
            ref[fls[i]:] = 4
        q[i, :len(read)] = read
        f[i] = ref
        rls[i] = len(read)
    return q, rls, f, fls


def check_step2(sz, rng):
    """The fused score pass + banded traceback (one jit, as in the
    engine) vs the host: scores vs native SSW, CIGARs vs the native
    banded DP."""
    import jax
    import jax.numpy as jnp

    from hashreadmapper_tpu import native
    from hashreadmapper_tpu.ops import bandtb, swdev

    lq, lr, p = 160, 128, 2 * sz.batch
    q, rls, f, fls = _step2_pairs(rng, p, lq, lr)
    ml = np.maximum(15, rls // 2).astype(np.int32)

    @jax.jit
    def fused(q_t, f_t, rl, fl, m):
        s10 = swdev.ssw_score_packed_t(q_t, rl, f_t, fl, m, lr)
        ops, st = bandtb.fused_traceback_t(q_t, f_t, s10)
        return s10, ops, st

    s10, ops, st = (np.asarray(a) for a in fused(
        jnp.asarray(q.T.astype(np.int32)), jnp.asarray(f.T.astype(np.int32)),
        jnp.asarray(rls), jnp.asarray(fls), jnp.asarray(ml)))
    b2c = np.array(list("ACGTN"))
    qs = ["".join(b2c[q[i, :rls[i]]]) for i in range(p)]
    fs = ["".join(b2c[f[i, :fls[i]]]) for i in range(p)]
    host = native.ssw_align_batch(qs, fs, ml, compute_cigar=False)
    ovf = s10[8] != 0
    degen = (s10[0] == 0) | (s10[1] < 0)
    n_cmp = 0
    for i, h in enumerate(host):
        if ovf[i]:
            # byte-mode saturation: the host word path rescores these
            assert h.sw_score + 2 >= 255, i
            continue
        assert s10[0, i] == h.sw_score and s10[3, i] == h.sw_score_next_best
        assert s10[1, i] == h.ref_end and s10[4, i] == h.ref_end_next_best
        assert s10[2, i] == h.query_end, i
        if not degen[i]:
            assert s10[5, i] == h.ref_begin and s10[6, i] == h.query_begin
            assert (2 if s10[7, i] else 0) == h.flag, i
            n_cmp += 1
    log(f"[2] striped-SW score pass: {p} pairs (lq {lq}, window {lr}) equal "
        f"native host SSW ({n_cmp} with begins; {int(ovf.sum())} saturated "
        f"to the host word path)")
    sel = ~ovf & ~degen
    n = int(sel.sum())
    args = (q[sel].tobytes(), np.arange(n, dtype=np.int32) * lq, rls[sel],
            f[sel].tobytes(), np.arange(n, dtype=np.int32) * lr, fls[sel],
            s10[0][sel], s10[5][sel], s10[1][sel], s10[6][sel], s10[2][sel],
            np.zeros(n, np.int32))
    kw = dict(threads=os.cpu_count() or 1, codes=True,
              diag=(s10[9][sel] != 0).astype(np.int8))
    h_cig, h_mm, h_fl = native.ssw_finish_batch(*args, **kw)
    d_cig, d_mm, d_fl = native.ssw_finish_batch(
        *args, **kw, dev_ops=ops[sel].astype(np.int16), dev_fail=st[sel])
    assert h_cig == d_cig, "device traceback CIGARs differ"
    assert np.array_equal(h_mm, d_mm) and np.array_equal(h_fl, d_fl)
    n_indel = sum(1 for c in h_cig if "I" in c or "D" in c)
    need = sel & (s10[9] == 0)
    log(f"[2] banded traceback: {n} CIGARs equal the native host banded DP "
        f"({int(need.sum())} walked on device, {n_indel} with indels, "
        f"{int((st[sel] == 2).sum())} over the entry budget -> host)")


# ---------------------------------------------------------------------------
# phases 3-5
# ---------------------------------------------------------------------------

def write_fasta(path, name, seq_ascii, width=80):
    """seq_ascii: uint8 ACGT codes, written in lines of `width`."""
    n = len(seq_ascii)
    rows = -(-n // width)
    buf = np.full((rows, width + 1), ord("\n"), np.uint8)
    buf[:, :width] = np.pad(seq_ascii, (0, rows * width - n)).reshape(
        rows, width)
    data = buf.reshape(-1)
    if n % width:
        data = np.concatenate([data[:n + rows - 1], [ord("\n")]])
    with open(path, "wb") as fh:
        fh.write(f">{name}\n".encode())
        fh.write(data.astype(np.uint8).tobytes())


def write_fastq_gz(path, reads, read_len):
    letters = np.frombuffer(b"ACGT", np.uint8)[reads[:, :read_len]]
    qual = b"I" * read_len
    with gzip.open(path, "wb", compresslevel=1) as fh:
        for i in range(len(reads)):
            fh.write(b"@r%d\n" % i + letters[i].tobytes() + b"\n+\n" + qual
                     + b"\n")


def make_dataset(d, genome_len, n_reads, read_len, seed):
    """Seeded chromosome + BS reads (bench.make_genome_and_reads) written
    as FASTA and gzipped FASTQ.  Returns (fasta, fastq, planted starts)."""
    import bench

    genome, reads, starts = bench.make_genome_and_reads(
        np.random.default_rng(seed), genome_len, n_reads, read_len, True,
        chrom_name="chr1")
    fa = os.path.join(d, "genome.fa")
    fq = os.path.join(d, "reads.fq.gz")
    write_fasta(fa, "chr1", genome.seqs_ascii[0])
    write_fastq_gz(fq, reads, read_len)
    return fa, fq, starts


def read_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def sam_rows(path):
    """[(qname, flag, rname, pos)] of the SAM body."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            c = line.split("\t", 4)
            out.append((int(c[0]), int(c[1]), c[2], int(c[3])))
    return out


def phase_small(sz, d):
    """Coarse results vs cpu/reference_pipeline, then step2_device on/off
    byte-identical SAM + VCF, both through run_pipeline."""
    from hashreadmapper_tpu.cli import options_from_args
    from hashreadmapper_tpu.cpu import reference_pipeline
    from hashreadmapper_tpu.io.genome import Genome
    from hashreadmapper_tpu.io.readstore import ReadStorage
    from hashreadmapper_tpu.pipeline.driver import run_pipeline

    fa, fq, _ = make_dataset(d, sz.small_genome, sz.small_reads,
                             sz.read_len, seed=3)
    genome = Genome.from_fasta(fa)
    outs = {}
    for dev in (True, False):
        opts = options_from_args([
            "--genomefile", fa, "-i", fq, "-o",
            os.path.join(d, f"small_dev{int(dev)}"), "-k", "16", "-m", "16",
            "--windowSize", "128", "--minTableHits", "4", "--threeN"])
        opts.step2_device = dev
        with contextlib.redirect_stdout(io.StringIO()):
            outs[dev] = run_pipeline(opts, genome=genome)
    res = outs[True]["results"]
    assert res.stats["probe_overflow"] == 0, res.stats
    assert res.stats["vote_overflow"] == 0, res.stats
    reads = ReadStorage.from_files([fq])
    read_lists = [[int(x) for x in reads.bases_matrix()[i, :reads.lengths[i]]]
                  for i in range(reads.num_reads)]
    t0 = time.perf_counter()
    want = reference_pipeline.coarse_map(
        [[int(x) for x in genome.bases[0]]], read_lists, opts)
    for i, w in enumerate(want):
        assert res.orientation[i] == w.orientation, (i, w)
        if w.orientation != 3:
            assert (res.hamming[i], res.shift[i], res.chromosome_id[i],
                    res.position[i]) == (w.hamming_distance, w.shift,
                                         w.chromosome_id, w.position), i
    n_map = sum(1 for w in want if w.orientation != 3)
    log(f"[3] coarse results of {len(want)} 3N reads ({n_map} mapped) on "
        f"{sz.small_genome} bp equal cpu/reference_pipeline "
        f"(oracle {time.perf_counter() - t0:.1f} s)")
    for ext in ("SAM", "VCF"):
        a = read_bytes(outs[True][f"{ext.lower()}_path"])
        b = read_bytes(outs[False][f"{ext.lower()}_path"])
        assert a == b, f"step2_device on/off {ext} differ"
        log(f"[3] step2_device on/off: {ext} byte-identical "
            f"({len(a)} bytes)")


def phase_main(sz, d, card, compiles):
    """The README command through cli.main at chr1 length."""
    from hashreadmapper_tpu import cli
    import jax

    t0 = time.perf_counter()
    fa, fq, starts = make_dataset(d, sz.main_genome, sz.main_reads,
                                  sz.read_len, seed=1)
    log(f"[4] data: {sz.main_genome:,} bp chromosome, {sz.main_reads:,} "
        f"reads ({time.perf_counter() - t0:.1f} s to make and write)")
    out = os.path.join(d, "main")
    argv = ["--genomefile", fa, "-i", fq, "-o", out, "-k", "16", "-m", "16",
            "--windowSize", "128", "--minTableHits", "4", "--threeN"]
    log(f"[4] python -m hashreadmapper_tpu {' '.join(argv[6:])}")
    c0 = compiles.seconds
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    assert rc == 0, text[-3000:]
    stats = ast.literal_eval(re.search(r"stats=(\{.*\})", text).group(1))
    idx_bytes = int(re.search(r"window index: (\d+) bytes", text).group(1))
    for label in ("pair_budget_overflow", "probe_tail_overflow",
                  "probe_head_overflow"):
        assert stats[label] == 0, (label, stats)

    rows = sam_rows(out + ".SAM")
    assert [r[0] for r in rows] == list(range(sz.main_reads)), \
        "SAM must hold one body row per read, in order"
    assert os.path.exists(out + ".VCF")
    mapped = [r for r in rows if not r[1] & 4]
    conc = sum(1 for q, _, rname, pos in mapped
               if rname.split()[0] == "chr1" and abs(pos - starts[q]) <= 128)
    frac, cfrac = len(mapped) / len(rows), conc / max(1, len(mapped))
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    for line in text.splitlines():
        if line.startswith("TIMING:"):
            log(f"[4] {line} ({card})")
    log(f"[4] mapped {len(mapped)}/{len(rows)} = {frac:.4f}; concordant "
        f"{conc}/{len(mapped)} = {cfrac:.4f}; probe_overflow "
        f"{stats['probe_overflow']}, pair/tail/head overflow 0")
    log(f"[4] index {idx_bytes:,} bytes; peak_bytes_in_use {peak}; "
        f"compile {compiles.seconds - c0:.1f} s; wall {wall:.1f} s; "
        f"{sz.main_reads / wall:,.0f} reads/s end to end incl. index build "
        f"and compile ({card})")
    assert frac >= 0.80, f"mapped fraction {frac:.4f} < 0.80"
    assert cfrac >= 0.99, f"concordance {cfrac:.4f} < 0.99"


def phase_four_cards(sz, d, card):
    """Phase 4's data and command on one card, on a 2x2 mesh and in 4
    regions over 4 cards: byte-identical SAMs and equal overflow counters.
    At chr1 length the probe and vote caps bind, so the regions must apply
    them over the whole genome (parallel/region_sharded.py) to agree."""
    import jax

    from hashreadmapper_tpu.cli import options_from_args
    from hashreadmapper_tpu.io.genome import Genome
    from hashreadmapper_tpu.io.readstore import ReadStorage
    from hashreadmapper_tpu.pipeline.driver import run_pipeline

    devs = jax.devices()
    assert len(devs) >= 4, f"--four-cards needs 4 devices, have {len(devs)}"
    fa, fq, _ = make_dataset(d, sz.main_genome, sz.main_reads, sz.read_len,
                             seed=1)
    log(f"[5] data: {sz.main_genome:,} bp chromosome, {sz.main_reads:,} "
        f"reads; the README command")
    genome = Genome.from_fasta(fa)
    reads = ReadStorage.from_files([fq])
    sams, caps = {}, {}
    for label, extra in (("1 card", []), ("2x2 mesh", ["--mesh", "2", "2"]),
                         ("4 regions", ["--regions", "4"])):
        opts = options_from_args([
            "--genomefile", fa, "-i", fq, "-o",
            os.path.join(d, label.replace(" ", "_")), "-k", "16", "-m",
            "16", "--windowSize", "128", "--minTableHits", "4", "--threeN"]
            + extra)
        jax.clear_caches()      # drop the previous run's mapper
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = run_pipeline(opts, reads=reads, genome=genome)
        wall = time.perf_counter() - t0
        stats = out["results"].stats
        for key in ("pair_budget_overflow", "probe_tail_overflow",
                    "probe_head_overflow"):
            assert stats[key] == 0, (label, key, stats)
        caps[label] = (stats["probe_overflow"], stats["vote_overflow"])
        m = out["mapper"]
        if label == "4 regions":
            placed = {next(iter(r.index.keys.devices())) for r in m.mappers}
            assert len(placed) == 4, f"regions on {placed}"
            where = f"regions on {sorted(str(x) for x in placed)}"
        elif label == "2x2 mesh":
            where = f"mesh {dict(m.mesh.shape)} over " \
                    f"{len(m.keys.sharding.device_set)} devices"
        else:
            where = f"on {next(iter(m.index.keys.devices()))}"
        sams[label] = read_bytes(out["sam_path"])
        n_map = int((out["results"].orientation != 3).sum())
        log(f"[5] {label}: {where}; mapped {n_map}/{reads.num_reads}; "
            f"probe_overflow {caps[label][0]}, vote_overflow "
            f"{caps[label][1]}; wall {wall:.1f} s ({card})")
        del out, m
    base = sams["1 card"]
    for label, s in sams.items():
        assert s == base, f"SAM of {label} differs from the one-card SAM"
        assert caps[label] == caps["1 card"], \
            f"overflow counters of {label} differ from one card: {caps}"
    assert caps["1 card"][0] > 0, "the probe cap should bind at chr1 length"
    log(f"[5] the three SAMs are byte-identical ({len(base):,} bytes)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card comparison (phase 5)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "hashreadmapper_tpu")):
        sys.exit("chip_smoke.py must run from a checkout of the repository")

    import bench

    card = bench.card_label()
    sz = Sizes()
    if not args.four_cards:
        phase_device(card)

    from hashreadmapper_tpu.utils.jaxcache import configure_compile_cache
    cache = configure_compile_cache()
    import jax

    compiles = Compiles()
    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke needs a GPU; JAX found {dev.platform}")
    log(f"device: platform {dev.platform}, kind {dev.device_kind}, count "
        f"{len(devs)}; compile cache {cache}")
    log(f"card: {card}")

    with tempfile.TemporaryDirectory(prefix="hrm_smoke_") as d:
        if args.four_cards:
            phase_four_cards(sz, d, card)
        else:
            rng = np.random.default_rng(0)
            t0 = time.perf_counter()
            check_signatures(sz, rng)
            check_probe_and_vote(sz, rng)
            check_shd(sz, rng)
            check_step2(sz, rng)
            log(f"[2] kernels vs reference: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            phase_small(sz, d)
            log(f"[3] small equivalence: {time.perf_counter() - t0:.1f} s")
            phase_main(sz, d, card, compiles)
    log(f"compile: {compiles.seconds:.1f} s over {compiles.count} "
        f"executables ({card})")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
