"""Production driver over a (data x table) mesh == single-device, byte-exact.

The reference's multi-GPU layer is its production path (-g 0,1,..,
src/gpu/gpuminhasherconstruction.cu:297-309 selects the multi minhasher
automatically); here the mesh is requested via opts.mesh_data/mesh_table
(--mesh D T) and must produce byte-identical SAM + VCF — including the
undirectional (PBAT) STEP-2 rescoring, which needs bs_strand to survive
the mesh path."""

import gzip

import jax
import numpy as np
import pytest

from hashreadmapper_tpu.config import ProgramOptions
from hashreadmapper_tpu.pipeline.driver import run_pipeline


def make_bs_dataset(tmp_path, n_reads=160, chrom_len=24000, read_len=60,
                    seed=7, pbat_half=False):
    """BS-converted reads: C->T in read space (directional strands); with
    pbat_half, every other read is G->A-converted (the PBAT strands)."""
    rng = np.random.default_rng(seed)
    b2c = np.array(list("ACGT"))
    chrom_bases = rng.integers(0, 4, chrom_len, dtype=np.int8)
    chrom = "".join(b2c[chrom_bases])
    fa = tmp_path / "g.fa"
    fa.write_text(">chrM test\n" + "\n".join(
        chrom[i:i + 70] for i in range(0, chrom_len, 70)) + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    fq = tmp_path / "r.fq.gz"
    with gzip.open(fq, "wt") as f:
        for i in range(n_reads):
            s = rng.integers(0, chrom_len - read_len)
            r = list(chrom[s:s + read_len])
            if rng.random() < 0.5:
                r = list("".join(r).translate(comp)[::-1])
            src, dst = (("G", "A") if (pbat_half and i % 2) else ("C", "T"))
            for j, ch in enumerate(r):
                if ch == src and rng.random() < 0.9:
                    r[j] = dst
            f.write(f"@r{i}\n{''.join(r)}\n+\n{'I' * read_len}\n")
    return str(fa), str(fq)


def run_once(tmp_path, fa, fq, label, mesh, undirectional, chunk=0):
    opts = ProgramOptions(
        inputfiles=[fq], genomefile=fa,
        outputfile=str(tmp_path / f"out_{label}"),
        kmer_length=12, num_hash_functions=8, window_size=64,
        min_table_hits=2, batchsize=16, max_hamming_percent=0.2,
        probe_cap=16, candidates_per_read_cap=8, max_read_length=64,
        three_n_seeding=True, undirectional=undirectional,
        shd_pairs_per_read_budget=4, probe_tail_budget_per_read=4,
        step2_pipeline_chunk=chunk,
        mesh_data=mesh[0] if mesh else None,
        mesh_table=mesh[1] if mesh else None)
    run_pipeline(opts)
    return (open(opts.outputfile + ".SAM").read(),
            open(opts.outputfile + ".VCF").read())


@pytest.mark.parametrize("mesh", [(4, 2), (2, 4), (1, 8)])
def test_mesh_cli_e2e_matches_single(tmp_path, mesh):
    if len(jax.devices()) < mesh[0] * mesh[1]:
        pytest.skip("needs 8 devices")
    fa, fq = make_bs_dataset(tmp_path)
    want = run_once(tmp_path, fa, fq, "single", None, False)
    got = run_once(tmp_path, fa, fq, f"mesh{mesh[0]}x{mesh[1]}", mesh, False)
    assert got[0] == want[0], "SAM differs"
    assert got[1] == want[1], "VCF differs"


def test_mesh_cli_e2e_undirectional_matches_single(tmp_path):
    """PBAT reads through the mesh: bs_strand must reach STEP 2's mirrored
    rescoring (a past gap: the mesh dropped bs_strand)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    fa, fq = make_bs_dataset(tmp_path, pbat_half=True, seed=11)
    want = run_once(tmp_path, fa, fq, "u_single", None, True)
    got = run_once(tmp_path, fa, fq, "u_mesh", (4, 2), True)
    assert got[0] == want[0], "SAM differs"
    assert got[1] == want[1], "VCF differs"
    # the PBAT strand actually exercised the mirrored rescoring: mapped
    # rows must carry both strand tags
    assert "YZ:A:<+>" in want[0]
    # and the dataset maps a healthy fraction (PBAT half included)
    n_mapped = sum(1 for ln in want[0].splitlines()
                   if not ln.startswith("@") and "\t4\t" not in
                   "\t".join(ln.split("\t")[1:2]))
    assert n_mapped > 100


def test_mesh_pipelined_matches_sequential(tmp_path):
    """Chunked STEP1/STEP2 pipelining over the mesh == sequential mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    fa, fq = make_bs_dataset(tmp_path, seed=13)
    want = run_once(tmp_path, fa, fq, "m_seq", (4, 2), False, chunk=0)
    got = run_once(tmp_path, fa, fq, "m_pipe", (4, 2), False, chunk=64)
    assert got[0] == want[0], "SAM differs"
    assert got[1] == want[1], "VCF differs"
