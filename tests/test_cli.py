"""End-to-end CLI smoke + correctness tests over the mini genome."""

import gzip
import os
import os.path as op

import numpy as np
import pytest

from tests.bisim import dump_bam, simulate_reads
from tests.synth import random_frags
from wgbs_tools_tpu.cli.main import main as cli_main
from wgbs_tools_tpu.formats.beta import load_beta, save_beta
from wgbs_tools_tpu.formats.pat import read_pat, write_pat
from wgbs_tools_tpu.genome.cpg_index import read_fasta


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, mini_genome):
    """A directory with a simulated bam, pat, beta, and blocks file."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(123)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, rng, n_reads=600, paired=True)
    bam = dump_bam(reads, seqs, str(d / "sample.bam"))
    assert cli_main(["bam2pat", bam, "-o", str(d)]) == 0
    assert op.isfile(str(d / "sample.pat.gz"))
    assert op.isfile(str(d / "sample.beta"))

    # a second sample for merging/markers
    reads2, _ = simulate_reads(seqs, rng, n_reads=500, paired=False,
                               meth_rate=0.2)
    bam2 = dump_bam(reads2, seqs, str(d / "other.bam"))
    assert cli_main(["bam2pat", bam2, "-o", str(d)]) == 0

    # blocks over chr1
    idx = mini_genome.index
    s1, e1 = idx.chrom_site_bounds("chr1")
    bounds = np.linspace(s1, min(e1, s1 + 400), 21).astype(int)
    with open(d / "blocks.bed", "w") as f:
        for a, b in zip(bounds[:-1], bounds[1:]):
            if b > a:
                loc_a = idx.loci[a - 1]
                loc_b = idx.loci[b - 2] + 1
                f.write(f"chr1\t{loc_a}\t{loc_b}\t{a}\t{b}\n")
    return d


def test_pat2beta_consistency(workdir, mini_genome):
    """bam2pat's beta equals pat2beta re-run on the pat file."""
    out = cli_main(["pat2beta", str(workdir / "sample.pat.gz"),
                    "-o", str(workdir), "-f"])
    assert out == 0
    beta = load_beta(str(workdir / "sample.beta"))
    assert beta.shape[0] == mini_genome.get_nr_sites()
    assert beta[:, 1].sum() > 0
    assert (beta[:, 0] <= beta[:, 1]).all()


def test_view_beta(workdir, mini_genome, capsys):
    idx = mini_genome.index
    s1, _ = idx.chrom_site_bounds("chr1")
    assert cli_main(["view", str(workdir / "sample.beta"),
                     "-s", f"{s1}-{s1+50}"]) == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l]
    assert len(lines) == 50
    assert lines[0].startswith("chr1\t")


def test_view_pat_region(workdir, mini_genome, capsys):
    idx = mini_genome.index
    s1, e1 = idx.chrom_site_bounds("chr1")
    assert cli_main(["view", str(workdir / "sample.pat.gz"),
                     "-s", f"{s1}-{min(e1, s1 + 300)}"]) == 0
    out = capsys.readouterr().out
    for line in out.splitlines():
        tokens = line.split("\t")
        assert tokens[0] == "chr1"
        assert set(tokens[2]) <= set("CTH.")


def test_convert_roundtrip(workdir, mini_genome, capsys):
    assert cli_main(["convert", "-s", "100-110"]) == 0
    region = capsys.readouterr().out.split(" - ")[0].strip()
    assert cli_main(["convert", "-r", region, "--parsable"]) == 0
    sites = capsys.readouterr().out.strip()
    assert sites == "100-110"


def test_segment_cli(workdir, mini_genome, capsys):
    idx = mini_genome.index
    s1, _ = idx.chrom_site_bounds("chr1")
    out_path = str(workdir / "segments.bed")
    assert cli_main([
        "segment", "--betas", str(workdir / "sample.beta"),
        str(workdir / "other.beta"), "-s", f"{s1}-{s1 + 500}",
        "-o", out_path,
    ]) == 0
    with open(out_path) as f:
        rows = [l.split("\t") for l in f.read().splitlines()]
    assert rows
    assert all(len(r) == 5 for r in rows)
    starts = [int(r[3]) for r in rows]
    ends = [int(r[4]) for r in rows]
    assert starts[0] == s1 and ends[-1] == s1 + 500
    assert all(e > s for s, e in zip(starts, ends))


def test_beta_to_blocks_cli(workdir):
    assert cli_main([
        "beta_to_blocks", str(workdir / "sample.beta"),
        "-b", str(workdir / "blocks.bed"), "-o", str(workdir), "-f",
    ]) == 0
    binfile = str(workdir / "sample.bin")
    data = np.fromfile(binfile, dtype=np.uint8).reshape(-1, 2)
    assert data.shape[0] == 20


def test_homog_cli(workdir):
    assert cli_main([
        "homog", str(workdir / "sample.pat.gz"),
        "-b", str(workdir / "blocks.bed"), "-o", str(workdir), "-f",
    ]) == 0
    out = str(workdir / "sample.uxm.bed.gz")
    rows = gzip.open(out, "rt").read().splitlines()
    assert len(rows) == 20
    assert all(len(r.split("\t")) == 8 for r in rows)


def test_merge_cli(workdir):
    assert cli_main([
        "merge", str(workdir / "sample.pat.gz"), str(workdir / "other.pat.gz"),
        "-p", str(workdir / "merged"), "-f",
    ]) == 0
    merged = read_pat(str(workdir / "merged.pat.gz"))
    a = read_pat(str(workdir / "sample.pat.gz"))
    b = read_pat(str(workdir / "other.pat.gz"))
    assert merged.count.sum() == a.count.sum() + b.count.sum()
    assert (np.diff(merged.start) >= 0).all()

    # beta merge
    assert cli_main([
        "merge", str(workdir / "sample.beta"), str(workdir / "other.beta"),
        "-p", str(workdir / "mergedb"), "-f",
    ]) == 0
    m = load_beta(str(workdir / "mergedb.beta"))
    assert m[:, 1].sum() > 0


def test_beta_stats_cov(workdir, capsys):
    assert cli_main(["beta_cov", str(workdir / "sample.beta")]) == 0
    out = capsys.readouterr().out
    assert out.startswith("sample\t")
    assert cli_main(["beta_stats", str(workdir / "sample.beta")]) == 0
    out = capsys.readouterr().out
    assert "mean_meth" in out


def test_mask_pat_cli(workdir):
    assert cli_main([
        "mask_pat", str(workdir / "sample.pat.gz"),
        "-L", str(workdir / "blocks.bed"),
        "-p", str(workdir / "masked"), "-f",
    ]) == 0
    masked = read_pat(str(workdir / "masked.pat.gz"))
    blocks_sites = set()
    with open(workdir / "blocks.bed") as f:
        for line in f:
            t = line.split("\t")
            blocks_sites.update(range(int(t[3]), int(t[4])))
    # no non-dot call may remain inside masked blocks
    for i in range(masked.nr_frags):
        for j in range(int(masked.length[i])):
            if masked.codes[i, j] != 3:
                assert int(masked.start[i]) + j not in blocks_sites


def test_mix_pat_cli(workdir):
    assert cli_main([
        "mix_pat", str(workdir / "sample.pat.gz"),
        str(workdir / "other.pat.gz"), "--rates", "0.5",
        "-p", str(workdir / "mix"), "-f", "--seed", "5",
    ]) == 0
    mixed = read_pat(str(workdir / "mix_1.pat.gz"))
    assert mixed.nr_frags > 0
    assert mixed.extras is not None  # labels attached


def test_vis_cli(workdir, mini_genome, capsys):
    idx = mini_genome.index
    s1, _ = idx.chrom_site_bounds("chr1")
    assert cli_main(["vis", str(workdir / "sample.pat.gz"),
                     "-s", f"{s1}-{s1+60}", "--text", "--no_color"]) == 0
    out = capsys.readouterr().out
    assert "Methylation average" in out
    assert cli_main(["vis", str(workdir / "sample.beta"),
                     "-s", f"{s1}-{s1+60}", "--no_color"]) == 0
    out = capsys.readouterr().out
    assert "sample" in out


def test_beta_to_table_cli(workdir, capsys):
    with open(workdir / "groups.csv", "w") as f:
        f.write("name,group\nsample,A\nother,B\n")
    assert cli_main([
        "beta_to_table", str(workdir / "blocks.bed"),
        "--betas", str(workdir / "sample.beta"), str(workdir / "other.beta"),
        "-g", str(workdir / "groups.csv"), "-c", "1",
    ]) == 0
    out = capsys.readouterr().out
    header = out.splitlines()[0].split("\t")
    assert header[-2:] == ["A", "B"]


def test_find_markers_cli(workdir, capsys):
    out_dir = str(workdir / "markers")
    assert cli_main([
        "find_markers", "-b", str(workdir / "blocks.bed"),
        "-g", str(workdir / "groups.csv"),
        "--betas", str(workdir / "sample.beta"), str(workdir / "other.beta"),
        "-o", out_dir, "-c", "1", "--delta_means", "0.1",
        "--na_rate_tg", "1", "--na_rate_bg", "1", "--test_type", "t",
        "--pval", "1",
    ]) == 0
    assert op.isfile(op.join(out_dir, "Markers.A.bed"))
    assert op.isfile(op.join(out_dir, "params.txt"))


def test_frag_len_cli(workdir, capsys):
    assert cli_main(["frag_len", str(workdir / "sample.pat.gz")]) == 0
    out = capsys.readouterr().out
    assert out.startswith("# sample")


def test_bad_command(capsys):
    assert cli_main(["segmnt"]) == 1
    err = capsys.readouterr().err
    assert "did you mean" in err


def test_pat_fig_cli(workdir, mini_genome):
    idx = mini_genome.index
    s1, _ = idx.chrom_site_bounds("chr1")
    out = str(workdir / "fig.png")
    assert cli_main(["pat_fig", str(workdir / "sample.pat.gz"),
                     "-s", f"{s1}-{s1+40}", "-o", out]) == 0
    assert op.isfile(out)


def test_pat_fig_cli_flags(workdir, mini_genome):
    """col_wrap tiling of repeated pats, rename table, styling flags."""
    idx = mini_genome.index
    s1, _ = idx.chrom_site_bounds("chr1")
    pat = str(workdir / "sample.pat.gz")
    pat2 = str(workdir / "sample2.pat.gz")
    import shutil

    shutil.copy(pat, pat2)
    names = workdir / "names.csv"
    names.write_text("sample,renamedA\nsample2,renamedB\n")
    out = str(workdir / "fig2.pdf")
    assert cli_main(["pat_fig", pat, pat2, "-s", f"{s1}-{s1+40}", "-o", out,
                     "--col_wrap", "1", "--black_white", "--top", "20",
                     "--name_table", str(names), "--circle_size", "1.2",
                     "--uxm", "0.7", "--title", "demo"]) == 0
    assert op.isfile(out)


def test_set_default_ref_switch(mini_genome, capsys):
    assert cli_main(["set_default_ref", "-ls"]) == 0
    out = capsys.readouterr().out
    assert "mini *" in out
    assert cli_main(["set_default_ref", "mini"]) == 0


def test_pat2pairs_cli(workdir, mini_genome):
    assert cli_main(["pat2pairs", str(workdir / "sample.pat.gz"),
                     "-o", str(workdir), "-f"]) == 0
    import numpy as np

    pairs = np.fromfile(str(workdir / "sample.pairs"),
                        dtype=np.uint32).reshape(-1, 4)
    assert pairs.shape[0] == mini_genome.get_nr_sites()
    assert pairs.sum() > 0


def test_index_bed_cli(workdir, tmp_path):
    """`index` on a plain (unsorted) bed sorts by startCpG, bgzips, and
    writes a functional .tbi (ref Indxer bed branch, index.py:20-29)."""
    import shutil

    from wgbs_tools_tpu.formats.bgzf import decompress_file
    from wgbs_tools_tpu.formats.csi import read_tbi

    rows = open(workdir / "blocks.bed", "rb").read().splitlines(True)
    shuffled = [rows[i] for i in np.random.default_rng(5).permutation(
        len(rows))]
    bed = tmp_path / "shuf.bed"
    bed.write_bytes(b"".join(shuffled))
    assert cli_main(["index", str(bed)]) == 0
    gz = str(bed) + ".gz"
    assert op.isfile(gz) and op.isfile(gz + ".tbi")
    assert not op.isfile(str(bed))  # consumed, like bgzip
    got = decompress_file(gz)
    assert got == b"".join(rows)  # re-sorted by col4
    tbi = read_tbi(gz + ".tbi")
    assert tbi["names"] == ["chr1"]
    # chunk voffs decode rows covering the queried interval
    from wgbs_tools_tpu.formats.bgzf import BgzfReader

    bins, lin = tbi["refs"][0]
    r = BgzfReader(gz)
    some = [c for b, chunks in bins.items() if b != 37450 for c in chunks]
    r.seek_virtual(some[0][0])
    line = r.readline()
    assert line.startswith(b"chr1\t")
    r.close()


def test_segment_gz_output_indexed(workdir, mini_genome, tmp_path):
    from wgbs_tools_tpu.formats.bgzf import decompress_file

    plain = str(tmp_path / "seg.bed")
    gz = str(tmp_path / "seg2.bed.gz")
    args = ["segment", "--betas", str(workdir / "sample.beta"),
            "-r", "chr1", "--mode", "fast"]
    assert cli_main(args + ["-o", plain]) == 0
    assert cli_main(args + ["-o", gz]) == 0
    assert op.isfile(gz) and op.isfile(gz + ".tbi")
    assert decompress_file(gz) == open(plain, "rb").read()


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX uses it and nothing is changed."""
    import jax

    from wgbs_tools_tpu.cli.main import compile_cache_dir, ensure_compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    ensure_compile_cache()
    assert calls == [] and compile_cache_dir() == str(tmp_path / "c")


def test_compile_cache_default_in_checkout(monkeypatch):
    """Unset: the cache is `.jax_cache` at the root of the checkout."""
    import jax

    from wgbs_tools_tpu.cli.main import ensure_compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    ensure_compile_cache()
    root = op.dirname(op.dirname(op.abspath(__file__)))
    assert calls == [("jax_compilation_cache_dir",
                      op.join(root, ".jax_cache"))]
    assert op.isdir(op.join(root, ".jax_cache"))
