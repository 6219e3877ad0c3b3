"""bam2pat conformance: native pipeline vs reference match_maker|patter."""

import gzip
import os
import os.path as op
import stat
import subprocess

import numpy as np
import pytest

from tests.bisim import add_cigar_variants, dump_bam, dump_sam, simulate_reads
from tests.oracle import oracle
from wgbs_tools_tpu.formats.pat import frags_to_bytes, parse_pat_bytes
from wgbs_tools_tpu.genome.cpg_index import read_fasta
from wgbs_tools_tpu.pipeline.bam2pat_run import bam2pat

TABIX_SHIM = r'''#!/usr/bin/env python3
import gzip, re, sys
args = [a for a in sys.argv[1:] if not a.startswith('-')]
path, region = args[0], args[1]
m = re.match(r'^([^:]+)(?::(\d+)-(\d+))?$', region)
chrom, s, e = m.group(1), m.group(2), m.group(3)
s = int(s) if s else None
e = int(e) if e else None
for line in gzip.open(path, 'rt'):
    t = line.rstrip('\n').split('\t')
    if t[0] != chrom:
        continue
    loc = int(t[1])
    if s is not None and (loc < s or loc > e):
        continue
    sys.stdout.write(line)
'''


@pytest.fixture(scope="module")
def shim_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("shim")
    p = d / "tabix"
    p.write_text(TABIX_SHIM)
    p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return str(d)


def ref_bam2pat(reads, seqs, genome, shim_dir, tmp_path):
    """Run reference `match_maker | patter` per chromosome on SAM text."""
    mm = oracle("match_maker")
    pt = oracle("patter")
    dict_path = genome.join("CpG.bed.gz")
    env = dict(os.environ, PATH=shim_dir + ":" + os.environ["PATH"])
    out_rows = []
    for chrom in genome.get_chroms():
        chrom_reads = [r for r in reads if r.chrom == chrom]
        if not chrom_reads:
            continue
        sam = dump_sam(chrom_reads, seqs, str(tmp_path / f"{chrom}.sam"))
        with open(sam, "rb") as f:
            p1 = subprocess.Popen([mm], stdin=f, stdout=subprocess.PIPE)
            p2 = subprocess.Popen(
                [pt, dict_path, chrom],
                stdin=p1.stdout,
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
                env=env,
            )
            p1.stdout.close()
            out, _ = p2.communicate()
        # patter emits chrom\tstart\tpattern (no counts) — add count=1
        for line in out.splitlines():
            if line:
                out_rows.append(line + b"\t1")
    return parse_pat_bytes(b"\n".join(out_rows) + b"\n").sort().collapse()


def _compare(frags, expect):
    got_txt = frags_to_bytes(frags)
    exp_txt = frags_to_bytes(expect)
    assert got_txt == exp_txt


@pytest.mark.parametrize("paired", [False, True])
def test_bam2pat_matches_reference(mini_genome, tmp_path, shim_path, paired):
    rng = np.random.default_rng(7 if paired else 8)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, rng, n_reads=400, paired=paired)
    bam = dump_bam(reads, seqs, str(tmp_path / "sim.bam"))

    frags, _, stats = bam2pat(bam, genome=mini_genome, write_output=False)
    expect = ref_bam2pat(reads, seqs, mini_genome, shim_path, tmp_path)
    assert frags.nr_frags > 0
    _compare(frags, expect)


def test_bam2pat_cigar_variants(mini_genome, tmp_path, shim_path):
    rng = np.random.default_rng(9)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, rng, n_reads=300, paired=False)
    reads = add_cigar_variants(reads, seqs, rng, frac=0.4)
    bam = dump_bam(reads, seqs, str(tmp_path / "simc.bam"))
    frags, _, _ = bam2pat(bam, genome=mini_genome, write_output=False)
    expect = ref_bam2pat(reads, seqs, mini_genome, shim_path, tmp_path)
    _compare(frags, expect)


def test_bam2pat_clip_and_min_cpg(mini_genome, tmp_path, shim_path):
    rng = np.random.default_rng(10)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, rng, n_reads=300, paired=True)
    bam = dump_bam(reads, seqs, str(tmp_path / "simk.bam"))
    frags, _, _ = bam2pat(bam, genome=mini_genome, write_output=False,
                          clip=3, min_cpg=2)

    # oracle with same flags
    mm = oracle("match_maker")
    pt = oracle("patter")
    env = dict(os.environ, PATH=shim_path + ":" + os.environ["PATH"])
    rows = []
    for chrom in mini_genome.get_chroms():
        cr = [r for r in reads if r.chrom == chrom]
        if not cr:
            continue
        sam = dump_sam(cr, seqs, str(tmp_path / f"k{chrom}.sam"))
        with open(sam, "rb") as f:
            p1 = subprocess.Popen([mm], stdin=f, stdout=subprocess.PIPE)
            p2 = subprocess.Popen(
                [pt, mini_genome.join("CpG.bed.gz"), chrom, "--clip", "3",
                 "--min_cpg", "2"],
                stdin=p1.stdout, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, env=env)
            p1.stdout.close()
            out, _ = p2.communicate()
        rows += [l + b"\t1" for l in out.splitlines() if l]
    expect = parse_pat_bytes(b"\n".join(rows) + b"\n").sort().collapse()
    _compare(frags, expect)


def test_bam_roundtrip(mini_genome, tmp_path):
    from wgbs_tools_tpu.pipeline.bam import BamReader

    rng = np.random.default_rng(11)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, rng, n_reads=50, paired=False)
    bam = dump_bam(reads, seqs, str(tmp_path / "rt.bam"))
    reader = BamReader(bam)
    got = list(reader)
    assert len(got) == len(reads)
    by_name = {r.qname: r for r in reads}
    for rec in got:
        orig = by_name[rec.qname]
        assert rec.seq == orig.seq
        assert rec.pos == orig.pos0
        assert rec.flag == orig.flag


def test_device_calling_bit_identical(mini_genome, tmp_path, monkeypatch):
    """The jitted device calling/merge kernels (ops/calling_tpu.py) produce
    byte-identical pat output to the numpy path (forced on the CPU backend;
    integer selects/gathers only, so GPU results match too)."""
    rng = np.random.default_rng(17)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    for paired, n_reads in [(False, 400), (True, 400)]:
        reads, _ = simulate_reads(seqs, rng, n_reads=n_reads, paired=paired)
        reads = add_cigar_variants(reads, seqs, rng) or reads
        bam = dump_bam(reads, seqs,
                       str(tmp_path / f"dev{int(paired)}.bam"))
        monkeypatch.setenv("WGBS_TPU_DEVICE_CALLING", "0")
        f_np, _, _ = bam2pat(bam, genome=mini_genome, write_output=False)
        monkeypatch.setenv("WGBS_TPU_DEVICE_CALLING", "1")
        f_dev, _, _ = bam2pat(bam, genome=mini_genome, write_output=False)
        assert frags_to_bytes(f_dev) == frags_to_bytes(f_np)
        assert f_dev.nr_frags > 100


def test_call_kernel_matches_host_direct(mini_genome):
    """call_reads_device == calling.call_reads_mat on raw matrices,
    including clip, bottom-strand reads, reads with no CpGs, and chunk
    boundaries (chunk=64 forces many launches)."""
    from wgbs_tools_tpu.ops.calling_tpu import call_reads_device
    from wgbs_tools_tpu.pipeline.calling import call_reads_mat

    rng = np.random.default_rng(23)
    idx = mini_genome.index
    loci = idx.chrom_loci("chr1")
    site_base, _ = idx.chrom_site_bounds("chr1")
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads({"chr1": seqs["chr1"]}, rng, n_reads=500,
                              paired=True)
    reads.sort(key=lambda r: r.pos0)
    R = len(reads)
    L = max(len(r.seq) for r in reads)
    chars = np.zeros((R, L), dtype=np.uint8)
    lens = np.zeros(R, dtype=np.int64)
    pos1 = np.zeros(R, dtype=np.int64)
    flags = np.zeros(R, dtype=np.int64)
    for i, r in enumerate(reads):
        chars[i, : len(r.seq)] = np.frombuffer(r.seq, np.uint8)
        lens[i] = len(r.seq)
        pos1[i] = r.pos0 + 1
        flags[i] = r.flag
    for clip in (0, 3):
        s_h, p_h, sp_h = call_reads_mat(pos1, flags, True, loci, site_base,
                                        chars, lens, clip=clip)
        s_d, p_d, sp_d = call_reads_device(pos1, flags, True, loci,
                                           site_base, chars, lens,
                                           clip=clip, chunk=64)
        assert np.array_equal(s_h, s_d)
        assert np.array_equal(sp_h, sp_d)
        W = max(p_h.shape[1], p_d.shape[1])

        def padW(p):
            out = np.full((p.shape[0], W), ord("."), np.uint8)
            out[:, : p.shape[1]] = p
            return out

        assert np.array_equal(padW(p_h), padW(p_d))


def test_device_calling_auto_policy(monkeypatch):
    """The calling policy follows the device helper: a GPU runs the device
    kernels, no GPU keeps the host path; WGBS_TPU_DEVICE_CALLING wins."""
    from wgbs_tools_tpu import device
    from wgbs_tools_tpu.pipeline import bam_columnar as bc

    monkeypatch.delenv("WGBS_TPU_DEVICE_CALLING", raising=False)
    monkeypatch.setattr(device, "platform", lambda: "cpu")
    assert bc.use_device_calling() is False
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    assert bc.use_device_calling() is True
    monkeypatch.setenv("WGBS_TPU_DEVICE_CALLING", "0")
    assert bc.use_device_calling() is False  # env force-off wins
    monkeypatch.setenv("WGBS_TPU_DEVICE_CALLING", "1")
    monkeypatch.setattr(device, "platform", lambda: "cpu")
    assert bc.use_device_calling() is True   # env force-on wins


def test_simulate_bam_pairs_device_and_host_calling(mini_genome, tmp_path,
                                                    monkeypatch):
    """The vectorized paired BAM simulator (used at scale by chip_smoke.py)
    writes a BAM that bam2pat decodes read for read, and device calling
    (forced on this CPU backend) matches host calling byte for byte."""
    from tests.bisim import simulate_bam_pairs

    seqs = read_fasta(mini_genome.join("genome.fa"))
    bam = simulate_bam_pairs(seqs, np.random.default_rng(12), 400,
                             str(tmp_path / "sim.bam"))
    monkeypatch.setenv("WGBS_TPU_DEVICE_CALLING", "0")
    f_host, _, stats = bam2pat(bam, genome=mini_genome, write_output=False)
    assert stats.nr_pairs == 400
    monkeypatch.setenv("WGBS_TPU_DEVICE_CALLING", "1")
    f_dev, _, _ = bam2pat(bam, genome=mini_genome, write_output=False)
    assert f_host.nr_frags > 100
    assert frags_to_bytes(f_dev) == frags_to_bytes(f_host)
