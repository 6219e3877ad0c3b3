"""Real-data conformance on the reference project's tutorial BAMs.

The tutorial BAMs (/root/reference/tutorial/bams/*.bam) are real Roadmap
Epigenomics WGBS reads aligned to hg19 with bwa-meth. hg19 itself is not
available here (zero egress), but every record carries an MD:Z tag, so the
reference sequence over the covered windows is reconstructed bit-for-bit
with bisulfite-aware strand resolution (pipeline/md_ref.py). Validation of
the reconstruction against the published hg19 facts in tutorial/README.md:

  - chr3:119527929-119531943 contains exactly 100 CpGs, global indices
    5394767-5394867 (README.md:63)
  - every block boundary of the golden segmentation maps locus <-> global
    CpG index exactly (README.md:251-272, 296-307)
  - the first 10 CpG loci match the golden `view --genome hg19 beta` rows
    (README.md:123-133)

Two reference directories are built: `tut3loc` (window-local indices, used
to byte-compare our bam2pat against the reference match_maker|patter
binaries on identical coordinates) and `tut3glob` (true hg19 global indices
via a synthetic prefix of 5,394,763 placeholder CpGs, used to compare
against the README's literal golden outputs).

Note on golden drift (cause VERIFIED experimentally, round 3): the README
outputs were generated by an earlier wgbstools build that predates the
`is_cpg(seq, j, ro)` sequence check in patter::compareSeqToRef
(ref: patter.cpp:149-151). Recompiling the reference patter with that one
check disabled reproduces the README's `view` golden rows EXACTLY
(C 9 / CC 7 / T 1 at 5394768 and all others through 5394775); qual-masking
variants (phred thresholds 10-25), the earlier hypothesis here, do NOT —
they over-produce '.'s in unrelated reads. The current source is stricter:
positions whose read sequence doesn't look like a CpG become '.', which
strips/drops a few read-level calls (~1 read per few hundred), nudging a
handful of beta cells by +-1, two segment borders by one site, and homog
counts by a few reads. (The README's missing rows past 5394775 are a
view-side region-windowing difference in that old build, not a calling
difference — the no-is_cpg variant still emits them.) Our pipeline is
byte-identical to the binaries compiled from /root/reference (the
authoritative target — proven in
test_real_bam2pat_matches_reference_binaries), so the README comparisons
below assert exact equality on everything structural (loci, CpG indices,
block boundaries) and bounded drift on read-level aggregates.
"""

import os
import os.path as op
import shutil
import subprocess

import numpy as np
import pytest

from tests.oracle import oracle
from tests.test_bam2pat import shim_path  # noqa: F401
from wgbs_tools_tpu.formats.pat import frags_to_bytes, parse_pat_bytes
from wgbs_tools_tpu.genome.cpg_index import CpGIndex
from wgbs_tools_tpu.genome.init_genome import write_reference_compat_files
from wgbs_tools_tpu.pipeline.bam import read_bam
from wgbs_tools_tpu.pipeline.bam2pat_run import bam2pat
from wgbs_tools_tpu.pipeline.md_ref import reconstruct_consensus

BAM_DIR = "/root/reference/tutorial/bams"
SMALL_BAMS = ["Lung_STL002.small.bam", "Pancreas_STL002.small.bam",
              "Sigmoid_Colon_STL003.small.bam"]
IGF2_BAM = "Left_Ventricle_STL001.IGF2.bam"

pytestmark = pytest.mark.skipif(
    not op.isdir(BAM_DIR), reason="reference tutorial BAMs not present")


def _cpg_loci(start0, seq):
    pos0 = np.nonzero((seq[:-1] == ord("C")) & (seq[1:] == ord("G")))[0]
    return pos0 + start0 + 1  # 1-based loci


def _make_refdir(root, name, chrom, loci, prefix_sites=0, chrom_size=None):
    d = op.join(root, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    loci = np.asarray(loci, dtype=np.int64)
    if prefix_sites:
        pre = np.arange(1, prefix_sites + 1, dtype=np.int64) * 2
        assert pre[-1] < loci[0]
        loci = np.concatenate([pre, loci])
    idx = CpGIndex(loci, np.array([0, len(loci)], np.int64), [chrom],
                   np.array([chrom_size or int(loci[-1]) + 1000], np.int64),
                   name=name)
    idx.save(d)
    write_reference_compat_files(idx, d)
    return d


@pytest.fixture(scope="module")
def tut(tmp_path_factory):
    """Reconstructed windows + refdirs + per-sample pat frags."""
    root = tmp_path_factory.mktemp("tut")
    refs = str(root / "references")
    os.makedirs(refs)
    prev = os.environ.get("WGBS_TPU_REFDIR")
    os.environ["WGBS_TPU_REFDIR"] = refs

    recs3 = []
    for bam in SMALL_BAMS:
        _, recs = read_bam(op.join(BAM_DIR, bam))
        recs3 += recs
    lo3, seq3, dis3 = reconstruct_consensus(recs3)
    assert dis3 < 0.001, "MD consensus should be near-unanimous"
    loci3 = _cpg_loci(lo3, seq3)

    # hg19 facts from the README (see module docstring)
    in_win = loci3[(loci3 >= 119527929) & (loci3 < 119531943)]
    assert len(in_win) == 100 and in_win[0] == 119527929
    assert (loci3 < 119527929).sum() == 3  # view golden starts at 5394764

    _make_refdir(refs, "tut3loc", "chr3", loci3)
    # first reconstructed CpG has global index 5394767 - 3 = 5394764
    _make_refdir(refs, "tut3glob", "chr3", loci3, prefix_sites=5394763)

    _, recs11 = read_bam(op.join(BAM_DIR, IGF2_BAM))
    lo11, seq11, dis11 = reconstruct_consensus(recs11)
    assert dis11 < 0.001
    loci11 = _cpg_loci(lo11, seq11)
    _make_refdir(refs, "tut11loc", "chr11", loci11)

    from wgbs_tools_tpu.genome.refdir import Genome

    yield {
        "refs": refs,
        "loc3": Genome("tut3loc"),
        "glob3": Genome("tut3glob"),
        "loc11": Genome("tut11loc"),
        "seq3": (lo3, seq3),
        "seq11": (lo11, seq11),
        "root": str(root),
    }
    if prev is not None:
        os.environ["WGBS_TPU_REFDIR"] = prev


def _sam_lines(reader, recs):
    out = []
    for r in recs:
        cig = "".join(f"{ln}{o}" for o, ln in r.cigar) or "*"
        qual = bytes(q + 33 for q in r.qual).decode("latin1") \
            if len(r.qual) else "*"
        out.append("\t".join([
            r.qname, str(r.flag), reader.ref_names[r.ref_id], str(r.pos + 1),
            str(r.mapq), cig, "*", "0", "0", r.seq.decode(), qual]))
    return ("\n".join(out) + "\n").encode()


def _ref_pipeline(bam_path, genome, chrom, shim_dir):
    """reference `match_maker | patter` on the BAM's reads (same filters as
    bam2pat: -q 10 -F 1796 — ref: bam2pat.py:26-27,154)."""
    reader, recs = read_bam(bam_path)
    recs = [r for r in recs if r.mapq >= 10 and not (r.flag & 1796)]
    env = dict(os.environ, PATH=shim_dir + ":" + os.environ["PATH"])
    p1 = subprocess.Popen([oracle("match_maker")], stdin=subprocess.PIPE,
                          stdout=subprocess.PIPE)
    p2 = subprocess.Popen([oracle("patter"), genome.join("CpG.bed.gz"), chrom],
                          stdin=p1.stdout, stdout=subprocess.PIPE,
                          stderr=subprocess.DEVNULL, env=env)
    p1.stdin.write(_sam_lines(reader, recs))
    p1.stdin.close()
    out, _ = p2.communicate()
    rows = [l + b"\t1" for l in out.splitlines() if l]
    return parse_pat_bytes(b"\n".join(rows) + b"\n").sort().collapse()


@pytest.mark.parametrize("bam", SMALL_BAMS + [IGF2_BAM])
def test_real_bam2pat_matches_reference_binaries(tut, shim_path, bam):
    """Our bam2pat is byte-identical to match_maker|patter on real reads."""
    chrom = "chr11" if bam == IGF2_BAM else "chr3"
    g = tut["loc11"] if bam == IGF2_BAM else tut["loc3"]
    path = op.join(BAM_DIR, bam)
    frags, _, stats = bam2pat(path, genome=g, write_output=False)
    expect = _ref_pipeline(path, g, chrom, shim_path)
    assert frags_to_bytes(frags) == frags_to_bytes(expect)
    assert frags.nr_frags > 100


def test_real_view_golden(tut):
    """`view -r chr3:119527929-119528309` of Pancreas vs the README golden
    (README.md:103-121). The expected rows below are the current reference
    source's output (byte-verified against the compiled binaries); README
    drift: the old build emitted `C 9 / CC 7 / T 1` at 5394768 (ours
    `C 10 / CC 6`, no `T`) and none of the rows past 5394775."""
    g = tut["glob3"]
    frags, _, _ = bam2pat(op.join(BAM_DIR, "Pancreas_STL002.small.bam"),
                          genome=g, write_output=False)
    s, e = g.index.region2sites("chr3", 119527929, 119528309)
    assert (s, e) == (5394767, 5394781)
    sel = frags.slice_sites(s, e, min_overlap=1)
    got = frags_to_bytes(sel).decode().splitlines()
    expected = [
        "chr3\t5394764\tCCCC\t4",
        "chr3\t5394765\tCCC\t2",
        "chr3\t5394766\tCC\t7",
        "chr3\t5394766\tTC\t1",
        "chr3\t5394767\tC\t3",
        "chr3\t5394768\tC\t10",
        "chr3\t5394768\tCC\t6",
        "chr3\t5394768\tCCC\t3",
        "chr3\t5394768\tCT\t2",
        "chr3\t5394768\tTC\t1",
        "chr3\t5394769\tCCC\t1",
        "chr3\t5394770\tCCCCC\t1",
        "chr3\t5394770\tCCCTCC\t1",
        "chr3\t5394770\tCCCTCCCC\t1",
        "chr3\t5394770\tCTTTCCCT\t1",
        "chr3\t5394774\tCCCTCTT\t1",
        "chr3\t5394775\tCCTCCC\t1",
        "chr3\t5394778\tCCC\t3",
        "chr3\t5394778\tCCT\t1",
        "chr3\t5394778\tTCC\t1",
        "chr3\t5394778\tTCCC\t1",
        "chr3\t5394779\tC.C\t1",
        "chr3\t5394779\tTTC.T\t1",
        "chr3\t5394780\tCCCC\t1",
    ]
    assert got == expected


def test_real_beta_values_golden(tut):
    """Pancreas beta counts at the first 10 window CpGs vs the README's
    `view beta` golden rows (README.md:123-133). One coverage cell drifts by
    1 read between the README build and the current reference source (site
    5394769); assert within that documented drift."""
    from wgbs_tools_tpu.ops.pileup import pileup_frags

    g = tut["glob3"]
    frags, _, _ = bam2pat(op.join(BAM_DIR, "Pancreas_STL002.small.bam"),
                          genome=g, write_output=False)
    counts = pileup_frags(frags, (5394767, 5394777))
    golden = np.array([
        [17, 17], [21, 23], [12, 14], [8, 8], [4, 5],
        [3, 4], [1, 4], [5, 5], [5, 5], [4, 4],
    ])
    diff = np.abs(np.asarray(counts, dtype=np.int64) - golden)
    assert diff.sum() <= 3 and (diff <= 1).all()
    # loci of those rows must match the golden bed starts exactly
    loci0 = g.index.loci[5394767 - 1 : 5394777 - 1] - 1
    assert loci0.tolist() == [
        119527928, 119528087, 119528116, 119528180, 119528185,
        119528201, 119528207, 119528216, 119528224, 119528241,
    ]


@pytest.fixture(scope="module")
def tut_betas(tut, tmp_path_factory):
    """pat + beta for the three small samples on the global-index refdir."""
    from wgbs_tools_tpu.formats.beta import trim_to_uint
    from wgbs_tools_tpu.ops.pileup import pileup_frags

    d = str(tmp_path_factory.mktemp("tutbetas"))
    g = tut["glob3"]
    out = {}
    for bam in SMALL_BAMS:
        name = bam[: -len(".small.bam")] + ".small"
        frags, _, _ = bam2pat(op.join(BAM_DIR, bam), genome=g,
                              write_output=False)
        counts = pileup_frags(frags, (1, g.index.nr_sites + 1))
        beta = op.join(d, name + ".beta")
        trim_to_uint(np.asarray(counts)).tofile(beta)
        out[name] = {"frags": frags, "beta": beta}
    return out


GOLDEN_BLOCKS = [
    # (start, end, startCpG, endCpG) — README.md:253-263
    (119527929, 119528187, 5394767, 5394772),
    (119528217, 119528243, 5394774, 5394777),
    (119528246, 119528388, 5394777, 5394784),
    (119528405, 119528431, 5394784, 5394787),
    (119528639, 119528783, 5394789, 5394796),
    (119528806, 119529245, 5394796, 5394834),
    (119529584, 119530116, 5394837, 5394844),
    (119530396, 119530598, 5394846, 5394856),
    (119531385, 119531943, 5394858, 5394867),
]


def test_real_segment_golden(tut, tut_betas):
    """segment --min_cpg 3 --max_bp 2000 on the real betas reproduces the 9
    golden tutorial blocks (README.md:245-263) exactly — loci AND global
    CpG indices."""
    from wgbs_tools_tpu.models.segment import SegmentConfig, segment_ranges

    g = tut["glob3"]
    betas = [tut_betas[n]["beta"] for n in sorted(tut_betas)]
    s, e = g.index.region2sites("chr3", 119527929, 119531943)
    assert (s, e) == (5394767, 5394867)
    cfg = SegmentConfig(max_cpg=1000, max_bp=2000, pseudo_count=15.0,
                        min_cpg=3, mode="exact")
    starts, ends = segment_ranges(betas, [(s, e)], g.index, cfg)
    got = [(int(g.index.loci[st - 1]), int(st), int(en))
           for st, en in zip(starts, ends)]
    golden = [(b[0], b[2], b[3]) for b in GOLDEN_BLOCKS]
    assert len(got) == 9
    # the input betas differ from the README build by a handful of drifted
    # reads (module docstring), which moves the block-5/6 junction by one
    # site; everything else must match the golden exactly
    exact = [g_ == e_ for g_, e_ in zip(got, golden)]
    assert sum(exact) >= 7, (got, golden)
    for (gl, gs, ge), (el, es, ee), ok in zip(got, golden, exact):
        if not ok:
            assert abs(gs - es) <= 1 and abs(ge - ee) <= 1, (got, golden)


def test_real_beta_to_table_golden(tut, tut_betas):
    """beta_to_table over the golden blocks reproduces the README matrix
    (README.md:276-293, 2-decimal rounding)."""
    from wgbs_tools_tpu.ops.reduceat import reduce_data_to_blocks
    from wgbs_tools_tpu.formats.beta import load_beta

    table_blocks = [
        (5394767, 5394772), (5394774, 5394777), (5394777, 5394781),
        (5394782, 5394786), (5394786, 5394796), (5394796, 5394834),
        (5394837, 5394844), (5394846, 5394856), (5394858, 5394867),
    ]
    golden = {
        "Lung_STL002.small": [0.87, 0.74, 0.43, 0.21, 0.08, 0.00, 0.96,
                              0.94, 0.87],
        "Pancreas_STL002.small": [0.92, 1.00, 0.73, 0.45, 0.28, 0.00, 0.97,
                                  0.91, 0.87],
        "Sigmoid_Colon_STL003.small": [0.96, 0.92, 0.80, 0.92, 0.76, 0.76,
                                       0.96, 0.95, 0.96],
    }
    starts = np.array([b[0] for b in table_blocks])
    ends = np.array([b[1] for b in table_blocks])
    for name, exp in golden.items():
        data = load_beta(tut_betas[name]["beta"])
        red = reduce_data_to_blocks(data, starts, ends)
        vals = np.round(red[:, 0] / np.maximum(red[:, 1], 1), 2)
        diff = np.abs(vals - np.array(exp))
        # a few drifted reads can move a ratio by several 0.01 in the
        # low-coverage blocks (module docstring)
        assert (diff <= 0.06).all(), (name, vals.tolist(), exp)


def test_real_homog_golden(tut, tut_betas):
    """homog U/X/M counts for Lung over the golden blocks vs README.md
    (README.md:311-327, thresholds 0.25,0.75)."""
    from wgbs_tools_tpu.ops.frag_ops import homog_counts

    frags = tut_betas["Lung_STL002.small"]["frags"]
    starts = np.array([b[2] for b in GOLDEN_BLOCKS], dtype=np.int64)
    ends = np.array([b[3] for b in GOLDEN_BLOCKS], dtype=np.int64)
    counts = homog_counts(frags, starts, ends, [0, 0.25, 0.75, 1],
                          min_cpgs=3)
    golden = np.array([
        [0, 4, 6], [3, 9, 16], [10, 23, 11], [9, 5, 0], [27, 2, 1],
        [190, 3, 0], [0, 2, 80], [0, 16, 143], [2, 24, 75],
    ])
    diff = np.abs(np.asarray(counts, dtype=np.int64) - golden)
    # read-level drift (module docstring): a few reads per block at most
    assert (diff <= 6).all() and diff.sum() <= 15, \
        (np.asarray(counts).tolist(), golden.tolist())


def test_real_bimodal_golden(tut):
    """test_bimodal on the real IGF2 pat matches the README's printed
    statistics: 281 reads, log-likelihoods -1401.2486 / -457.8261, p ~ 0
    (README.md:436-441)."""
    from wgbs_tools_tpu.models.bimodal import test_bimodal_region

    g = tut["loc11"]
    frags, _, _ = bam2pat(op.join(BAM_DIR, IGF2_BAM), genome=g,
                          write_output=False)
    s, e = g.index.region2sites("chr11", 2019196, 2019796)
    res = test_bimodal_region(frags, s, e)
    # README: 281 reads; the current reference source calls 288 (drift).
    # The two-allele structure must be unmistakable: near-binary thetas and
    # a vanishing p-value (exact EM parity vs the reference Python is pinned
    # separately in tests/test_bimodal_oracle.py).
    assert 270 <= res["nr_reads"] <= 300
    assert res["theta1"] > 0.85 and res["theta2"] < 0.15
    assert res["pval"] < 1e-12


def test_real_split_by_allele(tut, tmp_path):
    """split_by_allele at the known C/A het chr11:2019496 shows the
    documented ASM: A-allele reads methylated, C-allele unmethylated
    (README.md:444-470)."""
    from wgbs_tools_tpu.pipeline.bam_split import split_bam_by_allele

    g = tut["loc11"]
    out1, out2 = split_bam_by_allele(
        op.join(BAM_DIR, IGF2_BAM), "chr11", 2019496, "C", "A",
        out_dir=str(tmp_path), genome=g)
    meth = {}
    for allele, bam_path in (("C", out1), ("A", out2)):
        frags, _, _ = bam2pat(bam_path, genome=g, write_output=False)
        s, e = g.index.region2sites("chr11", 2019196, 2019796)
        sel = frags.slice_sites(s, e, min_overlap=1)
        pb = sel.pattern_bytes()
        cnt = sel.count.tolist()
        nC = sum(row.count(ord("C")) * c for row, c in zip(pb.tolist(), cnt))
        nT = sum(row.count(ord("T")) * c for row, c in zip(pb.tolist(), cnt))
        meth[allele] = nC / max(nC + nT, 1)
        assert sum(cnt) >= 15  # reads crossing the SNP inside the region
    assert meth["A"] > 0.8 and meth["C"] < 0.2, meth
