"""Multi-process (emulated multi-host) execution: N OS processes join one
jax.distributed job, shard the pat input by site range, and assemble a beta
byte-identical to the single-process path (parallel/multihost.py)."""

import os
import os.path as op
import subprocess
import sys

import numpy as np
import pytest

from tests.synth import random_frags
from wgbs_tools_tpu.formats.pat import write_pat

REPO = op.dirname(op.dirname(op.abspath(__file__)))


@pytest.mark.parametrize("nproc,ldev", [(2, 2)])
def test_multiprocess_pat2beta_matches_single(tmp_path, nproc, ldev):
    n_sites = 4096
    frags = random_frags(np.random.default_rng(7), 4000, n_sites - 20,
                         max_len=14).sort().collapse()
    pat = str(tmp_path / "mh.pat.gz")
    write_pat(frags, pat)

    # single-process truth (host accumulator; integer adds -> exact)
    from wgbs_tools_tpu.pipeline.pat2beta import pat2beta

    class _G:
        nr_sites = n_sites

        def get_nr_sites(self):
            return n_sites

    single = pat2beta(pat, out_dir=str(tmp_path), genome=_G(),
                      sharded=False, out_path=str(tmp_path / "single.beta"))

    # the launcher spawns fresh python processes: they must not inherit this
    # test process's initialized-JAX state, only its env
    from wgbs_tools_tpu.parallel.multihost import run_pat2beta_multiprocess

    out = run_pat2beta_multiprocess(
        pat, str(tmp_path / "multi.beta"), n_sites,
        num_processes=nproc, local_devices=ldev, timeout=300)
    assert open(out, "rb").read() == open(single, "rb").read(), \
        "multi-process beta != single-process beta"


def test_multiprocess_worker_cli_badargs():
    r = subprocess.run(
        [sys.executable, "-m", "wgbs_tools_tpu.parallel.multihost"],
        capture_output=True, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 2  # argparse usage error


def test_pat2beta_cli_procs(tmp_path, mini_genome):
    """`pat2beta --procs 2` routes through the multi-process launcher and
    produces the same beta as the single-process CLI."""
    from tests.synth import random_frags
    from wgbs_tools_tpu.cli.main import main as cli_main

    n_sites = mini_genome.get_nr_sites()
    frags = random_frags(np.random.default_rng(9), 1500, n_sites - 20,
                         max_len=12).sort().collapse()
    pat = str(tmp_path / "c.pat.gz")
    write_pat(frags, pat)
    assert cli_main(["pat2beta", pat, "-o", str(tmp_path)]) == 0
    single = open(tmp_path / "c.beta", "rb").read()
    assert cli_main(["pat2beta", pat, "-o", str(tmp_path), "-f",
                     "--procs", "2"]) == 0
    assert open(tmp_path / "c.beta", "rb").read() == single


def test_multiprocess_empty_process_range(tmp_path):
    """All fragments in process 0's site range: process 1 contributes only
    empty collective rounds, and the assembled beta is still exact."""
    from tests.synth import random_frags
    from wgbs_tools_tpu.parallel.multihost import run_pat2beta_multiprocess
    from wgbs_tools_tpu.pipeline.pat2beta import pat2beta

    n_sites = 4096
    # all starts in the first quarter of the site axis (process 0's rows)
    frags = random_frags(np.random.default_rng(11), 800, n_sites // 4 - 20,
                         max_len=10).sort().collapse()
    pat = str(tmp_path / "e.pat.gz")
    write_pat(frags, pat)

    class _G:
        nr_sites = n_sites

        def get_nr_sites(self):
            return n_sites

    single = pat2beta(pat, out_dir=str(tmp_path), genome=_G(),
                      sharded=False, out_path=str(tmp_path / "s.beta"))
    out = run_pat2beta_multiprocess(pat, str(tmp_path / "m.beta"), n_sites,
                                    num_processes=2, local_devices=2,
                                    timeout=300)
    assert open(out, "rb").read() == open(single, "rb").read()


def test_multiprocess_segment_matches_single(tmp_path, mini_genome):
    """2-process segment (chunk axis round-robined over jax.distributed
    workers, parts stitched on p0) == single-process segment_ranges."""
    from wgbs_tools_tpu.formats.beta import save_beta
    from wgbs_tools_tpu.models.segment import SegmentConfig, segment_ranges
    from wgbs_tools_tpu.parallel.multihost import run_segment_multiprocess

    nr = mini_genome.get_nr_sites()
    rng = np.random.default_rng(5)
    paths = []
    for i in range(2):
        cov = rng.integers(0, 20, size=nr).astype(np.int64)
        meth = rng.binomial(cov, 0.2 + 0.6 * ((np.arange(nr) // 400) % 2))
        p = str(tmp_path / f"m{i}.beta")
        save_beta(p, np.stack([meth, cov], axis=1))
        paths.append(p)
    ranges = [(1, nr + 1)]
    kw = dict(max_cpg=100, max_bp=100000, pseudo_count=15.0,
              chunk_size=1500, mode="exact")
    cfg = SegmentConfig(**kw)
    st, en = segment_ranges(paths, ranges, mini_genome.index, cfg)
    st2, en2 = run_segment_multiprocess(
        paths, ranges, str(tmp_path / "seg"), num_processes=2,
        local_devices=2, timeout=300, **kw)
    assert st2.tolist() == st.tolist()
    assert en2.tolist() == en.tolist()


def test_segment_cli_procs(tmp_path, mini_genome, capsys):
    """`segment --procs 2` produces the same blocks file as single-process."""
    from wgbs_tools_tpu.cli.main import main as cli_main
    from wgbs_tools_tpu.formats.beta import save_beta

    nr = mini_genome.get_nr_sites()
    rng = np.random.default_rng(6)
    cov = rng.integers(1, 15, size=nr).astype(np.int64)
    meth = rng.binomial(cov, 0.15 + 0.7 * ((np.arange(nr) // 300) % 2))
    b = str(tmp_path / "c.beta")
    save_beta(b, np.stack([meth, cov], axis=1))
    o1 = str(tmp_path / "b1.bed")
    o2 = str(tmp_path / "b2.bed")
    assert cli_main(["segment", "--betas", b, "-c", "2000", "-o", o1]) == 0
    assert cli_main(["segment", "--betas", b, "-c", "2000", "-o", o2,
                     "--procs", "2"]) == 0
    assert open(o1).read() == open(o2).read()


def test_bam2pat_procs_matches_single(tmp_path, mini_genome):
    """bam2pat --procs 2: contiguous chromosome parts, BGZF-concatenated —
    decompressed pat content identical to the single-process output, and
    the rebuilt index serves region reads."""
    from tests.bisim import dump_bam, simulate_reads
    from wgbs_tools_tpu.genome.cpg_index import read_fasta
    from wgbs_tools_tpu.parallel.multihost import run_bam2pat_multiprocess
    from wgbs_tools_tpu.pipeline.bam2pat_run import bam2pat

    rng = np.random.default_rng(21)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, rng, n_reads=500, paired=True)
    bam = dump_bam(reads, seqs, str(tmp_path / "mp.bam"))

    d1 = tmp_path / "single"
    d1.mkdir()
    _, single_pat, _ = bam2pat(bam, genome=mini_genome, out_dir=str(d1))
    d2 = tmp_path / "multi"
    d2.mkdir()
    multi_pat = run_bam2pat_multiprocess(bam, out_dir=str(d2),
                                         num_processes=2, timeout=600)

    import gzip

    with gzip.open(single_pat) as f:
        want = f.read()
    with gzip.open(multi_pat) as f:
        got = f.read()
    assert got == want, "multi-process pat content != single-process"

    # region read through the rebuilt index
    from wgbs_tools_tpu.formats.pat import read_pat

    fr = read_pat(multi_pat, region_sites=(5, 500))
    fr2 = read_pat(single_pat, region_sites=(5, 500))
    assert fr.nr_frags == fr2.nr_frags


def test_bam2pat_cli_procs(tmp_path, mini_genome):
    """`bam2pat --procs 2` end-to-end through the CLI, beta equal too."""
    from tests.bisim import dump_bam, simulate_reads
    from wgbs_tools_tpu.cli.main import main as cli_main
    from wgbs_tools_tpu.genome.cpg_index import read_fasta

    rng = np.random.default_rng(22)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, rng, n_reads=300, paired=False)
    bam = dump_bam(reads, seqs, str(tmp_path / "c.bam"))
    d1 = tmp_path / "s"
    d2 = tmp_path / "m"
    d1.mkdir()
    d2.mkdir()
    assert cli_main(["bam2pat", bam, "-o", str(d1)]) == 0
    assert cli_main(["bam2pat", bam, "-o", str(d2), "--procs", "2"]) == 0
    import gzip

    name = [p for p in os.listdir(d1) if p.endswith(".pat.gz")][0]
    with gzip.open(d1 / name) as f:
        want = f.read()
    with gzip.open(d2 / name) as f:
        got = f.read()
    assert got == want
    bname = [p for p in os.listdir(d1) if p.endswith(".beta")][0]
    assert (d2 / bname).read_bytes() == (d1 / bname).read_bytes()


def test_bai_chrom_weights(tmp_path, mini_genome):
    """The .bai parser extracts per-reference compressed spans (hand-built
    index blob: 2 refs, one with chunks + a 37450 pseudo-bin to skip, one
    empty)."""
    import struct

    from tests.bisim import dump_bam, simulate_reads
    from wgbs_tools_tpu.genome.cpg_index import read_fasta
    from wgbs_tools_tpu.parallel.multihost import _bam_chrom_weights

    rng = np.random.default_rng(23)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, rng, n_reads=50, paired=False)
    bam = dump_bam(reads, seqs, str(tmp_path / "w.bam"))

    n_ref = len(seqs)
    blob = b"BAI\x01" + struct.pack("<i", n_ref)
    # ref 0: bin 4681 with a chunk spanning coffsets 1000..9000, plus the
    # 37450 pseudo-bin (meta counts) that must NOT affect the span
    blob += struct.pack("<i", 2)
    blob += struct.pack("<Ii", 4681, 1)
    blob += struct.pack("<QQ", 1000 << 16, 9000 << 16)
    blob += struct.pack("<Ii", 37450, 2)
    blob += struct.pack("<QQ", 123 << 16, (1 << 40) << 16)
    blob += struct.pack("<QQ", 50, 0)
    blob += struct.pack("<i", 1) + struct.pack("<Q", 1000 << 16)
    # remaining refs: no bins
    for _ in range(n_ref - 1):
        blob += struct.pack("<i", 0) + struct.pack("<i", 0)
    with open(bam + ".bai", "wb") as f:
        f.write(blob)

    chroms = list(seqs)
    w = _bam_chrom_weights(bam, chroms, mini_genome.index)
    assert w[chroms[0]] == 8001.0  # 9000 - 1000 + 1
    assert all(w[c] == 1.0 for c in chroms[1:])


def _make_bai(bam):
    """Minimal .bai for a coordinate-sorted test BAM: one bin per ref with
    one chunk spanning the ref's records (real virtual offsets computed
    from the BGZF block table)."""
    import struct

    from wgbs_tools_tpu.native import bgzf_decompress_native

    raw = open(bam, "rb").read()
    blocks = []  # (coffset, decompressed start)
    c = d = 0
    while c + 18 <= len(raw):
        bl = struct.unpack_from("<H", raw, c + 16)[0] + 1
        isize = struct.unpack_from("<I", raw, c + bl - 4)[0]
        blocks.append((c, d))
        c += bl
        d += isize
    dstarts = [b[1] for b in blocks]

    def voff(doff):
        import bisect

        j = bisect.bisect_right(dstarts, doff) - 1
        return (blocks[j][0] << 16) | (doff - dstarts[j])

    buf = bgzf_decompress_native(raw)
    (l_text,) = struct.unpack_from("<i", buf, 4)
    pos = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", buf, pos)
        pos += 4 + l_name + 4
    spans = [None] * n_ref
    while pos + 8 <= len(buf):
        (bs,) = struct.unpack_from("<i", buf, pos)
        (rid,) = struct.unpack_from("<i", buf, pos + 4)
        end = pos + 4 + bs
        if 0 <= rid < n_ref:
            v0, v1 = voff(pos), voff(end)
            spans[rid] = ((v0, v1) if spans[rid] is None
                          else (min(spans[rid][0], v0),
                                max(spans[rid][1], v1)))
        pos = end
    out = b"BAI\x01" + struct.pack("<i", n_ref)
    for sp in spans:
        if sp is None:
            out += struct.pack("<i", 0) + struct.pack("<i", 0)
        else:
            out += struct.pack("<i", 1)
            out += struct.pack("<Ii", 4681, 1)
            out += struct.pack("<QQ", sp[0], sp[1])
            out += struct.pack("<i", 0)
    with open(bam + ".bai", "wb") as f:
        f.write(out)
    return spans


def test_bam2pat_procs_bai_ranged_decode(tmp_path, mini_genome):
    """With a .bai present, workers decode only their chromosome block's
    byte range: the ranged scan returns exactly that ref's records, and
    the end-to-end --procs output stays identical to single-process."""
    from tests.bisim import dump_bam, simulate_reads
    from wgbs_tools_tpu.genome.cpg_index import read_fasta
    from wgbs_tools_tpu.parallel.multihost import (_bai_ref_begs,
                                                   run_bam2pat_multiprocess)
    from wgbs_tools_tpu.pipeline.bam2pat_run import bam2pat
    from wgbs_tools_tpu.pipeline.bam_columnar import scan_bam_columnar

    rng = np.random.default_rng(31)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, rng, n_reads=600, paired=True)
    bam = dump_bam(reads, seqs, str(tmp_path / "rb.bam"))
    spans = _make_bai(bam)
    begs = _bai_ref_begs(bam)
    assert begs is not None and begs[0] is not None

    # ranged scan of ref 1's slice: every scanned record is ref >= 1, and
    # the ref-1 record count matches the full scan's
    full = scan_bam_columnar(bam)
    assert full is not None
    v0 = begs[1]
    v1 = begs[2] if len(begs) > 2 and begs[2] is not None else None
    part = scan_bam_columnar(bam, byte_range=(v0, v1))
    assert part is not None
    n_full_r1 = int((full[4][:, 0] == 1).sum())
    n_part_r1 = int((part[4][:, 0] == 1).sum())
    assert n_part_r1 == n_full_r1 and n_full_r1 > 0
    assert int(part[4].shape[0]) < int(full[4].shape[0])

    d1 = tmp_path / "s"
    d2 = tmp_path / "m"
    d1.mkdir()
    d2.mkdir()
    _, single_pat, _ = bam2pat(bam, genome=mini_genome, out_dir=str(d1))
    multi_pat = run_bam2pat_multiprocess(bam, out_dir=str(d2),
                                         num_processes=2, timeout=600)
    import gzip

    with gzip.open(single_pat) as f:
        want = f.read()
    with gzip.open(multi_pat) as f:
        got = f.read()
    assert got == want


@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_worker_plan_binds_one_card_per_process(monkeypatch, nproc):
    """On a GPU host process i gets card i alone, and no CPU emulation."""
    from wgbs_tools_tpu.parallel import multihost

    monkeypatch.setattr(multihost, "visible_gpus", lambda: ["0", "1", "2",
                                                            "3"])
    plan = multihost.worker_plan(nproc)
    assert [env for env, _ in plan] == [{"CUDA_VISIBLE_DEVICES": str(i)}
                                        for i in range(nproc)]
    assert all(args == [] for _, args in plan)


def test_worker_plan_refuses_more_processes_than_cards(monkeypatch):
    from wgbs_tools_tpu.parallel import multihost
    from wgbs_tools_tpu.utils import IllegalArgumentError

    monkeypatch.setattr(multihost, "visible_gpus", lambda: ["0", "1"])
    with pytest.raises(IllegalArgumentError, match="exceeds the 2 GPU"):
        multihost.worker_plan(3)


def test_worker_plan_cpu(monkeypatch):
    """CPU emulation only when asked for; a GPU-less host runs plain CPU
    workers."""
    from wgbs_tools_tpu.parallel import multihost

    monkeypatch.setattr(multihost, "visible_gpus", lambda: ["0", "1"])
    plan = multihost.worker_plan(2, local_devices=3)
    assert plan == [({"JAX_PLATFORMS": "cpu"},
                     ["--platform", "cpu", "--local_devices", "3"])] * 2
    monkeypatch.setattr(multihost, "visible_gpus", lambda: [])
    assert multihost.worker_plan(2) == [({"JAX_PLATFORMS": "cpu"},
                                         ["--platform", "cpu"])] * 2


def test_visible_gpus_without_opening_a_card(monkeypatch):
    from wgbs_tools_tpu.parallel.multihost import visible_gpus

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    assert visible_gpus() == ["2", "3"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert visible_gpus() == []
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert visible_gpus() == []
