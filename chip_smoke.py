#!/usr/bin/env python
"""Smoke test of wgbs_tools_tpu's main paths on one NVIDIA GPU.

Drives the CLI (`wgbs_tools_tpu.cli.main.main`) in this process at
deployment scale, on data made from --seed, and checks every output
against the host paths. Run from the repository root:

    python chip_smoke.py              # phases 0-4, one card
    python chip_smoke.py --cards 4    # phase 5 only, four cards

0. device check: JAX must find a GPU; prints its kind, count, the card's
   `name, power.limit` and the JAX version.
1. small CLI drive (init_genome, bam2pat, pat2beta, segment, homog,
   beta_to_blocks, view -s), byte-compared with the same drive run on the
   host paths (a JAX_PLATFORMS=cpu child process).
2. pat2beta of 20,000,000 fragments over hg19's 28,217,448 sites: the
   device pileup's beta byte-identical to the host C++ kernel's.
3. segment of 2,500,000 sites, K=3 betas at ~30x: exact mode on the device
   bit-identical to the host C++ DP (the default); fast mode sharing >= 95%
   of borders.
4. bam2pat of a 200,000-pair BAM: device calling (the GPU default) and host
   calling write identical pat.gz files.
5. (--cards 4 only) hg19 `pat2beta --sharded` over four cards, and
   `pat2beta --procs 4` / `segment --procs 4` (one card per process),
   each equal to the one-card output.

Any failed check exits non-zero. The last line of stdout is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import argparse
import gzip
import json
import os
import os.path as op
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = op.dirname(op.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, op.join(REPO, "tests"))

HG19_SITES = 28_217_448
SIZES = {  # full scale; --rehearse shrinks every entry
    "hg19_sites": HG19_SITES, "hg19_frags": 20_000_000,
    "seg_sites": 2_500_000, "bam_pairs": 200_000,
}
REHEARSE_SIZES = {"hg19_sites": 300_000, "hg19_frags": 300_000,
                  "seg_sites": 150_000, "bam_pairs": 5_000}
RESULTS = {}


class Failed(Exception):
    pass


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond, what):
    if not cond:
        raise Failed(what)
    log(f"PASS {what}")


def cli(*argv, env=None):
    """Run one CLI command in this process with temporary environment
    overrides; returns its wall time in seconds."""
    from wgbs_tools_tpu.cli.main import main

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    t0 = time.perf_counter()
    try:
        rc = main([str(a) for a in argv])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    dt = time.perf_counter() - t0
    if rc:
        raise Failed(f"`{argv[0]}` exited {rc}")
    return dt


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# host paths: what a machine without a GPU runs
HOST_ENV = {"WGBS_TPU_PILEUP": "native", "WGBS_TPU_DEVICE_CALLING": "0",
            "WGBS_TPU_SEGMENT_EXACT_DEVICE": "0"}


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------


def device_check(cards, rehearse):
    import jax

    from wgbs_tools_tpu.device import card_lines

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu" and not rehearse:
        print(f"chip_smoke: JAX found no GPU (platform {d.platform!r})",
              file=sys.stderr)
        sys.exit(1)
    if len(devs) < cards:
        raise Failed(f"--cards {cards} but JAX sees {len(devs)} device(s)")
    log(f"device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    if d.platform == "gpu":
        for line in card_lines():
            print(line, flush=True)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# phase 1: the small CLI drive
# ---------------------------------------------------------------------------


def small_drive(d, seed):
    """init_genome -> bam2pat -> view -> segment -> homog -> beta_to_blocks
    in directory `d` (which must not exist), with its own reference dir."""
    from bisim import dump_bam, simulate_reads
    from synth import make_fasta

    from wgbs_tools_tpu.genome.cpg_index import read_fasta

    os.makedirs(d)
    os.environ["WGBS_TPU_REFDIR"] = op.join(d, "refs")
    rng = np.random.default_rng(seed)
    fa = make_fasta(op.join(d, "demo.fa"), {"chr1": 120000, "chr2": 60000},
                    rng)
    seqs = read_fasta(fa)
    reads, _ = simulate_reads(seqs, rng, n_reads=1500, paired=True)
    bam = dump_bam(reads, seqs, op.join(d, "sample.bam"))
    out = op.join(d, "out")
    os.makedirs(out)
    cli("init_genome", "demo", "--fasta_path", fa)
    cli("bam2pat", bam, "-o", out)
    pat, beta = op.join(out, "sample.pat.gz"), op.join(out, "sample.beta")
    cli("view", pat, "-s", "500-520", "-o", op.join(out, "view.txt"))
    blocks = op.join(out, "blocks.bed")
    cli("segment", "--betas", beta, "-o", blocks)
    cli("homog", pat, "-b", blocks, "-o", out)
    cli("beta_to_blocks", beta, "-b", blocks, "-o", out)
    return out


def phase1(work, seed):
    host_dir = op.join(work, "p1_host")
    env = dict(os.environ, JAX_PLATFORMS="cpu", **HOST_ENV)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    child = subprocess.Popen(
        [sys.executable, op.abspath(__file__), "--host-drive", host_dir,
         "--seed", str(seed)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        dev_out = small_drive(op.join(work, "p1_dev"), seed)
    finally:
        out, _ = child.communicate(timeout=1200)
    if child.returncode:
        raise Failed("host drive failed:\n"
                     + out.decode(errors="replace")[-3000:])
    host_out = op.join(host_dir, "out")
    names = sorted(os.listdir(dev_out))
    check(names == sorted(os.listdir(host_out)),
          f"phase 1: same output files ({len(names)})")
    for n in names:
        check(same_bytes(op.join(dev_out, n), op.join(host_out, n)),
              f"phase 1: {n} byte-identical to the host path")


# ---------------------------------------------------------------------------
# phase 2: hg19-scale pat2beta
# ---------------------------------------------------------------------------


def make_hg19(work, seed, sizes):
    """Reference dir `hg19sim` (24 chromosomes, hg19's CpG count) and a
    sorted, indexed pat.gz of sizes['hg19_frags'] fragments (up to 24
    CpGs, counts 1-3). Returns the pat path."""
    from wgbs_tools_tpu.formats.bgzf import _BGZF_EOF
    from wgbs_tools_tpu.formats.pat import PatFrags, frags_to_bytes, index_pat
    from wgbs_tools_tpu.genome.cpg_index import CpGIndex
    from wgbs_tools_tpu.native import bgzf_compress_native

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 2)
    n_sites, n_frags, max_len = sizes["hg19_sites"], sizes["hg19_frags"], 24
    names = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY"]
    offs = np.linspace(0, n_sites, len(names) + 1).astype(np.int64)
    loci = np.empty(n_sites, np.int32)
    for a, b in zip(offs[:-1], offs[1:]):
        loci[a:b] = np.cumsum(rng.integers(2, 220, size=b - a))
    sizes_bp = np.array([int(loci[b - 1]) + 1000 for b in offs[1:]])
    idx = CpGIndex(loci, offs, names, sizes_bp, name="hg19sim")
    refdir = op.join(os.environ["WGBS_TPU_REFDIR"], "hg19sim")
    os.makedirs(refdir, exist_ok=True)
    idx.save(refdir)

    pat = op.join(work, "hg19.pat.gz")
    slab = 2_000_000
    n_slabs = -(-n_frags // slab)
    with open(pat, "wb") as f:
        done = 0
        for i in range(n_slabs):
            n = min(slab, n_frags - done)
            lo = 1 + (n_sites - max_len) * i // n_slabs
            hi = 1 + (n_sites - max_len) * (i + 1) // n_slabs
            starts = np.sort(rng.integers(lo, max(hi, lo + 1), size=n))
            lengths = rng.integers(1, max_len + 1, size=n).astype(np.int32)
            codes = np.where(rng.random((n, max_len)) < 0.7, 1, 0).astype(
                np.uint8)
            codes[rng.random((n, max_len)) < 0.02] = 3
            codes[np.arange(max_len)[None, :] >= lengths[:, None]] = 3
            frags = PatFrags(starts.astype(np.int32), lengths,
                             rng.integers(1, 4, size=n).astype(np.int32),
                             codes,
                             idx.site2chrom_id(starts).astype(np.int16),
                             names, None)
            comp = bgzf_compress_native(frags_to_bytes(frags))
            if i < n_slabs - 1 and comp.endswith(_BGZF_EOF):
                comp = comp[: -len(_BGZF_EOF)]
            f.write(comp)
            done += n
    index_pat(pat)
    log(f"made hg19sim ({n_sites:,} sites) and {n_frags:,} fragments "
        f"({op.getsize(pat) / 1e6:.0f} MB pat.gz) in "
        f"{time.perf_counter() - t0:.1f} s")
    return pat


def spy_accumulator():
    """Record how each PileupAccumulator held its total at finalize()."""
    from wgbs_tools_tpu.ops.pileup import PileupAccumulator

    seen = []
    orig = PileupAccumulator.finalize

    def finalize(self, lbeta=False):
        seen.append({
            "backend": self.backend, "device_total": self.device_total,
            "platforms": sorted({dv.platform for dv in self.total.devices()})
            if self.device_total else ["host"]})
        return orig(self, lbeta)

    PileupAccumulator.finalize = finalize
    return seen


def scatter_roofline(pat):
    """Steady-state time of the XLA pileup step on one real 2^20-fragment
    batch, with its least HBM traffic (inputs once + the count window read
    and written once) over the H100's 3.35 TB/s."""
    import jax
    import jax.numpy as jnp

    from wgbs_tools_tpu.formats.pat import iter_pat
    from wgbs_tools_tpu.ops.pileup import _bucket, _pileup_batch_xla

    fr = next(iter_pat(pat, chunk_bytes=48 << 20))
    F = 1 << 20
    s0 = int(fr.start[0])
    L = _bucket(fr.codes.shape[1], 8)
    win = _bucket(int(fr.start[F - 1]) + L - s0 + 1, 1 << 16)
    codes = np.full((F, L), 3, np.uint8)
    codes[:, : fr.codes.shape[1]] = fr.codes[:F]
    args = (jnp.asarray(fr.start[:F].astype(np.int32) - s0),
            jnp.asarray(fr.length[:F].astype(np.int32)),
            jnp.asarray(fr.count[:F].astype(np.int32)),
            jnp.asarray(codes))
    lowered = _pileup_batch_xla.lower(*args, window_len=win)
    log(f"pileup step ({F}x{L} codes, window {win}) memory_analysis: "
        f"{lowered.compile().memory_analysis()}")
    _pileup_batch_xla(*args, window_len=win).block_until_ready()
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        _pileup_batch_xla(*args, window_len=win).block_until_ready()
        ts.append(time.perf_counter() - t0)
    t = float(np.median(ts))
    nbytes = F * (L + 12) + 2 * (win + 1) * 2 * 4
    cells = int(fr.length[:F].sum())
    share = nbytes / 3.35e12 / t
    log(f"pileup step: {t * 1e3:.3f} ms median of 10; {cells / t / 1e9:.2f} "
        f"G observed cells/s; least traffic {nbytes / 1e6:.1f} MB -> "
        f"{nbytes / t / 1e9:.1f} GB/s = {100 * share:.2f}% of 3.35 TB/s")
    RESULTS["pileup_step"] = {"ms": t * 1e3, "frags": F, "L": L,
                              "window": win, "cells": cells,
                              "hbm_share": share}


def phase2(work, seed, sizes, gpu):
    import jax

    pat = make_hg19(work, seed, sizes)
    if gpu:
        scatter_roofline(pat)
    seen = spy_accumulator()
    dev_dir, nat_dir = op.join(work, "p2_dev"), op.join(work, "p2_native")
    os.makedirs(dev_dir)
    os.makedirs(nat_dir)
    t_cold = cli("pat2beta", pat, "-o", dev_dir, "--genome", "hg19sim")
    t_warm = cli("pat2beta", pat, "-o", dev_dir, "--genome", "hg19sim", "-f")
    log(f"pat2beta accumulators: {seen}")
    if gpu:
        check(len(seen) == 2 and all(
            s["backend"] == "xla" and s["device_total"]
            and s["platforms"] == ["gpu"] for s in seen),
            "phase 2: plain pat2beta piled up with its total on the GPU")
    t_nat = cli("pat2beta", pat, "-o", nat_dir, "--genome", "hg19sim",
                env={"WGBS_TPU_PILEUP": "native"})
    check(len(seen) == 3 and seen[-1]["backend"] == "native",
          "phase 2: the host run used the C++ kernel")
    beta = op.join(dev_dir, "hg19.beta")
    check(same_bytes(beta, op.join(nat_dir, "hg19.beta")),
          "phase 2: device beta byte-identical to backend=native")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"pat2beta {sizes['hg19_frags']:,} frags: device cold "
        f"{t_cold:.2f} s, warm {t_warm:.2f} s; host C++ {t_nat:.2f} s; "
        f"peak_bytes_in_use {peak}")
    RESULTS["pat2beta"] = {"frags": sizes["hg19_frags"],
                           "device_cold_s": t_cold, "device_warm_s": t_warm,
                           "native_s": t_nat, "peak_bytes_in_use": peak}
    return pat


# ---------------------------------------------------------------------------
# phase 3: chromosome-scale segment
# ---------------------------------------------------------------------------


def make_segment_data(work, seed, n):
    """Reference dir `chrsim` (one chromosome of n sites) and K=3 betas of
    ~10x each (~30x together) over blocks of constant methylation."""
    from wgbs_tools_tpu.formats.beta import save_beta
    from wgbs_tools_tpu.genome.cpg_index import CpGIndex

    rng = np.random.default_rng(seed + 3)
    loci = np.cumsum(rng.integers(2, 220, size=n)).astype(np.int32)
    idx = CpGIndex(loci, [0, n], ["chr1"], [int(loci[-1]) + 1000],
                   name="chrsim")
    refdir = op.join(os.environ["WGBS_TPU_REFDIR"], "chrsim")
    os.makedirs(refdir, exist_ok=True)
    idx.save(refdir)
    edges = np.cumsum(rng.geometric(1 / 150, size=n))
    level = rng.choice([0.05, 0.5, 0.95], size=edges.shape[0] + 1)
    site_level = level[np.searchsorted(edges, np.arange(n), side="right")]
    paths = []
    for k in range(3):
        cov = rng.poisson(10, size=n)
        meth = rng.binomial(cov, np.clip(site_level + rng.normal(
            0, 0.05, size=n), 0, 1))
        p = op.join(work, f"seg{k}.beta")
        save_beta(p, np.stack([meth, cov], axis=1).astype(np.uint8))
        paths.append(p)
    return paths


def borders_of(bed):
    """Block borders (as startCpG/endCpG sites) of a segment output."""
    rows = [l.split("\t") for l in open(bed).read().splitlines() if l]
    return np.unique(np.array([[int(r[3]), int(r[4])] for r in rows]))


def phase3(work, seed, sizes):
    n = sizes["seg_sites"]
    betas = make_segment_data(work, seed, n)
    d = op.join(work, "p3")
    os.makedirs(d)
    ex_dev, ex_host, fast = (op.join(d, f) for f in
                             ("exact_dev.bed", "exact_host.bed", "fast.bed"))
    base = ("segment", "--betas", *betas, "--genome", "chrsim")
    on_device = {"WGBS_TPU_SEGMENT_EXACT_DEVICE": "1"}
    t_dev = cli(*base, "-o", ex_dev, env=on_device)
    t_dev2 = cli(*base, "-o", ex_dev, env=on_device)
    t_host = cli(*base, "-o", ex_host,  # the default: host C++ DP
                 env={"WGBS_TPU_SEGMENT_EXACT_DEVICE": "0"})
    check(same_bytes(ex_dev, ex_host),
          "phase 3: exact borders on the device bit-identical to host C++")
    t_fast = cli(*base, "-o", fast, "--mode", "fast")
    t_fast2 = cli(*base, "-o", fast, "--mode", "fast")
    be, bf = borders_of(ex_dev), borders_of(fast)
    share = np.intersect1d(be, bf).shape[0] / be.shape[0]
    check(share >= 0.95, f"phase 3: fast mode shares {100 * share:.2f}% "
          "of exact borders (>= 95%)")
    log(f"segment {n:,} sites K=3: exact device {t_dev:.2f} s (cold) / "
        f"{t_dev2:.2f} s (warm), exact host C++ {t_host:.2f} s, fast "
        f"{t_fast:.2f} s (cold) / {t_fast2:.2f} s (warm); "
        f"{be.shape[0]:,} borders")
    RESULTS["segment"] = {"sites": n, "exact_device_cold_s": t_dev,
                          "exact_device_warm_s": t_dev2,
                          "exact_host_s": t_host, "fast_cold_s": t_fast,
                          "fast_warm_s": t_fast2, "fast_share": share}
    return betas


# ---------------------------------------------------------------------------
# phase 4: bam2pat
# ---------------------------------------------------------------------------


def phase4(work, seed, sizes):
    from bisim import simulate_bam_pairs
    from synth import make_fasta

    from wgbs_tools_tpu.genome.cpg_index import read_fasta

    rng = np.random.default_rng(seed + 4)
    d = op.join(work, "p4")
    os.makedirs(d)
    fa = make_fasta(op.join(d, "bamsim.fa"),
                    {"chr1": 4_000_000, "chr2": 3_000_000}, rng)
    cli("init_genome", "bamsim", "--fasta_path", fa, "--no_default")
    n_pairs = sizes["bam_pairs"]
    bam = simulate_bam_pairs(read_fasta(fa), rng, n_pairs,
                             op.join(d, "reads.bam"))
    log(f"bam2pat input: {n_pairs:,} read pairs ({2 * n_pairs:,} reads), "
        f"{op.getsize(bam) / 1e6:.0f} MB BAM")
    runs = {}
    for name, env in (("host", {"WGBS_TPU_DEVICE_CALLING": "0"}),
                      ("device_cold", {}), ("device", {})):
        out = op.join(d, name)
        os.makedirs(out)
        runs[name] = cli("bam2pat", bam, "-o", out, "--genome", "bamsim",
                         env=env)
    pats = {k: op.join(d, k, "reads.pat.gz") for k in runs}
    for k in ("device_cold", "device"):
        check(same_bytes(pats[k], pats["host"]),
              f"phase 4: {k} calling pat.gz identical to host calling")
    with gzip.open(pats["host"]) as f:
        n_lines = sum(1 for _ in f)
    rates = {k: 2 * n_pairs / t for k, t in runs.items()}
    log(f"bam2pat {2 * n_pairs:,} reads -> {n_lines:,} pat lines: "
        + ", ".join(f"{k} {t:.2f} s ({rates[k] / 1e6:.3f} M reads/s)"
                    for k, t in runs.items()))
    RESULTS["bam2pat"] = {"reads": 2 * n_pairs, "seconds": runs,
                          "reads_per_s": rates}


# ---------------------------------------------------------------------------
# phase 5: four cards
# ---------------------------------------------------------------------------


def phase5(work, seed, sizes, rehearse):
    """Multi-process runs first, while this process holds no card."""
    pat = make_hg19(work, seed, sizes)
    betas = make_segment_data(work, seed, sizes["seg_sites"])
    d = op.join(work, "p5")
    for sub in ("procs", "sharded", "one"):
        os.makedirs(op.join(d, sub))
    procs = ["--procs", "4"]
    t_pp = cli("pat2beta", pat, "-o", op.join(d, "procs"), "--genome",
               "hg19sim", *procs)
    # exact segmentation on each process's card (the default is host C++)
    os.environ["WGBS_TPU_SEGMENT_EXACT_DEVICE"] = "1"
    seg = ("segment", "--betas", *betas, "--genome", "chrsim")
    t_sp = cli(*seg, "-o", op.join(d, "seg_procs.bed"), *procs)

    dev = device_check(4, rehearse)
    seen = spy_accumulator()
    from wgbs_tools_tpu.parallel import sharded

    used = []
    orig_add = sharded.ShardedPileup.add

    def add(self, frags):
        used.append(len(self.devices))
        return orig_add(self, frags)

    sharded.ShardedPileup.add = add
    t_sh = cli("pat2beta", pat, "-o", op.join(d, "sharded"), "--genome",
               "hg19sim", "--sharded")
    t_sh2 = cli("pat2beta", pat, "-o", op.join(d, "sharded"), "--genome",
                "hg19sim", "--sharded", "-f")
    check(used and set(used) == {4} and not seen,
          "phase 5: pat2beta --sharded piled up over four cards")
    t_one = cli("pat2beta", pat, "-o", op.join(d, "one"), "--genome",
                "hg19sim")
    t_one2 = cli("pat2beta", pat, "-o", op.join(d, "one"), "--genome",
                 "hg19sim", "-f")
    one = op.join(d, "one", "hg19.beta")
    log(f"plain pat2beta accumulators: {seen}")
    if not rehearse:
        check(len(seen) == 2 and all(
            s["device_total"] and s["platforms"] == ["gpu"] for s in seen),
            "phase 5: plain pat2beta on a four-card host used one card")
    check(same_bytes(op.join(d, "sharded", "hg19.beta"), one),
          "phase 5: 4-card sharded beta byte-identical to one card")
    check(same_bytes(op.join(d, "procs", "hg19.beta"), one),
          "phase 5: pat2beta --procs 4 byte-identical to one card")
    t_s1 = cli(*seg, "-o", op.join(d, "seg_one.bed"))
    check(same_bytes(op.join(d, "seg_procs.bed"), op.join(d, "seg_one.bed")),
          "phase 5: segment --procs 4 identical to one process")
    log(f"four cards: pat2beta --sharded {t_sh:.2f} s (cold) / {t_sh2:.2f} s "
        f"(warm), one card {t_one:.2f} s (cold) / {t_one2:.2f} s (warm), "
        f"--procs 4 {t_pp:.2f} s; segment --procs 4 {t_sp:.2f} s, one "
        f"process {t_s1:.2f} s")
    RESULTS["four_cards"] = {"pat2beta_sharded_cold_s": t_sh,
                             "pat2beta_sharded_warm_s": t_sh2,
                             "pat2beta_one_card_cold_s": t_one,
                             "pat2beta_one_card_warm_s": t_one2,
                             "pat2beta_procs4_s": t_pp,
                             "segment_procs4_s": t_sp,
                             "segment_one_s": t_s1}
    return dev


# ---------------------------------------------------------------------------


def gpu_precheck(cards):
    """Device check in a child, for phase 5, whose parent must not open a
    card before its --procs workers have run."""
    r = subprocess.run(
        [sys.executable, "-c", "import jax; d = jax.devices(); "
         "print(d[0].platform, len(d))"], capture_output=True, text=True,
        timeout=600)
    out = r.stdout.split()
    if r.returncode or not out or out[0] != "gpu":
        print(f"chip_smoke: JAX found no GPU ({' '.join(out) or r.stderr[-500:]})",
              file=sys.stderr)
        sys.exit(1)
    if int(out[1]) < cards:
        print(f"chip_smoke: --cards {cards} but JAX sees {out[1]} GPU(s)",
              file=sys.stderr)
        sys.exit(1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated input (default 0)")
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card phase")
    ap.add_argument("--workdir", default=None,
                    help="keep the generated data here (default: a "
                         "temporary directory, removed at exit)")
    ap.add_argument("--rehearse", action="store_true",
                    help=argparse.SUPPRESS)  # tiny sizes, CPU allowed
    ap.add_argument("--host-drive", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    from wgbs_tools_tpu.cli.main import ensure_compile_cache

    ensure_compile_cache()
    if args.host_drive:
        small_drive(args.host_drive, args.seed)
        return 0
    sizes = REHEARSE_SIZES if args.rehearse else SIZES
    if args.cards == 1 and "CUDA_VISIBLE_DEVICES" not in os.environ:
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"  # one card, one process
    if args.cards == 4 and not args.rehearse:
        gpu_precheck(4)
    work = args.workdir or tempfile.mkdtemp(prefix="chip_smoke_")
    os.makedirs(work, exist_ok=True)
    os.environ["WGBS_TPU_REFDIR"] = op.join(work, "refs")
    if args.rehearse:
        # no GPU here: force the device paths onto the CPU backend
        os.environ.update({"WGBS_TPU_PILEUP": "xla",
                           "WGBS_TPU_DEVICE_CALLING": "1",
                           "WGBS_TPU_SEGMENT_EXACT_DEVICE": "1"})
    t0 = time.perf_counter()
    try:
        if args.cards == 4:
            dev = phase5(work, args.seed, sizes, args.rehearse)
        else:
            dev = device_check(1, args.rehearse)
            gpu = dev["platform"] == "gpu"
            for name, fn in (
                    ("1 small CLI drive", lambda: phase1(work, args.seed)),
                    ("2 hg19 pat2beta",
                     lambda: phase2(work, args.seed, sizes, gpu)),
                    ("3 segment", lambda: phase3(work, args.seed, sizes)),
                    ("4 bam2pat", lambda: phase4(work, args.seed, sizes))):
                tp = time.perf_counter()
                log(f"phase {name} ...")
                os.environ["WGBS_TPU_REFDIR"] = op.join(work, "refs")
                fn()
                log(f"phase {name}: {time.perf_counter() - tp:.1f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        if not args.workdir:
            shutil.rmtree(work, ignore_errors=True)
    log(f"summary {json.dumps(RESULTS)}")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    if args.rehearse:
        print("chip_smoke: rehearsal ok (no device result)")
        return 0
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
