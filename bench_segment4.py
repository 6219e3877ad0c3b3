#!/usr/bin/env python
"""Genome-wide segmentation four-way benchmark (GPU).

Same workload for every row: K sample betas on disk over GEN_SITES CpG
sites (hg19-scale by default), cut into 60k-site chunks — the production
`wgbstools segment` shape.

  ref_pool      reference `segmentor` binary, one process per chunk on a
                pool of ncores (its real execution model,
                ref: src/python/segment.py:137-155)
  host_exact    our native C++ banded DP, chunks across ncores threads
                (segment_ranges mode=exact — the shipped default)
  device_fast   float32 whole-DP on the GPU, windows batched
                (mode=fast; ~95-97% border agreement)
  device_exact  bit-exact device path: band-clipped ll-table cost build +
                batched float64 ring DP
                (WGBS_TPU_SEGMENT_EXACT_DEVICE=1)

host_exact and device_exact must produce identical borders (asserted).
Env: GEN_SITES, GEN_K, GEN_COV, SEG4_ROWS (csv subset), SEG4_CHUNK.
Prints a row table and one JSON line.
"""

import json
import os
import os.path as op
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, op.dirname(op.abspath(__file__)))

import numpy as np

N = int(os.environ.get("GEN_SITES", 28_217_448))
K = int(os.environ.get("GEN_K", 3))
COV = float(os.environ.get("GEN_COV", 10.0))
CHUNK = int(os.environ.get("SEG4_CHUNK", 60_000))
MAX_CPG, MAX_BP, PS = 1000, 2000, 15.0
ROWS = os.environ.get(
    "SEG4_ROWS", "ref_pool,host_exact,device_fast,device_exact").split(",")
NCORES = os.cpu_count() or 1
REFERENCE = os.environ.get("WGBS_REFERENCE", "/root/reference")


def log(m):
    print(f"[seg4] {m}", flush=True)


def build_reference_segmentor(td):
    srcs = [op.join(REFERENCE, "src/segment_betas/main.cpp"),
            op.join(REFERENCE, "src/segment_betas/segmentor.cpp")]
    exe = op.join(td, "segmentor")
    subprocess.check_call(
        ["g++", "-std=c++11", "-O2", "-o", exe] + srcs
        + ["-I", op.join(REFERENCE, "src/segment_betas")],
        stderr=subprocess.DEVNULL)
    return exe


def main():
    from wgbs_tools_tpu.cli.main import ensure_compile_cache
    from wgbs_tools_tpu.device import require_gpu
    from wgbs_tools_tpu.formats.beta import save_beta
    from wgbs_tools_tpu.models.segment import SegmentConfig, segment_ranges

    require_gpu("seg4")
    ensure_compile_cache()

    rng = np.random.default_rng(20260821)
    log(f"generating K={K} betas over {N:,} sites (~{K*COV:.0f}x total), "
        f"{NCORES} cores")
    loci = np.cumsum(rng.integers(5, 60, size=N, dtype=np.int64)) + 100
    td_obj = tempfile.TemporaryDirectory()
    td = td_obj.name
    betas = []
    for k in range(K):
        cov = rng.poisson(COV, size=N).astype(np.int64)
        p = np.clip(0.15 + 0.7 * ((np.arange(N) // 300) % 2)
                    + rng.normal(0, 0.05, size=N), 0.01, 0.99)
        meth = rng.binomial(cov, p)
        path = op.join(td, f"s{k}.beta")
        save_beta(path, np.stack([meth, cov], axis=1))
        betas.append(path)
        del cov, meth, p

    class FakeIndex:
        pass

    idx = FakeIndex()
    idx.loci = loci

    chunks = [(s, min(s + CHUNK, N + 1))
              for s in range(1, N + 1, CHUNK)]
    log(f"{len(chunks)} chunks of {CHUNK} sites")
    results = {}
    borders = {}

    if "ref_pool" in ROWS:
        exe = build_reference_segmentor(td)
        log("ref_pool: compiling + running the reference segmentor per "
            f"chunk on {NCORES} processes")
        procs = []
        t0 = time.perf_counter()
        outs = [None] * len(chunks)
        import collections
        running = collections.deque()
        for i, (s, e) in enumerate(chunks):
            stdin = ("\n".join(str(int(x)) for x in loci[s - 1 : e - 1])
                     + "\n").encode()
            while len(running) >= NCORES:
                j, pr = running.popleft()
                outs[j] = pr.stdout.read()
                if pr.wait():
                    raise RuntimeError(f"segmentor chunk {j} failed")
            pr = subprocess.Popen(
                [exe] + betas + ["-s", str(s - 1), "-n", str(e - s),
                                 "-max_cpg", str(MAX_CPG),
                                 "-max_bp", str(MAX_BP), "-ps", str(PS)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            pr.stdin.write(stdin)
            pr.stdin.close()
            running.append((i, pr))
        while running:
            j, pr = running.popleft()
            outs[j] = pr.stdout.read()
            pr.wait()
        dt = time.perf_counter() - t0
        nb = sum(len(o.split()) for o in outs)
        results["ref_pool"] = dt
        log(f"ref_pool: {dt:.1f} s ({nb} pre-stitch borders; reference "
            "python stitching excluded — favors the reference)")

    def run_mode(name, mode, env=None):
        saved = {}
        for k_, v in (env or {}).items():
            saved[k_] = os.environ.get(k_)
            os.environ[k_] = v
        try:
            cfg = SegmentConfig(max_cpg=MAX_CPG, max_bp=MAX_BP,
                                pseudo_count=PS, chunk_size=CHUNK,
                                mode=mode, threads=NCORES)
            t0 = time.perf_counter()
            st, en = segment_ranges(betas, [(1, N + 1)], idx, cfg)
            dt = time.perf_counter() - t0
            results[name] = dt
            borders[name] = st
            log(f"{name}: {dt:.1f} s ({len(st):,} blocks)")
        finally:
            for k_, v in saved.items():
                if v is None:
                    os.environ.pop(k_, None)
                else:
                    os.environ[k_] = v

    if "host_exact" in ROWS:
        run_mode("host_exact", "exact",
                 {"WGBS_TPU_SEGMENT_EXACT_DEVICE": "0"})
    if "device_fast" in ROWS:
        run_mode("device_fast", "fast")
    if "device_exact" in ROWS:
        run_mode("device_exact", "exact",
                 {"WGBS_TPU_SEGMENT_EXACT_DEVICE": "1"})

    if "host_exact" in borders and "device_exact" in borders:
        same = np.array_equal(borders["host_exact"], borders["device_exact"])
        log(f"device_exact borders identical to host_exact: {same}")
        assert same, "exact paths must agree bit-for-bit"

    print(json.dumps({
        "metric": "segment_genome_wide_s",
        "sites": N, "k": K, "chunks": len(chunks), "ncores": NCORES,
        **{f"{k_}_s": round(v, 1) for k_, v in results.items()},
    }))
    td_obj.cleanup()


if __name__ == "__main__":
    main()
