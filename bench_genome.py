#!/usr/bin/env python
"""Whole-genome-scale fast-segmentation benchmark on a GPU (not driver-run).

Measures the batched fast-mode segmentation (models/segment.py::
_segment_windows_fast) over an hg19-scale genome: 28.2M CpG sites cut into
472 chunks of 60k sites, K=5 samples, max_cpg=1000 — the production shape of
`wgbstools segment` genome-wide (ref: src/python/segment.py:96-110 runs one
process per chunk; here chunks are vmapped onto the GPU in batches and all
launches are dispatched asynchronously, syncing once at the end).

Env knobs: GEN_SITES (total sites), GEN_CHUNK (sites/chunk), GEN_BATCH
(windows/launch), GEN_K (samples), GEN_MAXCPG, BENCH_TIMEOUT.
Prints one human-readable summary plus a JSON line.
"""

import json
import os
import os.path as op
import sys
import time

sys.path.insert(0, op.dirname(op.abspath(__file__)))

import numpy as np

TOTAL_SITES = int(os.environ.get("GEN_SITES", 28_217_448))  # hg19 nr_sites
CHUNK = int(os.environ.get("GEN_CHUNK", 60_000))
BATCH = int(os.environ.get("GEN_BATCH", 8))
K = int(os.environ.get("GEN_K", 5))
MAX_CPG = int(os.environ.get("GEN_MAXCPG", 1000))
MAX_BP = 2000
PC = 15.0


def main():
    import jax.numpy as jnp

    from wgbs_tools_tpu.cli.main import ensure_compile_cache
    from wgbs_tools_tpu.device import require_gpu
    from wgbs_tools_tpu.models.segment import (
        _prefix_sums,
        _segment_windows_masks,
    )
    from wgbs_tools_tpu.ops.pileup import fetch_chunked

    require_gpu("bench_genome")
    ensure_compile_cache()

    rng = np.random.default_rng(20260817)
    n_chunks = (TOTAL_SITES + CHUNK - 1) // CHUNK
    n_launch = (n_chunks + BATCH - 1) // BATCH
    print(f"[bench_genome] {TOTAL_SITES:,} sites -> {n_chunks} chunks of "
          f"{CHUNK:,}, K={K}, W={MAX_CPG}, {n_launch} launches of {BATCH}")

    def make_batch():
        pms = np.empty((BATCH, K, CHUNK + 1), np.int32)
        pts = np.empty((BATCH, K, CHUNK + 1), np.int32)
        locis = np.empty((BATCH, CHUNK), np.int32)
        for w in range(BATCH):
            cov = rng.integers(1, 40, size=(K, CHUNK))
            meth = rng.binomial(cov, rng.random((K, 1)))
            pm, pt = _prefix_sums(np.stack([meth, cov], axis=2))
            pms[w], pts[w] = pm, pt
            locis[w] = np.cumsum(rng.integers(2, 120, size=CHUNK)) + 10_000
        return pms, pts, locis

    host_batches = [make_batch() for _ in range(min(n_launch, 4))]

    # compile + warm up (excluded from the timed run)
    out = _segment_windows_masks(
        jnp.asarray(host_batches[0][0]), jnp.asarray(host_batches[0][1]),
        jnp.asarray(host_batches[0][2]), MAX_CPG, MAX_BP, PC)
    out.block_until_ready()
    print("[bench_genome] compiled")

    # timed: dispatch every launch asynchronously (host data cycles through
    # pre-staged batches — device transfer overlaps compute), then drain the
    # per-window uint8 border masks (the traceback already ran on device)
    t0 = time.perf_counter()
    outs = []
    for i in range(n_launch):
        b = host_batches[i % len(host_batches)]
        outs.append(_segment_windows_masks(
            jnp.asarray(b[0]), jnp.asarray(b[1]), jnp.asarray(b[2]),
            MAX_CPG, MAX_BP, PC))
    n_borders = 0
    for o in outs:
        m = fetch_chunked(o)
        n_borders += int(m.sum()) - m.shape[0]
    dt = time.perf_counter() - t0
    per_chunk = dt / (n_launch * BATCH)
    print(f"[bench_genome] device total incl. mask fetch {dt:.2f}s "
          f"({per_chunk*1e3:.1f} ms/chunk, {n_launch * BATCH} chunks, "
          f"{n_borders:,} borders)")

    print(json.dumps({
        "metric": "segment_fast_genome_s",
        "value": round(dt, 2),
        "unit": "s",
        "chunks": n_launch * BATCH,
        "ms_per_chunk": round(per_chunk * 1e3, 2),
    }))


if __name__ == "__main__":
    main()
