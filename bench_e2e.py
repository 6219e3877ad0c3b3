#!/usr/bin/env python
"""End-to-end job benchmark on a GPU: pat.gz on disk -> beta file on disk,
plus the downstream fast-segmentation stage — the whole `pat2beta` /
`segment` JOB, not just the pileup kernel.

Ours: streamed BGZF decode (native, multithreaded) -> host staging -> device
pileup with a device-resident running total -> on-device saturation ->
chunked fetch -> beta write. Reference: `gunzip -c | stdin2beta` on one CPU
core, the reference's per-chromosome execution model
(ref: src/python/pat2beta.py:41-65), plus `segmentor` per 60k-site chunk
(ref: src/python/segment.py:96-110).

Env knobs:
  E2E_FRAGS   fragment count                  (default 20,000,000)
  E2E_SITES   genome size in CpG sites        (default 28,217,448 = hg19)
  E2E_REF     0 to skip the reference run     (default 1)
  E2E_SEG     0 to skip segmentation stages   (default 1)
  E2E_KEEP    path to reuse/keep the pat.gz   (default: temp, deleted)

Prints a stage table and one JSON line.
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

N_FRAGS = int(os.environ.get("E2E_FRAGS", 20_000_000))
N_SITES = int(os.environ.get("E2E_SITES", 28_217_448))
RUN_REF = os.environ.get("E2E_REF", "1") != "0"
RUN_SEG = os.environ.get("E2E_SEG", "1") != "0"
RUN_DEVICE = os.environ.get("E2E_DEVICE", "1") != "0"  # 0 = host-only run
KEEP = os.environ.get("E2E_KEEP", "")
REFERENCE = os.environ.get("WGBS_REFERENCE", "/root/reference")
MAX_LEN = 24
GEN_CHUNK = 2_000_000  # fragments per generation slab


def log(msg):
    print(f"[bench_e2e] {msg}", flush=True)


def make_pat(path):
    """Synthesize a sorted pat.gz of N_FRAGS fragments over N_SITES sites.

    Written slab-by-slab (each slab covers a disjoint site range, so the file
    is globally sorted); BGZF members concatenate into one valid file."""
    from wgbs_tools_tpu.formats.bgzf import _BGZF_EOF as BGZF_EOF
    from wgbs_tools_tpu.formats.pat import PatFrags, frags_to_bytes
    from wgbs_tools_tpu.native import bgzf_compress_native

    rng = np.random.default_rng(20260820)
    n_slabs = (N_FRAGS + GEN_CHUNK - 1) // GEN_CHUNK
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        done = 0
        for i in range(n_slabs):
            n = min(GEN_CHUNK, N_FRAGS - done)
            lo = 1 + (N_SITES - MAX_LEN) * i // n_slabs
            hi = 1 + (N_SITES - MAX_LEN) * (i + 1) // n_slabs
            starts = np.sort(
                rng.integers(lo, max(hi, lo + 1), size=n)
            ).astype(np.int32)
            lengths = rng.integers(1, MAX_LEN + 1, size=n).astype(np.int32)
            counts = rng.integers(1, 4, size=n).astype(np.int32)
            codes = np.where(
                rng.random((n, MAX_LEN)) < 0.7, 1, 0
            ).astype(np.uint8)
            codes[rng.random((n, MAX_LEN)) < 0.02] = 3
            codes[np.arange(MAX_LEN)[None, :] >= lengths[:, None]] = 3
            frags = PatFrags(starts, lengths, counts, codes,
                             np.zeros(n, np.int16), ["chr1"], None)
            text = frags_to_bytes(frags)
            comp = bgzf_compress_native(text)
            if comp is None:
                raise RuntimeError("native BGZF compressor unavailable")
            if comp.endswith(BGZF_EOF) and i < n_slabs - 1:
                comp = comp[: -len(BGZF_EOF)]
            f.write(comp)
            done += n
    gen_s = time.perf_counter() - t0
    sz = op.getsize(path)
    log(f"generated {N_FRAGS:,} frags -> {sz / 1e6:.0f} MB pat.gz "
        f"in {gen_s:.0f}s")
    return sz


def run_ours(pat_path, beta_path):
    """Instrumented production pat2beta loop; returns stage times + counts
    left on device for the segmentation stage."""
    from wgbs_tools_tpu.formats.pat import iter_pat
    from wgbs_tools_tpu.ops.pileup import PileupAccumulator

    acc = PileupAccumulator((1, N_SITES + 1))
    log(f"pileup accumulator: device_total={acc.device_total}")
    t = {"decode": 0.0, "pileup": 0.0}
    t_all0 = time.perf_counter()
    it = iter_pat(pat_path)
    nf = 0
    while True:
        t0 = time.perf_counter()
        chunk = next(it, None)
        t["decode"] += time.perf_counter() - t0
        if chunk is None:
            break
        t0 = time.perf_counter()
        acc.add(chunk)
        t["pileup"] += time.perf_counter() - t0
        nf += chunk.nr_frags
    t0 = time.perf_counter()
    beta = acc.finalize()
    t["finalize_fetch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    beta.tofile(beta_path)
    t["write"] = time.perf_counter() - t0
    t["total"] = time.perf_counter() - t_all0
    return t, nf, acc, beta


def run_ours_overlapped(pat_path, beta_path):
    """The actual production entry point (prefetch-overlapped)."""
    from wgbs_tools_tpu.pipeline.pat2beta import pat2beta

    class G:
        nr_sites = N_SITES

        def get_nr_sites(self):
            return self.nr_sites

    t0 = time.perf_counter()
    pat2beta(pat_path, genome=G(), out_path=beta_path, sharded=False)
    return time.perf_counter() - t0


def run_ours_native(pat_path, beta_path):
    """The host-kernel job (backend='native'): C++ pileup over the decoded
    SoA arrays, no device traffic. This is what `auto` picks on hosts
    without a GPU."""
    from wgbs_tools_tpu.pipeline.pat2beta import pat2beta

    class G:
        nr_sites = N_SITES

        def get_nr_sites(self):
            return self.nr_sites

    t0 = time.perf_counter()
    pat2beta(pat_path, genome=G(), out_path=beta_path, sharded=False,
             backend="native")
    return time.perf_counter() - t0


def run_reference(pat_path):
    """gunzip | stdin2beta on one core — the reference pat2beta job."""
    src = op.join(REFERENCE, "src/pat2beta/stdin2beta.cpp")
    if not op.isfile(src):
        return None
    with tempfile.TemporaryDirectory() as td:
        exe = op.join(td, "stdin2beta")
        subprocess.check_call(["g++", "-std=c++11", "-O2", "-o", exe, src],
                              stderr=subprocess.DEVNULL)
        t0 = time.perf_counter()
        subprocess.run(
            f"gunzip -c {pat_path} | {exe} 1 {N_SITES + 1} > /dev/null",
            shell=True, check=True)
        return time.perf_counter() - t0


def run_segmentation(acc):
    """Genome-wide fast segmentation straight off the device-resident counts
    (the pat2beta -> segment chain shares the table; no re-read)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from wgbs_tools_tpu.models.segment import (_segment_windows_masks_packed,
                                               unpack_mask_bits)

    CHUNK = int(os.environ.get("E2E_CHUNK", 60_000))
    W = int(os.environ.get("E2E_MAXCPG", 1_000))
    MAX_BP, PC, BATCH = 2_000, 15.0, 8
    total = acc.total if getattr(acc, "device_total", False) \
        else jnp.asarray(np.asarray(acc.result(), np.int32))
    n_chunks = N_SITES // CHUNK  # truncate the ragged tail chunk
    n_batches = n_chunks // BATCH  # and the ragged tail batch
    loci = jnp.arange(CHUNK, dtype=jnp.int32) * 35  # ~hg19 mean spacing

    @partial(jax.jit, static_argnames=("chunk", "nb"))
    def batch_prefix(tot, b0, chunk, nb):
        def one(w):
            seg = jax.lax.dynamic_slice(tot, ((b0 + w) * chunk, 0),
                                        (chunk, 2))
            m = seg[:, 0]
            u = seg[:, 1] - seg[:, 0]
            z = jnp.zeros(1, jnp.int32)
            return (jnp.concatenate([z, jnp.cumsum(m, dtype=jnp.int32)])[None],
                    jnp.concatenate([z, jnp.cumsum(u, dtype=jnp.int32)])[None])

        return jax.vmap(one)(jnp.arange(nb, dtype=jnp.int32))

    t0 = time.perf_counter()
    outs = []
    locis = jnp.broadcast_to(loci, (BATCH, CHUNK))
    for bi in range(n_batches):
        pm, pt = batch_prefix(total, np.int32(bi * BATCH), CHUNK, BATCH)
        outs.append(_segment_windows_masks_packed(pm, pt, locis, W, MAX_BP,
                                                  PC))
    from wgbs_tools_tpu.ops.pileup import fetch_chunked

    # traceback ran on device (pointer doubling); fetch bit-packed masks
    # only (8x less d2h than the uint8 masks)
    masks = unpack_mask_bits(
        fetch_chunked(jnp.concatenate(outs, axis=0)), CHUNK + 1)
    n_borders = int(masks.sum()) - masks.shape[0]
    seg_s = time.perf_counter() - t0
    log(f"segment-fast: {n_batches * BATCH} chunks, {n_borders:,} blocks, "
        f"{seg_s:.1f}s")
    return seg_s, n_batches * BATCH


def main():
    from wgbs_tools_tpu.cli.main import ensure_compile_cache
    from wgbs_tools_tpu.device import require_gpu

    require_gpu("bench_e2e")
    ensure_compile_cache()
    workdir = op.dirname(KEEP) if KEEP else tempfile.mkdtemp(prefix="e2e_")
    pat_path = KEEP or op.join(workdir, "bench.pat.gz")
    beta_path = op.join(workdir, "bench.beta")
    if not op.exists(pat_path):
        make_pat(pat_path)

    if RUN_DEVICE:
        t_cold, nf, acc, beta = run_ours(pat_path, beta_path)
        log(f"ours pat2beta (cold process — includes compiles or their "
            f"load from the persistent cache): {t_cold['total']:.1f}s")
        # warm pass in the same process: the steady-state stage table
        t, nf, acc, beta = run_ours(pat_path, beta_path)
        log(f"ours pat2beta (warm): {t['total']:.1f}s total = "
            f"{t['decode']:.1f} decode + {t['pileup']:.1f} stage/pileup + "
            f"{t['finalize_fetch']:.1f} saturate/fetch + {t['write']:.1f} "
            f"write ({nf / t['total'] / 1e6:.2f} M frags/s job rate)")
        cov_mean = float(beta[:, 1].astype(np.float64).mean())
        log(f"beta: {op.getsize(beta_path) / 1e6:.0f} MB, "
            f"mean cov {cov_mean:.1f}")

        t_overlap = run_ours_overlapped(pat_path, beta_path + ".2")
        same = (open(beta_path, "rb").read()
                == open(beta_path + ".2", "rb").read())
        log(f"production pat2beta (prefetch-overlapped): {t_overlap:.1f}s, "
            f"byte-identical={same}")
    else:
        t = {"total": float("inf")}
        t_cold = {}
        t_overlap = float("inf")
        nf = N_FRAGS
        same = True
        acc = None

    t_native = run_ours_native(pat_path, beta_path + ".3")
    if RUN_DEVICE:
        same_native = (open(beta_path, "rb").read()
                       == open(beta_path + ".3", "rb").read())
    else:
        same_native = True
    log(f"host-kernel pat2beta (backend=native): {t_native:.1f}s, "
        f"byte-identical={same_native}")
    same = same and same_native

    seg_s = seg_chunks = None
    if RUN_SEG and acc is not None:
        seg_s, seg_chunks = run_segmentation(acc)

    ref_s = run_reference(pat_path) if RUN_REF else None
    if ref_s is not None:
        log(f"reference gunzip|stdin2beta (1 core): {ref_s:.1f}s "
            f"({nf / ref_s / 1e6:.2f} M frags/s)")

    out = {
        "metric": "pat2beta_job_e2e",
        "n_frags": nf,
        "n_sites": N_SITES,
        "ours_s": round(min(t["total"], t_overlap, t_native), 2),
        "stages_s": {k: round(v, 2) for k, v in t.items()
                     if v != float("inf")},
        "cold_process_s": {k: round(v, 2) for k, v in t_cold.items()},
        "overlapped_s": (None if t_overlap == float("inf")
                         else round(t_overlap, 2)),
        "native_s": round(t_native, 2),
        "segment_fast_s": None if seg_s is None else round(seg_s, 2),
        "reference_s": None if ref_s is None else round(ref_s, 2),
        "vs_baseline": None if ref_s is None
        else round(ref_s / min(t["total"], t_overlap, t_native), 2),
        "byte_identical_paths": same,
    }
    print(json.dumps(out))
    if not KEEP:
        for p in (pat_path, beta_path, beta_path + ".2", beta_path + ".3"):
            if op.exists(p):
                os.remove(p)


if __name__ == "__main__":
    main()
