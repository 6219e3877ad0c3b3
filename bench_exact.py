#!/usr/bin/env python
"""Exact-segmentation timings on one GPU: the float64 device DP per
window, its bit-identity with the host C++ DP, the ll-table lookup
(`jnp.take`), and the small-window gate of models/segment.py
(DEVICE_EXACT_MIN_SITES).

Run from the repository root on a GPU host:

    python bench_exact.py                  # window, take, gate
    python bench_exact.py --parts window,take

Each part runs in its own child process, so one process holds the card
at a time and every gate run starts as a fresh process would. Shapes:
one 60,000-site window, K=3 at ~30x, max_cpg 1000, max_bp 2000, batch
16; 61.4M lookups into a 2.1M-entry table; segment of 2,500,000 sites
(the data of chip_smoke.py's phase 3). Exits non-zero without a GPU or
when a device traceback differs from the C++ one.
"""

import argparse
import json
import os
import os.path as op
import subprocess
import sys
import tempfile
import time

REPO = op.dirname(op.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

N, K, COV, MAX_CPG, MAX_BP, PC = 60_000, 3, 10.0, 1000, 2000, 15.0
TRIALS = 5


def log(m):
    print(f"[bench_exact] {m}", flush=True)


def window_data():
    """One 60k-site window: K Poisson(10) samples over 250-site blocks
    alternating between 15% and 85% methylation."""
    rng = np.random.default_rng(0)
    cov = rng.poisson(COV, size=(K, N)).astype(np.int64)
    meth = rng.binomial(cov, np.clip(
        0.15 + 0.7 * ((np.arange(N) // 250) % 2), 0, 1)[None, :])
    data = np.stack([meth, cov], axis=2)
    loci = np.cumsum(rng.integers(5, 60, size=N)).astype(np.int64) + 100
    return data, loci


def part_window():
    from wgbs_tools_tpu.models.segment_exact_tpu import (
        max_band_width, segment_exact_device_batch)
    from wgbs_tools_tpu.native import segment_exact_native

    data, loci = window_data()
    W = min(MAX_CPG, N)
    B = 16
    log(f"window n={N} K={K} W={W} max_bp={MAX_BP} band "
        f"{max_band_width(loci, W, MAX_BP)}, batch {B}")
    datas = np.broadcast_to(data.astype(np.uint8), (B,) + data.shape).copy()
    locis = np.broadcast_to(loci, (B, N)).copy()
    t0 = time.perf_counter()
    Ts = segment_exact_device_batch(datas, locis, W, MAX_BP, PC, batch=B)
    log(f"cold (compile + table + h2d): {time.perf_counter() - t0:.3f} s")
    ts = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        Ts = segment_exact_device_batch(datas, locis, W, MAX_BP, PC, batch=B)
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    log(f"f64 batch B={B}: {dt * 1e3:.1f} ms total, {dt / B * 1e3:.2f} "
        f"ms/window median of {TRIALS} (incl. h2d + traceback d2h)")
    t0 = time.perf_counter()
    T_host = segment_exact_native(data, loci, W, MAX_BP, PC)
    log(f"host C++ one window (1 thread): {time.perf_counter() - t0:.3f} s")
    same = all(np.array_equal(T, T_host) for T in Ts)
    # zero coverage over a stretch: all-tie candidates, resolved by index
    tie = data.copy()
    tie[:, 20_000:30_000] = 0
    T_dev = segment_exact_device_batch(tie[None], loci[None], W, MAX_BP, PC,
                                       batch=1)[0]
    same_tie = np.array_equal(
        T_dev, segment_exact_native(tie, loci, W, MAX_BP, PC))
    log(f"f64 traceback bit-identical to C++: {same}; with zero-coverage "
        f"ties: {same_tie}")
    print(json.dumps({"window_ms": dt / B * 1e3, "batch_ms": dt * 1e3,
                      "identical": same, "identical_ties": same_tie}))
    return 0 if same and same_tie else 1


def part_take():
    """jnp.take of the cost build's ll-table indices: per row i and band
    column k, idx = tri(nt) + nm of the band totals (non-increasing along
    the band, as the cost build reads them)."""
    import jax
    import jax.numpy as jnp

    W, cap = 1024, 2048
    T = cap * (cap + 1) // 2
    rng = np.random.default_rng(0)
    tbl = rng.random(T).astype(np.float32)
    cov = rng.poisson(COV, size=N).astype(np.int64)
    meth = rng.binomial(cov, 0.7).astype(np.int64)
    pt = np.concatenate([[0], np.cumsum(cov)])
    pm = np.concatenate([[0], np.cumsum(meth)])
    i_row = np.arange(N)[:, None]
    kc = np.clip(i_row - (W - 1) + np.arange(W)[None, :], 0, None)
    nt = pt[i_row + 1] - pt[kc]
    nm = pm[i_row + 1] - pm[kc]
    ok = nt < cap
    idx = np.where(ok, nt * (nt + 1) // 2 + nm, 0).astype(np.int32)
    d_tbl, d_idx = jnp.asarray(tbl), jnp.asarray(idx)
    take = jax.jit(jnp.take)
    take(d_tbl, d_idx).block_until_ready()
    ts = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        take(d_tbl, d_idx).block_until_ready()
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    M = idx.size
    log(f"take: {M:,} lookups into {T:,} entries ({100 * ok.mean():.1f}% "
        f"in band): {dt * 1e3:.3f} ms median of {TRIALS}, "
        f"{M / dt / 1e9:.2f} G elem/s")
    print(json.dumps({"take_ms": dt * 1e3, "lookups": M}))
    return 0


def part_gate(gate, betas, out, refdir):
    """Two exact segment runs in this fresh process, DP on the card, with
    windows under `gate` sites on the host."""
    from wgbs_tools_tpu.cli.main import main
    from wgbs_tools_tpu.models import segment

    os.environ["WGBS_TPU_REFDIR"] = refdir
    os.environ["WGBS_TPU_SEGMENT_EXACT_DEVICE"] = "1"
    segment.DEVICE_EXACT_MIN_SITES = gate
    ts = []
    for _ in range(2):
        t0 = time.perf_counter()
        if main(["segment", "--betas", *betas, "--genome", "chrsim",
                 "-o", out]):
            return 1
        ts.append(time.perf_counter() - t0)
    log(f"gate={gate} segment exact 2,500,000 sites: first {ts[0]:.2f} s, "
        f"second {ts[1]:.2f} s")
    print(json.dumps({"gate": gate, "first_s": ts[0], "second_s": ts[1]}))
    return 0


def child(argv):
    r = subprocess.run([sys.executable, op.abspath(__file__), *argv])
    if r.returncode:
        raise SystemExit(f"bench_exact: part {argv} exited {r.returncode}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="window,take,gate",
                    help="comma-separated subset of window,take,gate")
    ap.add_argument("--part", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gate", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--betas", nargs="*", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--refdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    from wgbs_tools_tpu.cli.main import ensure_compile_cache

    ensure_compile_cache()
    if args.part:
        from wgbs_tools_tpu.device import require_gpu

        require_gpu("bench_exact")
        if args.part == "window":
            return part_window()
        if args.part == "take":
            return part_take()
        return part_gate(args.gate, args.betas, args.out, args.refdir)

    from wgbs_tools_tpu.device import card_lines

    lines = card_lines()
    if not lines:
        print("bench_exact: no GPU (nvidia-smi found no card)",
              file=sys.stderr)
        return 1
    log(f"card: {lines[0]}")
    parts = args.parts.split(",")
    for p in ("window", "take"):
        if p in parts:
            child(["--part", p])
    if "gate" in parts:
        import chip_smoke

        with tempfile.TemporaryDirectory(prefix="bench_exact_") as td:
            refdir = op.join(td, "refs")
            os.environ["WGBS_TPU_REFDIR"] = refdir
            betas = chip_smoke.make_segment_data(td, 0, 2_500_000)
            outs = []
            # on, off, off, on: the first of each side meets the compile
            # cache as the previous runs left it
            for i, gate in enumerate((4096, 2, 2, 4096)):
                outs.append(op.join(td, f"blocks{i}.bed"))
                child(["--part", "gate", "--gate", str(gate), "--betas",
                       *betas, "--out", outs[-1], "--refdir", refdir])
            same = all(chip_smoke.same_bytes(outs[0], o) for o in outs[1:])
            log(f"gate on/off blocks byte-identical: {same}")
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
