"""Exact-parity segmentation DP on the device (ll table + IEEE doubles).

The reference segmentor's borders depend on an exact chain of float32/
float64 roundings (ref: src/segment_betas/segmentor.cpp:60-159): per-dataset
log-likelihoods rounded to float32, the dataset sum and DP maximization in
IEEE float64 with strict-'>' first-argmax ties. A plain-f32 device DP only
reaches ~95-97% border agreement, so this module reproduces the chain:

  1. The per-dataset likelihood is a pure function of the integer pair
     (nmeth, ntotal) (the host memo of native/segment_exact.cpp:33-43). The
     HOST builds a triangular float32 table of every ll(nm, nt) with the
     reference rounding chain (numpy float32/float64, byte-identical to the
     C++ and the reference by the oracle tests), sized to the largest
     in-band total of the window.
  2. The DEVICE computes band counts as int32 prefix-sum differences
     (Hankel skews), looks ll values up in the table (`jnp.take`), and
     performs the float64 dataset summation and the DP max/argmax in native
     IEEE float64 (under a scoped `jax.enable_x64`). The chain has adds
     only, so no fused multiply-add can change a rounding; the dataset sum
     is a sequential scan, so XLA cannot reorder it; `argmax` keeps the
     first maximum. Every rounding and tie-break equals the host chain.

Windows whose in-band totals exceed the table cap (coverage*band beyond
`WGBS_TPU_LL_CAP`, default 8192 -> a 134 MB table) or whose loci are not
monotone fall back to the host path — the caller treats a None return as
"use native/numpy".
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .segment import _hankel

LL_CAP = int(os.environ.get("WGBS_TPU_LL_CAP", 8192))

_TABLE_CACHE = {}
_DEV_TABLE_CACHE = {}


def _device_table(pc, tbl):
    """Device-resident copy of the host ll table (one resident at a time,
    reused across windows and batches)."""
    key = (float(pc), tbl.shape[0])
    hit = _DEV_TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    arr = jnp.asarray(tbl)
    _DEV_TABLE_CACHE.clear()
    _DEV_TABLE_CACHE[key] = arr
    return arr


def build_ll_table(pc, cap):
    """Host-side float32 table of ll(nm, nt) for 0 <= nm <= nt < cap,
    triangular-flat at index nt*(nt+1)//2 + nm, with the reference's exact
    rounding chain (matches _cost_block_exact / segment_exact.cpp)."""
    # the triangular-flat layout is cap-independent (entries for nt < cap'
    # sit at identical indices in any larger table), so a cached table for
    # the same pc and any cap' >= cap is reusable as-is — per-window cap
    # variation must not rebuild a hundreds-of-MB table per window
    for (c_pc, c_cap), tbl in _TABLE_CACHE.items():
        if c_pc == float(pc) and c_cap >= cap:
            return tbl
    nt = np.repeat(np.arange(cap, dtype=np.int64),
                   np.arange(1, cap + 1, dtype=np.int64))
    size = nt.shape[0]
    nm = np.arange(size, dtype=np.int64) - (nt * (nt + 1)) // 2
    pc32 = np.float32(pc)
    nm32 = nm.astype(np.float32)
    nt32 = nt.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        p32 = (nm32 + pc32) / (nt32 + np.float32(2) * pc32)
        p64 = p32.astype(np.float64)
        t1 = np.where(p32 > 0, nm32.astype(np.float64) * np.log2(p64), 0.0)
        ll = (np.zeros(size, np.float32).astype(np.float64) + t1).astype(
            np.float32)
        t2 = np.where(p32 < 1,
                      (nt32 - nm32).astype(np.float64) * np.log2(1.0 - p64),
                      0.0)
        ll = (ll.astype(np.float64) + t2).astype(np.float32)
    ll = np.where(nt32 == 0, np.float32(0), ll)
    _TABLE_CACHE.clear()  # one table resident at a time (134 MB at the cap)
    _TABLE_CACHE[(float(pc), int(cap))] = ll
    return ll


def max_band_width(loci, W, max_bp):
    """Largest number of in-band candidate predecessors of any site — the
    effective DP window. The reference's max_bp cap (segmentor.cpp band)
    typically bounds this to ~an eighth of max_cpg at WGBS spacing, so
    clipping the device cost build and DP to it cuts both the table
    gathers and the scan work by the same factor (the host C++ DP already
    band-prunes — this is the device analogue). Exactness: every cell
    dropped by the clip has loci-distance > max_bp, i.e. was already
    masked out of the max/argmax in the full-width build."""
    if not max_bp:
        return int(W)
    loci = np.asarray(loci, dtype=np.int64)
    klo = np.searchsorted(loci, loci - max_bp, side="left")
    width = np.arange(loci.shape[0], dtype=np.int64) - klo + 1
    return int(min(max(int(width.max(initial=1)), 1), W))


def _round_width(bw):
    """Pad the band width to a multiple of 128 (min 128), so windows of
    similar spacing share one compiled shape."""
    return max((bw + 127) // 128 * 128, 128)


def max_band_total(data, loci, W, max_bp):
    """Largest in-band (nm <= nt) total of any candidate block — the table
    size the device kernel needs. Host-side, int64, monotone loci only."""
    pt = np.cumsum(np.asarray(data, dtype=np.int64)[:, :, 1], axis=1)
    pt = np.concatenate([np.zeros((pt.shape[0], 1), np.int64), pt], axis=1)
    n = loci.shape[0]
    if max_bp:
        hi = np.searchsorted(loci, loci + max_bp, side="right")
    else:
        hi = np.full(n, n, dtype=np.int64)
    hi = np.minimum(np.maximum(hi, np.arange(n) + 1), np.arange(n) + W)
    hi = np.minimum(hi, n)
    return int((pt[:, hi] - pt[:, :n]).max(initial=0))


def _exact_cost_body(pm, pt, loci, tbl, W, max_bp):
    """float64 (n, W) cost rows in ascending-k order (C[i, v] = cost of
    block [k..i], k = i-W+1+v) plus the validity mask (k >= 0 and within
    the max_bp band). Traced under x64."""
    n = loci.shape[0]
    K = pm.shape[0]
    j_col = jnp.arange(W, dtype=jnp.int32)[None, :]
    i_row = jnp.arange(n, dtype=jnp.int32)[:, None]
    valid = (i_row - (W - 1) + j_col) >= 0  # k >= 0

    def window_vals(vec, fill):
        pad = jnp.full(W - 1, fill, dtype=vec.dtype)
        return _hankel(jnp.concatenate([pad, vec]), n, W)

    if max_bp:
        lk = window_vals(loci, loci[0])
        ok = valid & ((loci[:, None] - lk) <= max_bp)
    else:
        ok = valid

    def ll_f64(d):
        # int32 prefix-sum differences: wraparound-safe (in-band totals
        # < 2^31 even when the full-window cumsum wraps)
        nm = pm[d, 1 : n + 1][:, None] - window_vals(pm[d, : n + 1], 0)
        nt = pt[d, 1 : n + 1][:, None] - window_vals(pt[d, : n + 1], 0)
        use = ok & (nt > 0)
        ntc = jnp.where(use, nt, 0)
        nmc = jnp.where(use, nm, 0)
        idx = ntc * (ntc + 1) // 2 + nmc
        ll = jnp.where(use, jnp.take(tbl, idx), jnp.float32(0))
        return ll.astype(jnp.float64)  # f32 -> f64 widening is exact

    # dataset 0 seeds the accumulator exactly (0.0 + v == v in IEEE for
    # v != -0, and ll is never -0); the rest add in dataset order
    c0 = ll_f64(0)
    if K > 1:
        C, _ = jax.lax.scan(lambda acc, d: (acc + ll_f64(d), None), c0,
                            jnp.arange(1, K, dtype=jnp.int32))
    else:
        C = c0
    return C, ok


def _dp_exact_batched_ring(C_t, ok_t, W, unroll=8):
    """Sequential DP over site-major (n, B, W) float64 cost rows; returns
    ks (B, n) int32 with ks[b, i] = argmax predecessor (first maximum,
    ascending k — the reference's strict-'>' scan order).

    The carry is a (B, W + unroll) ring of M values advanced by a STATIC
    shift, so window reads and the new-value writes sit at static offsets.
    Window cells with k < 0 hold +0.0 and are masked out by `ok` exactly as
    the reference's band check skips them. Padding steps past n emit
    discarded ks."""
    n, B, _ = C_t.shape
    n_pad = -(-n // unroll) * unroll
    if n_pad != n:
        pad = ((0, n_pad - n), (0, 0), (0, 0))
        C_t = jnp.pad(C_t, pad)
        ok_t = jnp.pad(ok_t, pad)
    ring0 = jnp.zeros((B, W + unroll), jnp.float64)
    rows = jnp.arange(B)

    def step(ring, xs):
        i0, cs, oks = xs  # cs: (unroll, B, W)
        outs = []
        for u in range(unroll):
            cand = jax.lax.slice(ring, (0, u), (B, u + W)) + cs[u]
            cand = jnp.where(oks[u], cand, -jnp.inf)
            am = jnp.argmax(cand, axis=1).astype(jnp.int32)
            ring = ring.at[:, W + u].set(cand[rows, am])
            outs.append((i0 + u) - (W - 1) + am)
        ring = jnp.concatenate(
            [ring[:, unroll:], jnp.zeros((B, unroll), jnp.float64)], axis=1)
        return ring, jnp.stack(outs)  # (unroll, B)

    _, ks = jax.lax.scan(
        step, ring0,
        (jnp.arange(0, n_pad, unroll, dtype=jnp.int32),
         C_t.reshape(-1, unroll, B, W), ok_t.reshape(-1, unroll, B, W)))
    return ks.reshape(-1, B).T[:, :n]  # (B, n)


@partial(jax.jit, static_argnames=("W", "max_bp"))
def _exact_batch_ring(pm, pt, loci, tbl, W, max_bp):
    """Batched cost+DP: vmapped cost build -> site-major transpose -> one
    ring-buffer DP scan over all B windows."""
    C, ok = jax.vmap(
        lambda a, b, c: _exact_cost_body(a, b, c, tbl, W, max_bp))(
            pm, pt, loci)
    return _dp_exact_batched_ring(jnp.moveaxis(C, 0, 1),
                                  jnp.moveaxis(ok, 0, 1), W)


@partial(jax.jit, static_argnames=("W", "max_bp"))
def _exact_batch_ring_raw(data, loci, tbl, W, max_bp):
    """As _exact_batch_ring but fed the RAW (B, K, n, 2) count tensor:
    the wraparound prefix sums run on the device (int32 cumsum wraps mod
    2^32 exactly like the host's int64-then-mask chain), so only the narrow
    count bytes cross to the device."""
    d32 = data.astype(jnp.int32)
    ps = jnp.concatenate(
        [jnp.zeros((d32.shape[0], d32.shape[1], 1, 2), jnp.int32),
         jnp.cumsum(d32, axis=2, dtype=jnp.int32)], axis=2)
    return _exact_batch_ring(ps[..., 0], ps[..., 1], loci, tbl, W, max_bp)


def segment_exact_device_batch(datas, locis, W, max_bp, pseudo_count,
                               cap_limit=None, batch=16):
    """Batched device exact DP over equal-size windows.

    datas: (B, K, n, 2) int counts; locis: (B, n). Returns a list of B
    traceback arrays (n+1,) — entries are None for windows the device path
    cannot take (non-monotone loci / totals past the table cap); the caller
    runs those on the host. Windows run `batch` at a time with a fixed
    launch shape (tail padded by repeating the first window) through the
    site-major ring-buffer DP (_dp_exact_batched_ring), whose sequential
    per-site steps amortize across the batch. All launches are queued
    before the first fetch.
    """
    datas = np.asarray(datas)
    locis = np.asarray(locis, dtype=np.int64)
    B, K, n, _ = datas.shape
    res = [None] * B
    if n < 2:
        return res
    cap_limit = LL_CAP if cap_limit is None else cap_limit
    elig, need_max = [], 0
    for w in range(B):
        loci = locis[w]
        if (np.diff(loci) < 0).any() or loci.max(initial=0) >= 1 << 31:
            continue
        need = max_band_total(datas[w], loci, W, max_bp) + 1
        if need > cap_limit:
            continue
        elig.append(w)
        need_max = max(need_max, need)
    if not elig:
        return res
    cap = 1 << max(int(need_max - 1).bit_length(), 6)
    # band clip: every candidate farther than max_bp is masked anyway, so
    # both the cost build and the DP shrink to the real band width
    Wb = min(W, _round_width(max(
        max_band_width(locis[w], W, max_bp) for w in elig)))
    # ship the counts in their narrow on-disk dtype; the wraparound prefix
    # sums run on the device (_exact_batch_ring_raw)
    ship = datas if datas.dtype.itemsize <= 4 else datas.astype(np.int32)
    outs = []
    with jax.enable_x64(True):
        tbl = _device_table(pseudo_count, build_ll_table(pseudo_count, cap))
        for lo in range(0, len(elig), batch):
            sel = elig[lo : lo + batch]
            padded = sel + [sel[0]] * (batch - len(sel))
            outs.append((sel, _exact_batch_ring_raw(
                jnp.asarray(ship[padded]),
                jnp.asarray(locis[padded], dtype=jnp.int32), tbl, Wb,
                int(max_bp) if max_bp else 0)))
        for sel, ks in outs:
            ks = np.asarray(ks)
            for j, w in enumerate(sel):
                T = np.empty(n + 1, dtype=np.int64)
                T[0] = 0
                T[1:] = ks[j]
                res[w] = T
    return res


def segment_exact_device_T(data, loci, W, max_bp, pseudo_count,
                           cap_limit=None):
    """Device exact-parity traceback for one window, or None when the
    window is ineligible (non-monotone loci / in-band totals past the
    table cap) — the caller then uses the host path.

    Returns T (n+1,) int64 identical to native segment_exact_dp's output.
    """
    return segment_exact_device_batch(
        np.asarray(data)[None], np.asarray(loci)[None], W, max_bp,
        pseudo_count, cap_limit=cap_limit, batch=1)[0]
