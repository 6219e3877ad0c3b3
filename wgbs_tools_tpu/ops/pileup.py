"""Pileup: pat fragments -> per-CpG (meth, cov) counts.

This is the pat2beta hot loop. The reference streams pat text through a C++
accumulator one line at a time (ref: src/pat2beta/stdin2beta.cpp:59-93):
cov[site] += count for calls in {C,T,H}, meth[site] += count for {C,H}.

Here fragments are dense device arrays and the pileup is a batched XLA
scatter-add over the CpG axis (`pileup_xla`); on a GPU the int32 `.at[].add`
lowers to native atomics, so the counts stay bit-identical to the integer
reference. Without a GPU, `PileupAccumulator` runs the host C++ kernel
(native/wgbsio.cpp::pat_pileup). Both operate on a window
[window_start, window_start + window_len) of 1-based global CpG indices.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..device import has_gpu
from ..formats.beta import trim_to_uint
from ..formats.pat import CODE_C, CODE_DOT, CODE_H, PatFrags

DEFAULT_BATCH = 1 << 20


def _bucket(n, lo):
    """Smallest power of two >= max(n, lo): launch shapes come from a small
    set, so streaming chunks of varying size reuse a few compiled steps."""
    b = lo
    while b < n:
        b <<= 1
    return b


@partial(jax.jit, static_argnames=("window_len",))
def _pileup_batch_xla(start_rel, length, count, codes, window_len):
    """Scatter-add one fragment batch into a (window_len, 2) count table.

    start_rel: int32[F] fragment start relative to window (may be negative
    for fragments overlapping the left edge).
    codes: uint8[F, L].
    """
    F, L = codes.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    site = start_rel[:, None] + pos
    in_read = pos < length[:, None]
    in_window = (site >= 0) & (site < window_len)
    observed = in_read & in_window & (codes != CODE_DOT)
    meth_call = (codes == CODE_C) | (codes == CODE_H)

    cnt = count[:, None]
    cov_val = jnp.where(observed, cnt, 0)
    meth_val = jnp.where(observed & meth_call, cnt, 0)

    # out-of-window positions scatter to a dropped overflow row
    site_clipped = jnp.where(in_window, site, window_len)

    flat_sites = site_clipped.reshape(-1)
    out = jnp.zeros((window_len + 1, 2), dtype=jnp.int32)
    out = out.at[flat_sites, 0].add(meth_val.reshape(-1), mode="drop")
    out = out.at[flat_sites, 1].add(cov_val.reshape(-1), mode="drop")
    return out[:window_len]


def pileup_xla(start, length, count, codes, window_start, window_len,
               batch=DEFAULT_BATCH, to_host=True):
    """Host-orchestrated pileup over fragment batches.

    start: int32[F] 1-based global CpG start indices.
    Returns int32 (window_len, 2) [meth, cov] — numpy if `to_host`, else a
    device array (for callers that keep a device-resident running total).
    Each batch is padded to a power-of-two fragment count and code width
    (padding rows have length 0 and add nothing).
    """
    start = np.asarray(start)
    length = np.asarray(length)
    count = np.asarray(count)
    codes = np.asarray(codes)
    F = start.shape[0]
    L = codes.shape[1] if codes.ndim == 2 else 0
    Lb = _bucket(L, 8)
    total = None
    for lo in range(0, F, batch):
        hi = min(lo + batch, F)
        n = hi - lo
        Fb = min(_bucket(n, 1 << 12), max(batch, n))
        st = np.zeros(Fb, np.int32)
        st[:n] = start[lo:hi] - window_start
        ln = np.zeros(Fb, np.int32)
        ln[:n] = length[lo:hi]
        cn = np.zeros(Fb, np.int32)
        cn[:n] = count[lo:hi]
        cd = np.full((Fb, Lb), CODE_DOT, np.uint8)
        cd[:n, :L] = codes[lo:hi]
        res = _pileup_batch_xla(jnp.asarray(st), jnp.asarray(ln),
                                jnp.asarray(cn), jnp.asarray(cd), window_len)
        total = res if total is None else total + res
    if total is None:
        total = jnp.zeros((window_len, 2), dtype=jnp.int32)
    return np.asarray(total) if to_host else total


class PileupAccumulator:
    """Streaming single-device pileup: fold PatFrags batches into a
    (window_len, 2) count table with bounded per-batch work.

    pat files are sorted by startCpG, so each streaming chunk covers a
    contiguous slice of the site axis; every batch piles up over its local
    span only (padded to a power-of-two bucket to bound recompiles) and adds
    into the host total. The multi-device counterpart is
    parallel.sharded.ShardedPileup; both produce counts bit-identical to a
    one-shot pileup (integer adds commute).
    """

    def __init__(self, window, backend="auto", batch=DEFAULT_BATCH,
                 min_span=1 << 16, device_total=None):
        import os

        self.window = window
        self.n = window[1] - window[0]
        if backend == "auto":
            # env override applies only to unspecified backends so explicit
            # A/B comparisons (tests, benchmarks) stay meaningful
            backend = os.environ.get("WGBS_TPU_PILEUP") or "auto"
        gpu = has_gpu()
        if backend == "auto":
            if gpu or device_total:
                backend = "xla"
            else:
                # no GPU: the C++ host kernel beats the XLA-CPU scatter and
                # skips staging entirely (bit-identical — integer adds)
                from ..native import get_lib

                backend = "native" if get_lib() is not None else "xla"
        if backend not in ("xla", "native"):
            raise ValueError(f"unknown pileup backend: {backend}")
        self.backend = backend
        self.batch = batch
        self.min_span = min_span
        if device_total is None:
            device_total = gpu
        self.device_total = bool(device_total) and backend != "native"
        if self.device_total:
            # running total stays in device memory; add() folds each batch
            # in place (donated buffer) and only finalize()/result() cross
            # back to the host.
            self.total = jnp.zeros((self.n, 2), dtype=jnp.int32)
        else:
            self.total = np.zeros((self.n, 2), dtype=np.int64)

    def add(self, frags: PatFrags):
        s, e = self.window
        sel = frags.slice_sites(s, e, min_overlap=1) if frags.nr_frags \
            else frags
        if sel.nr_frags == 0:
            return
        if self.backend == "native":
            import os

            from ..native import pileup_native

            st = np.asarray(sel.start)
            thr = (min(os.cpu_count() or 1, 8)
                   if st.size < 2 or np.all(np.diff(st) >= 0) else 1)
            if pileup_native(st, sel.length, sel.count, sel.codes, s,
                             self.n, out=self.total, threads=thr) is not None:
                return
            self.backend = "xla"  # library unavailable: host XLA scatter
        lo = max(int(sel.start.min()), s)
        hi = min(int((sel.start.astype(np.int64) + sel.length).max()), e)
        n_pad = min(_bucket(max(hi - lo, 1), self.min_span), self.n)
        lo = min(lo, e - n_pad)
        res = pileup_xla(sel.start, sel.length, sel.count, sel.codes, lo,
                         n_pad, batch=self.batch,
                         to_host=not self.device_total)
        if self.device_total:
            self.total = _fold_at(self.total, jnp.asarray(res),
                                  np.int32(lo - s))
        else:
            self.total[lo - s : lo - s + n_pad] += res

    def result(self):
        """Raw int count table (host numpy)."""
        if self.device_total:
            return fetch_chunked(self.total).astype(np.int64)
        return self.total

    def finalize(self, lbeta=False):
        """Saturated uint8/uint16 (n, 2) beta array, exact reference
        semantics (ref: utils_wgbs.py:277-290).

        On a device total, the saturation runs on the device and only the
        (4x smaller) uint8 table plus the rare coverage-overflow rows cross
        back to the host — the overflow rows are re-saturated there with the
        reference's float64 chain, so the result is byte-identical to
        trim_to_uint of the full counts.
        """
        if not self.device_total:
            return trim_to_uint(self.total, lbeta)
        return saturate_device_counts(self.total, lbeta)


@partial(jax.jit, donate_argnums=0)
def _fold_at(total, res, off):
    """total[off : off + res.shape[0]] += res, in place (donated)."""
    cur = jax.lax.dynamic_slice(total, (off, 0), res.shape)
    return jax.lax.dynamic_update_slice(total, cur + res, (off, 0))


@partial(jax.jit, static_argnames=("max_val", "cap", "out_dtype"))
def _saturate_compact(total, max_val, cap, out_dtype):
    """Device saturation + compaction of coverage-overflow rows.

    Rows with cov <= max_val are exact as-is; rows with cov > max_val are
    zeroed in the output and their (site, meth, cov) triples compacted into
    a fixed-cap buffer for exact host-side re-saturation.
    """
    meth = total[:, 0]
    cov = total[:, 1]
    big = cov > max_val
    out = jnp.stack(
        [jnp.where(big, 0, meth), jnp.minimum(cov, max_val)], axis=1
    ).astype(out_dtype)
    nbig = jnp.sum(big, dtype=jnp.int32)
    pos = jnp.cumsum(big, dtype=jnp.int32) - 1
    tgt = jnp.where(big, pos, cap)  # non-big rows land on the spare row
    sites = jnp.arange(total.shape[0], dtype=jnp.int32)
    buf = jnp.zeros((cap + 1, 3), jnp.int32)
    buf = buf.at[tgt, 0].set(sites, mode="drop")
    buf = buf.at[tgt, 1].set(meth, mode="drop")
    buf = buf.at[tgt, 2].set(cov, mode="drop")
    return out, nbig, buf[:cap]


def saturate_device_counts(total, lbeta=False, cap=1 << 20,
                           fetch_bytes=8 << 20):
    """Device int32 (n, 2) counts -> host saturated uint8/uint16 beta,
    byte-identical to trim_to_uint(counts) with bounded d2h traffic."""
    max_val = 65535 if lbeta else 255
    dt = jnp.uint16 if lbeta else jnp.uint8
    out, nbig, buf = _saturate_compact(total, max_val, cap, dt)
    nbig = int(nbig)
    if nbig > cap:
        # more overflow rows than the compaction buffer: fall back to an
        # exact host pass over the full counts (pathological input)
        return trim_to_uint(fetch_chunked(total).astype(np.int64), lbeta)
    beta = fetch_chunked(out, max_bytes=fetch_bytes)
    if nbig:
        k = 1
        while k < nbig:
            k <<= 1
        rows = np.asarray(buf[:k])[:nbig]
        beta[rows[:, 0]] = trim_to_uint(rows[:, 1:3].astype(np.int64), lbeta)
    return beta


def fetch_chunked(x, max_bytes=8 << 20):
    """Device -> host fetch in bounded row slabs into one preallocated
    host array (one compiled slice shape serves all full slabs)."""
    x_np = np.empty(x.shape, np.dtype(x.dtype.name))
    row_bytes = max(int(x_np.itemsize * np.prod(x.shape[1:], initial=1)), 1)
    step = max(int(max_bytes) // row_bytes, 1)
    n = x.shape[0]
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        if hi - lo == step:
            sl = jax.lax.dynamic_slice_in_dim(x, lo, step, axis=0)
        else:
            sl = x[lo:hi]
        x_np[lo:hi] = np.asarray(sl)
    return x_np


def pileup_frags(frags: PatFrags, window, batch=DEFAULT_BATCH, **kw):
    """Pileup a PatFrags batch over a 1-based [s, e) site window with the
    XLA scatter. to_host=False returns a device array; `batch` bounds the
    per-launch fragment count."""
    s, e = window
    sel = frags.slice_sites(s, e, min_overlap=1) if frags.nr_frags else frags
    return pileup_xla(sel.start, sel.length, sel.count, sel.codes, s, e - s,
                      batch=batch, **kw)
