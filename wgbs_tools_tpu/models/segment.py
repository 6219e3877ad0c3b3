"""Change-point segmentation of beta files into homogeneously-methylated blocks.

The reference implements this as a single-core C++ DP over 60k-site chunks
(ref: src/segment_betas/segmentor.cpp:60-159) orchestrated by a Python Pool
with overlap-patch stitching (ref: src/python/segment.py). The DP:

    M[i+1] = max_{k in [i+1-max_cpg, i]} M[k] + cost(k, i)
    cost(k, i) = sum_d  nm*log2(p) + (nt-nm)*log2(1-p),
                 p = (nm + pc) / (nt + 2*pc)  over sites k..i of dataset d
    blocks longer than max_bp basepairs get cost -inf

Key numeric facts (ref: segmentor.cpp:76-137): nmeth/ntotal accumulate in
float32 — but they are integer-valued and < 2^24, so float32 accumulation is
exact and equals a difference of int prefix sums. log2 runs in float64, the
per-dataset log-likelihood is rounded to float32 twice, and the dataset sum /
DP maximization run in float64 with first-argmax tie-breaking.

Two implementations:
- `segment_borders(..., mode="exact")`: numpy emulation of the reference's
  exact rounding chain — byte-identical block borders.
- `segment_borders(..., mode="fast")`: float32 JAX device path — the cost
  tensor is embarrassingly parallel (computed from prefix sums for all
  (end, width) pairs at once) and the sequential part is a lax.scan over
  sites with a max_cpg-wide vector max per step.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.beta import load_beta
from ..utils import IllegalArgumentError

DEF_CHUNK = 60000  # ref: segment.py:21
NEG_INF = np.float64(-np.inf)


# ---------------------------------------------------------------------------
# Exact-parity cost + DP (numpy, float32/float64 rounding chain emulation)
# ---------------------------------------------------------------------------


def _prefix_sums(data):
    """data: (K, n, 2) int -> meth/total prefix sums (K, n+1) int64."""
    data = np.asarray(data, dtype=np.int64)
    ps = np.zeros((data.shape[0], data.shape[1] + 1, 2), dtype=np.int64)
    np.cumsum(data, axis=1, out=ps[:, 1:])
    return ps[:, :, 0], ps[:, :, 1]


_LL_MEMO = {}  # (float(pc32), nm, nt) -> float32 ll (mirrors the C++ LLMemo)


def _ll_pair_scalar(nm, nt, pc32):
    """One (nm, nt) log-likelihood through the reference float chain with
    libm log2 (math.log2 calls the platform log2, the same function the
    native kernel and the reference use — numpy's SIMD np.log2 can differ
    by 1 ulp, which flips near-tie DP borders; that 1-ulp gap is why this
    is scalar). Mirrors segment_exact.cpp::ll_direct / segmentor.cpp float
    chain: float32 p, double log2, per-term float32 rounding."""
    import math

    p = (np.float32(nm) + pc32) / (np.float32(nt) + np.float32(2) * pc32)
    pd = float(p)
    ll = np.float32(0.0)
    if pd > 0.0:
        ll = np.float32(float(ll) + float(np.float32(nm)) * math.log2(pd))
    if pd < 1.0:
        ll = np.float32(
            float(ll)
            + float(np.float32(nt) - np.float32(nm)) * math.log2(1.0 - pd))
    return ll


def _ll_lookup(nm_i, nt_i, pc32):
    """Vector ll over integer count arrays via a unique-pair memo."""
    keys = (nt_i.astype(np.int64) << 25) | nm_i.astype(np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    pck = float(pc32)
    vals = np.empty(uniq.shape[0], dtype=np.float32)
    for u, kk in enumerate(uniq):
        nt = int(kk) >> 25
        nm = int(kk) & ((1 << 25) - 1)
        memo_key = (pck, nm, nt)
        v = _LL_MEMO.get(memo_key)
        if v is None:
            v = _ll_pair_scalar(nm, nt, pc32)
            if len(_LL_MEMO) < (1 << 22):  # bounded
                _LL_MEMO[memo_key] = v
        vals[u] = v
    return vals[inv].reshape(nm_i.shape)


def _cost_block_exact(pm, pt, loci, i_lo, i_hi, W, max_bp, pc):
    """Exact cost rows C[i, w] = cost of block [i-w .. i] for i in [i_lo,i_hi).

    Emulates segmentor.cpp:103-137's float chain; returns float64 (B, W).
    Bit-identical to the native kernel (tested in test_segment.py) — the
    log2 evaluations go through libm via _ll_pair_scalar, not np.log2.
    """
    K = pm.shape[0]
    I = np.arange(i_lo, i_hi, dtype=np.int64)[:, None]  # (B, 1)
    Wv = np.arange(W, dtype=np.int64)[None, :]  # (1, W)
    Kk = I - Wv  # block start index (B, W)
    valid = Kk >= 0
    Kc = np.where(valid, Kk, 0)

    pc32 = np.float32(pc)
    ll_sum = np.zeros(Kc.shape, dtype=np.float64)
    for d in range(K):  # sequential dataset accumulation (matches C loop order)
        nm_i = pm[d][I + 1] - pm[d][Kc]
        nt_i = pt[d][I + 1] - pt[d][Kc]
        ll_k = _ll_lookup(nm_i, nt_i, pc32)
        ll_k = np.where(nt_i == 0, np.float32(0), ll_k)  # skipped datasets
        ll_sum += ll_k.astype(np.float64)

    row = np.where(ll_sum == 0.0, 0.0, ll_sum)
    if max_bp:
        dist = loci[np.minimum(I, loci.shape[0] - 1)] - loci[Kc]
        row = np.where(dist > max_bp, NEG_INF, row)
    row = np.where(valid, row, NEG_INF)
    return row


def _cost_exact_literal(data, loci, W, max_bp, pc):
    """Literal reference cost semantics for NON-MONOTONE loci (windows
    spanning a chromosome boundary): the dist test may pass again after
    failing, and skipped sites are NOT absorbed into the running counts
    (ref: segmentor.cpp:112-117; native/segment_exact.cpp non-monotone
    branch). The prefix-sum form in _cost_block_exact absorbs every site
    unconditionally, which diverges here — so these windows take this
    scalar per-cell build instead (rare: production ranges are
    per-chromosome, only direct API calls can span).

    Returns C (n, W) float64 with C[i, w] = cost of block [i-w..i]
    (the _dp_exact layout: C[k + j, j] = cost row k, offset j)."""
    dat = np.asarray(data, dtype=np.int64)
    K, n, _ = dat.shape
    pc32 = np.float32(pc)
    pck = float(pc32)
    C = np.full((n, W), NEG_INF)
    for k in range(n):
        nm = [0] * K
        nt = [0] * K
        window = min(W, n - k)
        for j in range(window):
            if max_bp and (loci[k + j] < loci[k]
                           or loci[k + j] - loci[k] > max_bp):
                continue  # cell stays -inf; counts not absorbed
            s = 0.0
            for d in range(K):
                nm[d] += int(dat[d, k + j, 0])
                nt[d] += int(dat[d, k + j, 1])
                if nt[d] == 0:
                    continue
                key = (pck, nm[d], nt[d])
                v = _LL_MEMO.get(key)
                if v is None:
                    v = _ll_pair_scalar(nm[d], nt[d], pc32)
                    if len(_LL_MEMO) < (1 << 22):
                        _LL_MEMO[key] = v
                s += float(v)
            C[k + j, j] = s if s != 0.0 else 0.0
    return C


def _dp_exact(C):
    """Sequential DP over exact cost rows. C: (n, W) float64.

    Returns traceback array T (n+1,) int64 (T[0] unused).
    """
    n, W = C.shape
    M = np.zeros(n + 1, dtype=np.float64)
    T = np.full(n + 1, -1, dtype=np.int64)
    for i in range(n):
        k0 = max(0, i + 1 - W)
        # candidates ordered by ascending k; cand[j] = M[k0+j] + C[i, i-(k0+j)]
        w_hi = i - k0  # width for k = k0
        cand = M[k0 : i + 1] + C[i, w_hi::-1]
        am = int(np.argmax(cand))  # first max, matching the strict '>' scan
        best = cand[am]
        if np.isneginf(best):
            # C init: best stays -inf and best_ind stays -1
            M[i + 1] = NEG_INF
            T[i + 1] = -1
        else:
            M[i + 1] = best
            T[i + 1] = k0 + am
    return T


def _traceback(T, n):
    """ref: segmentor.cpp:50-58 — borders ascending, endpoints included."""
    borders = [n]
    i = n
    while i > 0:
        i = max(0, int(T[i]))
        borders.append(i)
    return np.array(borders[::-1], dtype=np.int64)


# ---------------------------------------------------------------------------
# Fast float32 JAX path (device)
# ---------------------------------------------------------------------------


def _hankel(x, n, W):
    """Dense Hankel matrix S[i, j] = x[i + j], i in [0, n), j in [0, W).

    x must have length >= n + W - 1 (padded by the caller). Built with a
    tile+reshape skew instead of an (n, W) gather.
    """
    L = n + W - 1
    x = x[:L]
    # reshape width L+1 skews each row one step left:
    # t[j, c] = x[(j*(L+1) + c) mod L] = x[(j + c) mod L]
    t = jnp.tile(x, W + 1)[: W * (L + 1)].reshape(W, L + 1)
    # max needed index is (n-1)+(W-1) = L-1, so the wrap never materializes
    return t[:, :n].T  # S[i, j] = x[i + j]


@partial(jax.jit, static_argnames=("W", "max_bp"))
def _cost_fast_jax(pm, pt, loci, W, max_bp, pc):
    """Cost tensor Crev[i, j] (f32) with j = W-1-w (ascending-k order,
    Crev[i, j] = cost(k = i-W+1+j, i)).

    pm/pt: int32 (K, n+1) prefix sums; loci: int32 (n,). Datasets accumulate
    one at a time so peak memory stays O(n*W); window prefix values come from
    Hankel skews rather than gathers.
    """
    n = loci.shape[0]
    K = pm.shape[0]
    pc = jnp.float32(pc)
    j_col = jnp.arange(W, dtype=jnp.int32)[None, :]
    i_row = jnp.arange(n, dtype=jnp.int32)[:, None]
    valid = (i_row - (W - 1) + j_col) >= 0  # k >= 0

    def window_vals(vec, fill):
        # returns S[i, j] = vec[k] with k = i - (W-1) + j
        pad = jnp.full(W - 1, fill, dtype=vec.dtype)
        return _hankel(jnp.concatenate([pad, vec]), n, W)

    def one_dataset(carry, d):
        pk_m = window_vals(pm[d, : n + 1], 0)  # pm[k] (n, W); k<0 slots bogus
        pk_t = window_vals(pt[d, : n + 1], 0)
        nm = (pm[d, 1 : n + 1][:, None] - pk_m).astype(jnp.float32)
        nt = (pt[d, 1 : n + 1][:, None] - pk_t).astype(jnp.float32)
        p = (nm + pc) / (nt + 2 * pc)
        ll = nm * _safe_log2(p) + (nt - nm) * _safe_log2(1.0 - p)
        ll = jnp.where(nt == 0, 0.0, ll)
        return carry + ll, None

    row, _ = jax.lax.scan(one_dataset, jnp.zeros((n, W), dtype=jnp.float32),
                          jnp.arange(K))

    if max_bp:
        lk = window_vals(loci[:n], loci[0])
        dist = loci[:, None] - lk
        row = jnp.where(dist > max_bp, -jnp.inf, row)
    return jnp.where(valid, row, -jnp.inf)


def _safe_log2(x):
    return jnp.where(x > 0, jnp.log2(jnp.maximum(x, 1e-38)), 0.0)


@partial(jax.jit, static_argnames=("W", "B"))
def _dp_fast_blocked(Crev, W, B=128):
    """Blocked max-plus DP on the device.

    The sequential recurrence M[i+1] = max_k M[k] + cost(k, i) has window W;
    a naive lax.scan pays per-step dispatch latency 60k times per chunk.
    Here the site axis is cut into blocks of B borders: contributions from
    borders before the block are a fully-parallel (B, W) reduction, and
    in-block dependencies are closed with ~log2(B) max-plus matrix squarings
    ((B+1)^3 elementwise work each). The optimal predecessors are recovered
    afterwards in one fully-parallel argmax pass over the final M vector.

    Crev: (n, W) float32 cost rows in ascending-k order
    (Crev[i, j] = cost(k = i-W+1+j, i)). Returns T (n+1,) int32.
    """
    n = Crev.shape[0]
    NEG = jnp.float32(-jnp.inf)
    n_blocks = (n + B - 1) // B
    n_pad = n_blocks * B
    Cp = jnp.pad(Crev, ((0, n_pad - n), (0, 0)), constant_values=NEG)

    # in-block edge matrix A[p, q] = Cp[b0+q-1, W-(q-p)] — a per-row
    # staircase skew (row u shifted right by u), extracted with a
    # pad+reshape instead of a gather; valid for any W vs B
    P = jnp.arange(B + 1)[:, None]
    Q = jnp.arange(B + 1)[None, :]
    a_valid = (Q > P) & (P >= 1) & (Q - P <= W)

    # H term: H[q] = max_j Mwin[(q-1) + j] + Cp[b0+q-1, j] restricted to
    # k <= b0  (k - b0 = q + j - W)
    Jj = jnp.arange(W)[None, :]
    Qq = jnp.arange(1, B + 1)[:, None]
    h_valid = (Qq + Jj - W) <= 0

    log_steps = max(int(np.ceil(np.log2(max(B, 2)))), 1)
    blocks = Cp.reshape(n_blocks, B, W)

    # in-block closures for ALL blocks at once — the max-plus squarings are
    # the DP's dominant arithmetic (O(B^3 log B) per block) and have no
    # cross-block dependency, so they run as one fully-parallel batch
    # instead of inside the sequential scan (max/add are exact in f32, so
    # the result is bit-identical)
    def closure(rows):
        # Bmat[u, p] = rows[u, p + W-1-u] via the staircase reshape
        # (flat idx u*(W+B)+c lands at F[u, c-u])
        F = jnp.concatenate([rows, jnp.full((B, B + 1), NEG)], axis=1)
        S2 = F.reshape(-1)[: B * (W + B)].reshape(B, W + B)
        Bmat = S2[:, W - 1 : W + B]  # (B, B+1)
        A = jnp.concatenate([jnp.full((B + 1, 1), NEG), Bmat.T], axis=1)
        A = jnp.where(a_valid, A, NEG)
        S = jnp.where(P == Q, 0.0, A)  # I (+) A

        def sq(S, _):
            return jnp.max(S[:, :, None] + S[None, :, :], axis=1), None

        S, _ = jax.lax.scan(sq, S, None, length=log_steps)
        return S

    Sstars = jax.vmap(closure)(blocks)  # (n_blocks, B+1, B+1)

    def block_step(Mwin, xs):
        # Mwin: (W,) = M[b0-W+1 .. b0]
        rows, S = xs  # (B, W), (B+1, B+1)
        # H over known borders: Hankel skew of Mwin gives Mwin[(q-1)+j]
        gat = _hankel(jnp.concatenate([Mwin, jnp.full(B, NEG)]), B, W)
        H = jnp.max(jnp.where(h_valid, gat + rows, NEG), axis=1)  # (B,)
        v = jnp.concatenate([Mwin[-1][None], H])  # (B+1,) border b0..b0+B
        M_blk = jnp.max(v[:, None] + S, axis=0)
        M_blk = jnp.maximum(M_blk, v)  # keep direct H values
        # next carry: M[b0+B-W+1 .. b0+B]
        allm = jnp.concatenate([Mwin, M_blk[1:]])  # (W+B,)
        return allm[-W:], M_blk[1:]

    Mwin0 = jnp.full(W, NEG, dtype=jnp.float32).at[-1].set(0.0)
    _, Ms = jax.lax.scan(block_step, Mwin0, (blocks, Sstars))
    M = jnp.concatenate([jnp.zeros(1, jnp.float32), Ms.reshape(-1)[:n]])

    # parallel predecessor recovery: T[i+1] = argmax_k M[k] + Crev[i, :]
    Mpad = jnp.concatenate([jnp.full(W - 1, NEG), M])  # index shift W-1
    cand = _hankel(Mpad, n, W) + Crev  # S[i, j] = M[i - W + 1 + j] = M[k]
    am = jnp.argmax(cand, axis=1)
    ks = (jnp.arange(n) - (W - 1) + am).astype(jnp.int32)
    return jnp.concatenate([jnp.zeros(1, jnp.int32), ks])


@partial(jax.jit, static_argnames=("W",))
def _dp_fast_jax(Crev, W):
    """lax.scan DP. Crev: (n, W) f32 in ascending-k order. Returns T (n+1,)."""
    n = Crev.shape[0]
    Mpad = jnp.full(n + W + 1, -jnp.inf, dtype=jnp.float32)
    Mpad = Mpad.at[W].set(0.0)

    def step(Mpad, xs):
        i, crow = xs
        window = jax.lax.dynamic_slice(Mpad, (i + 1,), (W,))  # M[k] ascending k
        cand = window + crow
        am = jnp.argmax(cand)  # first max = smallest k
        best = cand[am]
        Mpad = jax.lax.dynamic_update_slice(Mpad, best[None], (W + i + 1,))
        k = i - (W - 1) + am.astype(jnp.int32)
        return Mpad, k

    _, ks = jax.lax.scan(step, Mpad, (jnp.arange(n, dtype=jnp.int32), Crev))
    return jnp.concatenate([jnp.zeros(1, dtype=jnp.int32), ks])


@jax.jit
def _borders_mask(T):
    """Device traceback: mark the border chain {n, T[n], T[T[n]], .., 0}.

    The host traceback (_traceback, ref: segmentor.cpp:50-58) is a
    sequential pointer chase, which would force fetching the whole (n+1,)
    int32 T per window. Instead the chain is marked on device by pointer
    doubling: after round k, S holds every chain node reachable from n in
    < 2^k steps and P is T composed 2^k times, so ceil(log2(n+1)) rounds of
    one gather + one scatter-max mark the full chain. Only the (n+1,) uint8
    mask crosses to the host (4x less than T; the walk itself never does).
    """
    n1 = T.shape[0]
    P = jnp.clip(T, 0, n1 - 1).astype(jnp.int32).at[0].set(0)
    S = jnp.zeros(n1, jnp.uint8).at[n1 - 1].set(1)
    rounds = max(1, int(math.ceil(math.log2(n1))))

    def body(_, PS):
        P, S = PS
        # for every marked p, mark its 2^k-th predecessor P[p]
        S = S.at[P].max(S)
        return P[P], S

    _, S = jax.lax.fori_loop(0, rounds, body, (P, S))
    return S


@partial(jax.jit, static_argnames=("W", "max_bp", "B"))
def _segment_windows_fast(pm, pt, loci, W, max_bp, pc, B=128):
    """vmapped fast-mode segmentation of many equal-size windows at once.

    pm/pt: int32 (nw, K, n+1); loci: int32 (nw, n). Returns T (nw, n+1).
    """

    def one(pm_w, pt_w, loci_w):
        Crev = _cost_fast_jax(pm_w, pt_w, loci_w, W, max_bp, pc)
        return _dp_fast_blocked(Crev, W, B)

    return jax.vmap(one)(pm, pt, loci)


@partial(jax.jit, static_argnames=("W", "max_bp", "B"))
def _segment_windows_masks(pm, pt, loci, W, max_bp, pc, B=128):
    """Like _segment_windows_fast but returns per-window border masks
    (nw, n+1) uint8 — DP and traceback both stay on device."""

    def one(pm_w, pt_w, loci_w):
        Crev = _cost_fast_jax(pm_w, pt_w, loci_w, W, max_bp, pc)
        return _borders_mask(_dp_fast_blocked(Crev, W, B))

    return jax.vmap(one)(pm, pt, loci)


@jax.jit
def pack_mask_bits(masks):
    """uint8 0/1 masks (nw, m) -> bit-packed (nw, ceil(m/8)) uint8,
    numpy-`unpackbits`-compatible (MSB first).

    Border masks cross device->host once per launch, 8x smaller than
    uint8 masks: whole-genome fast segmentation moves 3.5 MB instead of
    28 MB.
    """
    nw, m = masks.shape
    m8 = (m + 7) // 8 * 8
    p = jnp.zeros((nw, m8), jnp.uint8).at[:, :m].set(masks)
    p = p.reshape(nw, m8 // 8, 8).astype(jnp.uint32)
    w = (1 << jnp.arange(7, -1, -1, dtype=jnp.uint32))
    return jnp.sum(p * w, axis=2).astype(jnp.uint8)


def unpack_mask_bits(packed, m):
    """Host inverse of pack_mask_bits: (nw, m8/8) uint8 -> (nw, m) uint8."""
    return np.unpackbits(np.asarray(packed), axis=1)[:, :m]


@partial(jax.jit, static_argnames=("W", "max_bp", "B"))
def _segment_windows_masks_packed(pm, pt, loci, W, max_bp, pc, B=128):
    """_segment_windows_masks with the masks bit-packed on device."""
    return pack_mask_bits(_segment_windows_masks(pm, pt, loci, W, max_bp,
                                                 pc, B))


def segment_windows_fast(datas, locis, max_cpg=1000, max_bp=2000,
                         pseudo_count=15.0, batch=8):
    """Batch-segment many equal-size windows (fast float32 mode).

    datas: (nw, K, n, 2) int counts; locis: (nw, n). Returns a list of
    relative border arrays. Windows run `batch` at a time (one fixed
    compiled shape; the tail is padded with window 0 and dropped) with all
    launches dispatched before the single sync — whole-genome memory stays
    bounded at one (batch, n, W) cost tensor per launch.
    """
    datas = np.asarray(datas)
    locis = np.asarray(locis)
    nw, K, n, _ = datas.shape
    W = int(min(max_cpg, n))
    batch = max(1, min(batch, nw))
    max_bp = int(max_bp) if max_bp else 0
    pc = float(pseudo_count)
    pms, pts = [], []
    for w in range(nw):
        pm, pt = _prefix_sums(datas[w])
        pms.append(pm)
        pts.append(pt)
    outs = []
    for lo in range(0, nw, batch):
        sel = list(range(lo, min(lo + batch, nw)))
        pad = batch - len(sel)
        sel = sel + [sel[0]] * pad
        outs.append(_segment_windows_masks_packed(
            jnp.asarray(np.stack([pms[w] for w in sel]), dtype=jnp.int32),
            jnp.asarray(np.stack([pts[w] for w in sel]), dtype=jnp.int32),
            jnp.asarray(locis[sel], dtype=jnp.int32),
            W, max_bp, pc,
        ))
    masks = [unpack_mask_bits(o, n + 1) for o in outs]
    res = []
    for li, lo in enumerate(range(0, nw, batch)):
        for j in range(min(batch, nw - lo)):
            res.append(np.flatnonzero(masks[li][j]).astype(np.int64))
    return res


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _use_exact_device():
    """Whether exact mode's DP runs on the device (bit-identical borders
    either way): only when WGBS_TPU_SEGMENT_EXACT_DEVICE=1. The default,
    with or without a GPU, is the host C++ DP threaded over chunks: on a
    16-core H100 host it segments 2.5M sites in 3.27 s against the
    device's 3.89 s (PERF.md), with identical borders."""
    import os

    v = os.environ.get("WGBS_TPU_SEGMENT_EXACT_DEVICE", "0").lower()
    return v in ("1", "true", "yes", "on")


# windows below this many sites (stitch patches, ~100-400 sites of
# data-dependent size) run exact mode on the host: each distinct size
# would compile or load its own device program for microseconds of host
# work (2.5M sites on an H100: first run 6.6 s with the gate, 11.3 s
# without, persistent cache warm; PERF.md)
DEVICE_EXACT_MIN_SITES = 4096


def segment_borders(data, loci, max_cpg=1000, max_bp=2000, pseudo_count=15.0,
                    mode="exact", cost_block=4096):
    """Segment one window of K beta datasets.

    data: (K, n, 2) int counts for sites [s, s+n).
    loci: int (n,) basepair positions of those sites (for max_bp).
    Returns 0-based relative border array (ascending, includes 0 and n).
    """
    data = np.asarray(data)
    K, n, _ = data.shape
    if n == 1:
        return np.array([0, 1], dtype=np.int64)
    W = int(min(max_cpg, n))
    loci = np.asarray(loci, dtype=np.int64)
    if loci.shape[0] != n:
        raise IllegalArgumentError(
            f"nr_sites != number of loci: {n} != {loci.shape[0]}"
        )
    pm, pt = _prefix_sums(data)

    if mode == "exact":
        T = None
        # device path: ll-table lookups + IEEE float64 DP
        # (segment_exact_tpu.py) — bit-identical to the host chain; returns
        # None for ineligible windows (host handles those)
        if n >= DEVICE_EXACT_MIN_SITES and _use_exact_device():
            from .segment_exact_tpu import segment_exact_device_T

            T = segment_exact_device_T(data, loci, W, max_bp, pseudo_count)
        if T is None:
            # native C++ kernel: same libm log2 / float rounding chain,
            # band-limited cost evaluation (native/segment_exact.cpp);
            # ~10-50x the vectorized numpy emulation below, byte-identical
            from ..native import segment_exact_native

            T = segment_exact_native(data, loci, W, max_bp, pseudo_count)
        if T is None:
            # numpy emulation (bit-identical to the native chain: libm
            # log2 per unique pair, float32 rounding). Loud, not silent —
            # a quiet numeric-path swap is how a near-tie border once
            # flaked across processes (the native .so transiently
            # unavailable in a worker picked this path)
            from ..utils.log import logger

            logger.warning(
                "segment: native exact kernel unavailable; using the "
                "numpy emulation (bit-identical, slower)")
            if max_bp and (np.diff(loci) < 0).any():
                C = _cost_exact_literal(data, loci, W, max_bp, pseudo_count)
            else:
                C = np.empty((n, W), dtype=np.float64)
                for lo in range(0, n, cost_block):
                    hi = min(lo + cost_block, n)
                    C[lo:hi] = _cost_block_exact(pm, pt, loci, lo, hi, W,
                                                 max_bp, pseudo_count)
            T = _dp_exact(C)
    elif mode == "fast":
        Crev = _cost_fast_jax(
            jnp.asarray(pm, dtype=jnp.int32),
            jnp.asarray(pt, dtype=jnp.int32),
            jnp.asarray(loci, dtype=jnp.int32),
            W,
            int(max_bp) if max_bp else 0,
            float(pseudo_count),
        )
        if n >= 512:
            T = np.asarray(_dp_fast_blocked(Crev, W)).astype(np.int64)
        else:
            T = np.asarray(_dp_fast_jax(Crev, W)).astype(np.int64)
    else:
        raise IllegalArgumentError(f"unknown segment mode: {mode}")
    return _traceback(T, n)


def segment_sites_window(beta_paths, sites, index, max_cpg=1000, max_bp=2000,
                         pseudo_count=15.0, mode="exact"):
    """Segment 1-based [start, end) sites of beta files.

    Returns absolute 1-based border sites (ref: segment.py:41-55 adds +start).
    """
    start, end = sites
    if end - start == 1:
        return np.array([start, end], dtype=np.int64)
    data = np.stack([load_beta(b, sites=(start, end)) for b in beta_paths])
    for d, b in zip(data, beta_paths):
        if (d[:, 0] > d[:, 1]).any():
            raise IllegalArgumentError(f"invalid beta data in {b}")
    loci = index.loci[start - 1 : end - 1]
    rel = segment_borders(data, loci, max_cpg, max_bp, pseudo_count, mode=mode)
    return rel + start


# ---------------------------------------------------------------------------
# Chunked orchestration + overlap-patch stitching (ref: segment.py:84-252)
# ---------------------------------------------------------------------------


class SegmentConfig:
    def __init__(self, max_cpg=1000, max_bp=2000, pseudo_count=15.0,
                 chunk_size=DEF_CHUNK, min_cpg=1, mode="exact", threads=None):
        self.max_bp = max_bp
        self.max_cpg = min(max_cpg, max_bp // 2) if max_bp else max_cpg
        assert self.max_cpg > 1
        self.pseudo_count = pseudo_count
        self.chunk_size = chunk_size
        self.min_cpg = min_cpg
        self.mode = mode
        if threads is None:
            import os

            threads = int(os.environ.get("SLURM_JOB_CPUS_PER_NODE", 0)) \
                or (os.cpu_count() or 1)  # ref: utils_wgbs.py:250-261
        self.threads = max(1, threads)


def break_to_chunks(ranges, step):
    """[(s, e)] -> (tags, chunk_sites) keeping ranges separated
    (ref: segment.py:126-135)."""
    tags, chunks = [], []
    for start, end in ranges:
        bords = list(range(start, end, step)) + [end]
        for s, e in zip(bords[:-1], bords[1:]):
            tags.append((start, end))
            chunks.append((s, e))
    return tags, chunks


def segment_ranges(beta_paths, ranges, index, cfg: SegmentConfig):
    """Segment a list of site ranges; returns (startCpG, endCpG) block arrays."""
    tags, chunks = break_to_chunks(ranges, cfg.chunk_size)
    seg = _seg_fn(beta_paths, index, cfg)
    results = segment_chunks(beta_paths, chunks, index, cfg)
    batch_seg = (_batch_seg_fast(beta_paths, index, cfg)
                 if cfg.mode == "fast" else None)
    return finalize_segmentation(tags, chunks, results, seg, cfg,
                                 batch_seg=batch_seg)


def _seg_fn(beta_paths, index, cfg):
    return lambda sites: segment_sites_window(
        beta_paths, sites, index, cfg.max_cpg, cfg.max_bp, cfg.pseudo_count,
        cfg.mode,
    )


def segment_chunks(beta_paths, chunks, index, cfg: SegmentConfig,
                   subset=None):
    """Per-chunk absolute border arrays (the parallelizable phase of
    segment_ranges). `subset`: chunk indices this caller owns (default
    all) — entries outside it stay None; the multi-process path
    (parallel/multihost.py) round-robins the subset across processes and
    stitches on process 0."""
    seg = _seg_fn(beta_paths, index, cfg)
    results = [None] * len(chunks)
    own = list(range(len(chunks))) if subset is None else         sorted(set(int(i) for i in subset))
    if cfg.mode == "exact" and _use_exact_device():
        # device exact DP, BATCHED over equal-size chunks: bit-identical
        # tracebacks (band-clipped cost build + site-major ring-buffer DP
        # in float64). Ineligible windows stay None and take the host path
        # below.
        from .segment_exact_tpu import segment_exact_device_batch

        by_size = {}
        for i in own:
            s, e = chunks[i]
            if e - s >= DEVICE_EXACT_MIN_SITES:
                by_size.setdefault(e - s, []).append(i)
        for n, idxs in by_size.items():
            datas, locis = [], []
            for i in idxs:
                s, e = chunks[i]
                data = np.stack([load_beta(b, sites=chunks[i])
                                 for b in beta_paths])
                for d, b in zip(data, beta_paths):
                    # same invalid-beta guard as the host path
                    # (segment_sites_window) — corrupt files must raise,
                    # not segment silently, on the device route too
                    if (d[:, 0] > d[:, 1]).any():
                        raise IllegalArgumentError(
                            f"invalid beta data in {b}")
                datas.append(data)
                locis.append(index.loci[s - 1 : e - 1])
            Ts = segment_exact_device_batch(
                np.stack(datas), np.stack(locis), int(min(cfg.max_cpg, n)),
                cfg.max_bp, cfg.pseudo_count)
            for i, T in zip(idxs, Ts):
                if T is not None:
                    results[i] = _traceback(T, n) + chunks[i][0]
    if cfg.mode == "fast":
        # batch all equal-size chunks into single device launches
        by_size = {}
        for i in own:
            s, e = chunks[i]
            by_size.setdefault(e - s, []).append(i)
        for n, idxs in by_size.items():
            if n <= 1 or len(idxs) == 1:
                continue
            datas = np.stack([
                np.stack([load_beta(b, sites=chunks[i])
                          for b in beta_paths]) for i in idxs
            ])
            locis = np.stack([
                index.loci[chunks[i][0] - 1 : chunks[i][1] - 1] for i in idxs
            ])
            import jax

            local = jax.local_devices()
            if len(local) > 1:
                # shard the window axis over every local device (the
                # windows are independent by construction of the chunk+stitch
                # decomposition; replaces the reference's process Pool,
                # segment.py:144-146). Local: in a multi-process job each
                # process segments its own chunk subset.
                from ..parallel.mesh import make_mesh
                from ..parallel.sharded import segment_windows_sharded

                borders = segment_windows_sharded(
                    make_mesh(devices=local), datas, locis, cfg.max_cpg,
                    cfg.max_bp, cfg.pseudo_count)
            else:
                borders = segment_windows_fast(
                    datas, locis, cfg.max_cpg, cfg.max_bp, cfg.pseudo_count)
            for i, rel in zip(idxs, borders):
                results[i] = rel + chunks[i][0]
    todo = [i for i in own if results[i] is None]
    if cfg.mode == "exact" and cfg.threads > 1 and len(todo) > 1:
        # thread pool over chunks (the reference forks a process per chunk,
        # segment.py:144-146; our C++ DP releases the GIL so threads scale
        # and the beta files/index stay shared in memory)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(cfg.threads, len(todo))) as pool:
            for i, res in zip(todo, pool.map(seg, [chunks[i] for i in todo])):
                results[i] = res
    else:
        for i in todo:
            results[i] = seg(chunks[i])
    return results


def _batch_seg_fast(beta_paths, index, cfg):
    """Batched window segmentation for the fast-mode stitcher: groups
    equal-size patch windows into single device launches (identical
    per-window borders to segment_sites_window(mode=fast) — the batched
    form is the same DP, tests/test_parallel.py)."""

    def run(windows):
        out = [None] * len(windows)
        by_size = {}
        for i, (s, e) in enumerate(windows):
            by_size.setdefault(e - s, []).append(i)
        for n, idxs in by_size.items():
            if n <= 1 or len(idxs) == 1:
                for i in idxs:
                    out[i] = segment_sites_window(
                        beta_paths, windows[i], index, cfg.max_cpg,
                        cfg.max_bp, cfg.pseudo_count, "fast")
                continue
            datas = np.stack([
                np.stack([load_beta(b, sites=windows[i])
                          for b in beta_paths]) for i in idxs])
            locis = np.stack([
                index.loci[windows[i][0] - 1 : windows[i][1] - 1]
                for i in idxs])
            borders = segment_windows_fast(
                datas, locis, cfg.max_cpg, cfg.max_bp, cfg.pseudo_count)
            for i, rel in zip(idxs, borders):
                out[i] = rel + windows[i][0]
        return out

    return run


def finalize_segmentation(tags, chunks, results, seg, cfg: SegmentConfig,
                          batch_seg=None):
    """Stitch per-chunk borders into the final (starts, ends) block arrays
    (the sequential phase of segment_ranges; overlap patches re-segment
    through `seg` — or through `batch_seg` in one device launch per
    stitching round, ref: segment.py:157-252)."""
    order_tags = list(dict.fromkeys(tags))  # preserve order, unique
    groups = [[results[i] for i in range(len(results)) if tags[i] == tag]
              for tag in order_tags]
    if batch_seg is not None:
        merged_list = _merge_groups_batched(groups, batch_seg)
    else:
        merged_list = [_merge_border_list(g, seg) for g in groups]
    all_starts, all_ends = [], []
    for merged in merged_list:
        all_starts.append(merged[:-1])
        all_ends.append(merged[1:])
    starts = np.concatenate(all_starts) if all_starts else np.empty(0, np.int64)
    ends = np.concatenate(all_ends) if all_ends else np.empty(0, np.int64)
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    keep = ends - starts > cfg.min_cpg - 1
    return starts[keep], ends[keep]


def _merge_border_list(blist, seg_fn):
    """Pairwise-reduce stitching rounds (ref: segment.py:157-165)."""
    while len(blist) > 1:
        nxt = [
            _stitch_2(blist[i - 1], blist[i], seg_fn)
            for i in range(1, len(blist), 2)
        ]
        if len(blist) % 2:
            nxt.append(blist[-1])
        blist = nxt
    return blist[0]


def _merge_groups_batched(groups, batch_seg):
    """All tags' pairwise stitching rounds with BATCHED patch
    re-segmentation: every pending pair's patch window segments in one
    device launch per (round, growth iteration) instead of one launch per
    pair (~470 serial launches genome-wide). Per-pair semantics are
    exactly _stitch_2's
    (same initial patch, same growth rule, same failure condition), so
    the merged borders are identical to the serial path.

    groups: list of border lists (one per tag). Returns the merged border
    array per tag.
    """
    out = [None] * len(groups)
    work = [(gi, list(g)) for gi, g in enumerate(groups)]
    while work:
        nxt_work = []
        pairs = []  # [gi, slot, b1, b2, p1, p2, n1, n2]
        slots = {}  # (gi) -> next-round blist with None placeholders
        for gi, blist in work:
            if len(blist) == 1:
                out[gi] = blist[0]
                continue
            nxt = []
            for i in range(1, len(blist), 2):
                b1, b2 = blist[i - 1], blist[i]
                if b1[-1] != b2[0]:
                    raise IllegalArgumentError(
                        "Patch stitching failed: non-adjacent chunks")
                n1 = int(b1[-1] - b1[0])
                n2 = int(b2[-1] - b2[0])
                pairs.append([gi, len(nxt), b1, b2, min(50, n1),
                              min(50, n2), n1, n2])
                nxt.append(None)
            if len(blist) % 2:
                nxt.append(blist[-1])
            slots[gi] = nxt
        pending = pairs
        while pending:
            wins = [(int(p[2][-1]) - p[4], int(p[2][-1]) + p[5])
                    for p in pending]
            patches = batch_seg(wins)
            still = []
            for p, patch in zip(pending, patches):
                gi, slot, b1, b2, p1, p2, n1, n2 = p
                o1 = _overlaps(b1, patch)
                o2 = _overlaps(patch, b2)
                if o1 and o2:
                    slots[gi][slot] = _merge2(_merge2(b1, patch), b2)
                    continue
                if not o1:
                    p[4] = _grow(p1, n1)
                if not o2:
                    p[5] = _grow(p2, n2)
                if p[4] > n1 or p[5] > n2:
                    raise IllegalArgumentError(
                        "Patch stitching failed. Try increasing chunk "
                        "size (--chunk_size)")
                still.append(p)
            pending = still
        for gi, nxt in slots.items():
            nxt_work.append((gi, nxt))
        work = nxt_work
    return out


def _stitch_2(b1, b2, seg_fn):
    """Re-segment an overlap patch until its borders agree with both sides
    (ref: segment.py:199-252)."""
    if b1[-1] != b2[0]:
        raise IllegalArgumentError("Patch stitching failed: non-adjacent chunks")
    n1 = int(b1[-1] - b1[0])
    n2 = int(b2[-1] - b2[0])
    p1 = min(50, n1)
    p2 = min(50, n2)
    while p1 <= n1 and p2 <= n2:
        start = int(b1[-1]) - p1
        end = int(b1[-1]) + p2
        patch = seg_fn((start, end))
        if _overlaps(b1, patch) and _overlaps(patch, b2):
            return _merge2(_merge2(b1, patch), b2)
        if not _overlaps(b1, patch):
            p1 = _grow(p1, n1)
        if not _overlaps(patch, b2):
            p2 = _grow(p2, n2)
    raise IllegalArgumentError(
        "Patch stitching failed. Try increasing chunk size (--chunk_size)"
    )


def _dups_mask(b1, b2):
    cat = np.concatenate([b1, b2])
    _, inv, counts = np.unique(cat, return_inverse=True, return_counts=True)
    return counts[inv] > 1


def _overlaps(b1, b2):
    return bool(_dups_mask(b1, b2).sum())


def _merge2(b1, b2):
    dups = _dups_mask(b1, b2)
    nr_from_b1 = int(np.argmax(dups))
    skip_from_b2 = int(np.searchsorted(b2, b1[nr_from_b1]))
    return np.concatenate([b1[: nr_from_b1 + 1], b2[skip_from_b2 + 1 :]])


def _grow(pre, maxval):
    if pre == maxval:
        return maxval + 1
    return int(min(pre * 2, maxval))
