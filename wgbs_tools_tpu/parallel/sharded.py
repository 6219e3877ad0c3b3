"""Sharded whole-genome pipelines: pileup + block reduce + segmentation DP
over a (samples, sites) device mesh.

Mapping from the reference's process parallelism (see parallel/mesh.py):
fragments shard by site range; multi-sample segmentation costs reduce
with `psum` over the samples axis (replacing the in-process dataset loop
of segmentor.cpp:120-135). The streaming pileup (ShardedPileup) clips
fragments at shard boundaries on the host and runs the XLA scatter on
each device, with no halo collective; the fused analysis step
(build_analysis_step) carries boundary-crossing reads in a halo
`ppermute` (replacing the order-preserving file concat of
bam2pat.py:398-422). Both are bit-identical to the single-device pileup
(integer adds).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map as _shard_map

    def shard_map(f, mesh, in_specs, out_specs):
        return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map as _shard_map_exp

    def shard_map(f, mesh, in_specs, out_specs):
        return _shard_map_exp(f, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs)

from ..formats.pat import CODE_C, CODE_DOT, CODE_H


def _local_pileup(rel_start, length, count, codes, out_len):
    """Dense (out_len, 2) pileup of one fragment shard (relative starts)."""
    L = codes.shape[1]
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    site = rel_start[:, None] + pos
    in_read = pos < length[:, None]
    in_win = (site >= 0) & (site < out_len)
    observed = in_read & in_win & (codes != CODE_DOT)
    meth_call = (codes == CODE_C) | (codes == CODE_H)
    cnt = count[:, None]
    site_c = jnp.where(in_win, site, out_len).reshape(-1)
    out = jnp.zeros((out_len + 1, 2), dtype=jnp.int32)
    out = out.at[site_c, 0].add(
        jnp.where(observed & meth_call, cnt, 0).reshape(-1), mode="drop")
    out = out.at[site_c, 1].add(
        jnp.where(observed, cnt, 0).reshape(-1), mode="drop")
    return out[:out_len]


def _segment_cost_local(counts, loci, W, max_bp, pc):
    """(S, W) float32 cost rows (ascending-k order) from local counts.

    counts: (S, 2) int32 — local-sample partial counts; the caller psums the
    returned rows over the samples axis before the DP. Window prefix values
    come from gather-free Hankel skews (see models/segment.py).
    """
    from ..models.segment import _hankel

    S = counts.shape[0]
    ps = jnp.concatenate(
        [jnp.zeros((1, 2), jnp.int32), jnp.cumsum(counts, axis=0,
                                                  dtype=jnp.int32)], axis=0
    )
    valid = (
        jnp.arange(S, dtype=jnp.int32)[:, None]
        - (W - 1) + jnp.arange(W, dtype=jnp.int32)[None, :]
    ) >= 0

    def window_vals(vec, fill):
        pad = jnp.full(W - 1, fill, dtype=vec.dtype)
        return _hankel(jnp.concatenate([pad, vec]), S, W)

    nm = (ps[1:, 0][:, None] - window_vals(ps[: S + 1, 0], 0)).astype(
        jnp.float32)
    nt = (ps[1:, 1][:, None] - window_vals(ps[: S + 1, 1], 0)).astype(
        jnp.float32)
    pcf = jnp.float32(pc)
    p = (nm + pcf) / (nt + 2 * pcf)
    ll = nm * _log2s(p) + (nt - nm) * _log2s(1.0 - p)
    ll = jnp.where(nt == 0, 0.0, ll)
    if max_bp:
        dist = loci[:, None] - window_vals(loci, loci[0])
        ll = jnp.where(dist > max_bp, -jnp.inf, ll)
    return jnp.where(valid, ll, -jnp.inf)


def _log2s(x):
    return jnp.where(x > 0, jnp.log2(jnp.maximum(x, 1e-38)), 0.0)


def _dp_scan(Crev, W, vary_axes=None):
    n = Crev.shape[0]
    Mpad = jnp.full(n + W + 1, -jnp.inf, dtype=jnp.float32)
    Mpad = Mpad.at[W].set(0.0)
    if vary_axes:
        # inside shard_map the scan carry must match the xs' varying axes
        Mpad = jax.lax.pcast(Mpad, vary_axes, to="varying")

    def step(Mpad, xs):
        i, crow = xs
        window = jax.lax.dynamic_slice(Mpad, (i + 1,), (W,))
        cand = window + crow
        am = jnp.argmax(cand)
        Mpad = jax.lax.dynamic_update_slice(Mpad, cand[am][None], (W + i + 1,))
        return Mpad, i - (W - 1) + am.astype(jnp.int32)

    _, ks = jax.lax.scan(step, Mpad, (jnp.arange(n, dtype=jnp.int32), Crev))
    return ks


def build_analysis_step(mesh, n_sites, halo, W, max_bp=0, pc=15.0):
    """Jitted sharded step: fragments -> counts -> per-window segmentation.

    Shapes (global):
      rel_start/length/count: (F,) int32, fragments bucketed so that shard i
        holds fragments starting in its site range (sorted by start);
      codes: (F, L) uint8;
      sample_counts: (K, n_sites, 2) int32 per-sample per-site counts
        (sharded over samples x sites);
      loci: (n_sites,) int32.

    Returns (counts (n_sites, 2), window_tb (n_sites,), cov_lo, cov_f) where
    (cov_lo, cov_f) is the overflow-safe total-coverage pair — feed to
    decode_sum64 for the exact 64-bit value.

    window_tb semantics: each sites-shard segments its own site window
    INDEPENDENTLY (costs psum'd over the samples axis, fast-float32 DP run
    per shard; entries are window-relative predecessor indices). This is the
    device analogue of the reference's 60k-site chunk decomposition
    (ref: segment.py:84-135) with window == shard; the host stitches window
    borders exactly as models/segment.segment_ranges does for chunks. It is
    NOT a single global DP across shards — tests/test_parallel.py verifies
    each window's borders equal the single-device DP on that window.
    """
    n_sites_shard = n_sites // mesh.shape["sites"]
    n_shards = mesh.shape["sites"]

    def step(rel_start, length, count, codes, sample_counts, loci):
        # rel_start here is relative to the *shard* start (host pre-subtracts)
        local = _local_pileup(rel_start, length, count, codes,
                              n_sites_shard + halo)
        tail = local[n_sites_shard:]
        perm = [(j, (j + 1) % n_shards) for j in range(n_shards)]
        received = jax.lax.ppermute(tail, "sites", perm)
        idx = jax.lax.axis_index("sites")
        received = jnp.where(idx == 0, 0, received)  # no left neighbor wrap
        counts = local[:n_sites_shard].at[:halo].add(received)

        # multi-sample segmentation cost: partial rows per sample shard,
        # psum over the samples axis (ref: segmentor.cpp dataset loop)
        k_local = sample_counts.shape[0]
        cost = jnp.zeros((n_sites_shard, W), dtype=jnp.float32)
        for d in range(k_local):
            cost += _segment_cost_local(sample_counts[d], loci[:, 0], W,
                                        max_bp, pc)
        cost = jax.lax.psum(cost, "samples")
        tb = _dp_scan(cost, W, vary_axes=("sites",))

        cov_lo, cov_f = _psum64(counts[:, 1], ("sites",))
        return counts, tb, cov_lo, cov_f

    sharded = shard_map(
        step,
        mesh,
        in_specs=(
            P("sites"), P("sites"), P("sites"), P("sites", None),
            P("samples", "sites", None), P("sites", None),
        ),
        out_specs=(P("sites", None), P("sites"), P(), P()),
    )
    return jax.jit(sharded)


def _psum64(x, axis_names):
    """Overflow-safe 64-bit total of int32 values without enable_x64.

    jnp.sum(..., dtype=int64) silently truncates to int32 when x64 is off —
    a real overflow for genome-wide coverage at >=60x (28.2M sites * 76 >
    2^31). Instead return (lo, f): `lo` is the exact total mod 2^32 (XLA
    int32 adds wrap, two's complement), `f` a float32 estimate that recovers
    the high word. decode_sum64 reconstructs the exact value while the true
    total < ~2^44 (float32 tree-sum error stays far below the 2^31 needed to
    misround the high word) — 5 orders of magnitude past any WGBS total.
    """
    lo = jax.lax.psum(jnp.sum(x, dtype=jnp.int32), axis_names)
    f = jax.lax.psum(jnp.sum(x.astype(jnp.float32)), axis_names)
    return lo, f


def decode_sum64(lo, f):
    """Host-side exact reconstruction of a _psum64 pair -> python int."""
    lo_u = int(np.uint32(np.int32(np.asarray(lo))))
    hi = int(np.round((float(np.asarray(f)) - lo_u) / 4294967296.0))
    return hi * 4294967296 + lo_u


def build_segment_windows_step(mesh, W, max_bp=0, pc=15.0, B=128):
    """Data-parallel batched fast segmentation over a device mesh.

    The genome is already decomposed into independent equal-size windows by
    the chunk+stitch scheme (models/segment.py, replacing the reference's
    process-per-chunk Pool in segment.py:96-110); here the window axis is
    sharded over EVERY device of the mesh (all axes flattened into the batch
    dimension), so the whole-genome fast-mode DP runs as one SPMD launch
    with no collectives. Inputs: pm/pt int32 (nw, K, n+1), loci int32
    (nw, n); nw must be a multiple of the device count (pad on host).
    """
    from jax.sharding import NamedSharding

    from ..models.segment import (_borders_mask, _cost_fast_jax,
                                  _dp_fast_blocked, pack_mask_bits)

    def fn(pm, pt, loci):
        def one(pm_w, pt_w, loci_w):
            Crev = _cost_fast_jax(pm_w, pt_w, loci_w, W, max_bp, pc)
            # traceback chain is marked on device (pointer doubling);
            # only the bit-packed border mask leaves the device (8x less
            # d2h than uint8 masks)
            return _borders_mask(_dp_fast_blocked(Crev, W, B))

        return pack_mask_bits(jax.vmap(one)(pm, pt, loci))

    sh = NamedSharding(mesh, P(tuple(mesh.axis_names)))
    return jax.jit(fn, in_shardings=(sh, sh, sh), out_shardings=sh)


def segment_windows_sharded(mesh, datas, locis, max_cpg=1000, max_bp=2000,
                            pseudo_count=15.0, per_device_batch=2):
    """Host wrapper: run the window-sharded step in fixed-size launches of
    (n_devices * per_device_batch) windows (tail padded with window 0), all
    dispatched before one sync; returns per-window relative border arrays.
    Fixed launch shape = one compile; bounded per-device memory."""
    from ..models.segment import _prefix_sums

    datas = np.asarray(datas)
    locis = np.asarray(locis)
    nw, K, n, _ = datas.shape
    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    W = int(min(max_cpg, n))
    launch = ndev * max(1, per_device_batch)
    pms, pts = [], []
    for w in range(nw):
        pm, pt = _prefix_sums(datas[w])
        pms.append(pm)
        pts.append(pt)
    step = build_segment_windows_step(
        mesh, W, int(max_bp) if max_bp else 0, float(pseudo_count))
    outs = []
    for lo in range(0, nw, launch):
        sel = list(range(lo, min(lo + launch, nw)))
        sel = sel + [sel[0]] * (launch - len(sel))
        outs.append(step(
            jnp.asarray(np.stack([pms[w] for w in sel]), dtype=jnp.int32),
            jnp.asarray(np.stack([pts[w] for w in sel]), dtype=jnp.int32),
            jnp.asarray(locis[sel], dtype=jnp.int32),
        ))
    from ..models.segment import unpack_mask_bits

    res = []
    for li, lo in enumerate(range(0, nw, launch)):
        mask = unpack_mask_bits(np.asarray(outs[li]), n + 1)
        for j in range(min(launch, nw - lo)):
            res.append(np.flatnonzero(mask[j]).astype(np.int64))
    return res


@functools.partial(jax.jit, donate_argnums=0)
def _shard_add(total, res):
    return total + res


class ShardedPileup:
    """Streaming whole-genome pileup with one clipped XLA scatter per
    device of a mesh (every device takes one site range).

    - fragments are CLIPPED to shard windows on the host, so each shard's
      pileup is fully independent and no halo collective is needed;
    - each shard's batch is placed on its device (`jax.default_device`)
      and accumulates into a device-resident (S, 2) total;
    - `result()`/`finalize()` fetch and saturate each shard on its own
      device and concatenate on the host (one program over the whole
      sharded table stalled in cross-device reductions on four H100s).

    Bit-exactness: integer adds in a different grouping, so the assembled
    table equals the single-device pileup exactly (tests/test_parallel.py).
    Replaces the reference's per-chromosome Pool + concat
    (ref: src/python/pat2beta.py:14-65, stdin2beta.cpp:59-93).
    """

    def __init__(self, mesh, window):
        self.window = window
        self.n = window[1] - window[0]
        self.devices = list(mesh.devices.reshape(-1))
        self.n_shards = len(self.devices)
        self.S = (self.n + self.n_shards - 1) // self.n_shards
        self.totals = [
            jax.device_put(jnp.zeros((self.S, 2), dtype=jnp.int32), d)
            for d in self.devices
        ]

    def add(self, frags):
        from ..ops.pileup import pileup_frags

        if frags.nr_frags == 0:
            return
        base = self.window[0]
        for i, dev in enumerate(self.devices):
            lo = base + i * self.S
            hi = min(lo + self.S, self.window[1])
            if hi <= lo:
                continue
            sel = frags.slice_sites(lo, hi, min_overlap=1)
            if sel.nr_frags == 0:
                continue
            with jax.default_device(dev):
                res = pileup_frags(sel, (lo, lo + self.S), to_host=False)
                self.totals[i] = _shard_add(self.totals[i], res)

    def result(self):
        from ..ops.pileup import fetch_chunked

        return np.concatenate([fetch_chunked(t) for t in self.totals]
                              )[: self.n]

    def finalize(self, lbeta=False):
        """Saturated uint8/uint16 (n, 2) beta array (exact reference
        semantics), each shard saturated on its own device."""
        from ..ops.pileup import saturate_device_counts

        return np.concatenate([saturate_device_counts(t, lbeta)
                               for t in self.totals])[: self.n]


def bucket_fragments(start, length, count, codes, n_sites, n_shards,
                     max_len=None, base=1, fp_mult=1):
    """Host-side: assign fragments to site shards, pad to equal counts, and
    make starts shard-relative. Returns arrays shaped (n_shards*Fp, ...).

    base: 1-based site index of the first site of shard 0 (window start).
    fp_mult: round the per-shard fragment capacity up to a multiple (keeps
    the jitted step's shapes in a small bucket set across streaming chunks).
    """
    start = np.asarray(start, dtype=np.int64) - (base - 1)
    S = n_sites // n_shards
    shard_of = np.clip((start - 1) // S, 0, n_shards - 1)
    order = np.argsort(shard_of, kind="stable")
    start, shard_of = start[order], shard_of[order]
    length = np.asarray(length, dtype=np.int32)[order]
    count = np.asarray(count, dtype=np.int32)[order]
    codes = np.asarray(codes)[order]
    per = np.bincount(shard_of, minlength=n_shards)
    Fp = max(int(per.max(initial=1)), 1)
    Fp = (Fp + fp_mult - 1) // fp_mult * fp_mult
    L = codes.shape[1] if max_len is None else max_len
    out_start = np.zeros((n_shards, Fp), dtype=np.int32)
    out_len = np.zeros((n_shards, Fp), dtype=np.int32)
    out_cnt = np.zeros((n_shards, Fp), dtype=np.int32)
    out_codes = np.full((n_shards, Fp, L), CODE_DOT, dtype=np.uint8)
    pos = 0
    for sh in range(n_shards):
        k = int(per[sh])
        sl = slice(pos, pos + k)
        out_start[sh, :k] = start[sl] - 1 - sh * S  # shard-relative, 0-based
        out_len[sh, :k] = length[sl]
        out_cnt[sh, :k] = count[sl]
        out_codes[sh, :k, : codes.shape[1]] = codes[sl]
        pos += k
    return (
        out_start.reshape(-1),
        out_len.reshape(-1),
        out_cnt.reshape(-1),
        out_codes.reshape(n_shards * Fp, L),
    )
