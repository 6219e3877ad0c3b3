"""Block reductions: per-CpG count tables -> per-block sums.

Replaces the reference's `np.add.reduceat` fast path and per-row slow path
(ref: src/python/beta_to_blocks.py:101-116) with a device segment-sum so the
same op serves beta_to_blocks, beta_to_table and find_markers chunks on the
device.
Blocks may be arbitrary (unsorted, overlapping -> slow path semantics are
identical because each block sums independently over its [startCpG, endCpG)).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("n_blocks",))
def _reduce_nice(data, seg_ids, n_blocks):
    """Segment-sum over non-overlapping sorted blocks.

    seg_ids: int32[N] block id per site, n_blocks for gap sites (dropped).
    data: int32[N, C].
    """
    return jax.ops.segment_sum(
        data, seg_ids, num_segments=n_blocks + 1, indices_are_sorted=True
    )[:n_blocks]


def reduce_data_to_blocks(data, starts, ends, base=1):
    """Sum data rows per block.

    data: (N, C) counts whose row 0 corresponds to 1-based site `base`.
    starts/ends: 1-based [startCpG, endCpG) per block; rows with start<0 (NA)
    yield zeros (ref: beta_to_blocks.py:108-116).
    Returns int64 (B, C).
    """
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    B = starts.shape[0]
    N = data.shape[0]
    out = np.zeros((B, data.shape[1]), dtype=np.int64)
    valid = starts >= 0
    s = np.clip(starts[valid] - base, 0, N)
    e = np.clip(ends[valid] - base, 0, N)

    nice = (
        s.shape[0] > 0
        and np.all(np.diff(s) >= 0)
        and np.all(np.diff(e) >= 0)
        and np.all(s[1:] >= e[:-1])
        and np.all(e >= s)
    )
    if nice and s.shape[0] > 0:
        lo, hi = int(s[0]), max(int(e[-1]), int(s[0]))
        n_b = s.shape[0]
        seg = _segment_ids(s - lo, e - lo, hi - lo, n_b)
        sharded = len(jax.devices()) > 1 and (hi - lo) >= (1 << 16)
        if sharded:
            res = _reduce_nice_sharded(
                np.asarray(data[lo:hi], dtype=np.int32), seg, n_b)
        else:
            res = _reduce_nice(
                jnp.asarray(np.asarray(data[lo:hi], dtype=np.int32)),
                jnp.asarray(seg),
                n_b,
            )
        out[valid] = np.asarray(res, dtype=np.int64)
    else:
        idx = np.nonzero(valid)[0]
        for k, b in enumerate(idx.tolist()):
            out[b] = data[s[k] : e[k]].sum(axis=0)
    return out


def _reduce_nice_sharded(data, seg, n_blocks):
    """Segment-sum with the site axis sharded over the device mesh.

    Each shard sums its local sites into a full-width (n_blocks+1, C)
    partial table (a block straddling a shard boundary receives partial sums
    from both sides); a psum over `sites` assembles the exact integer totals.
    Device analogue of the reference's per-file Pool + np.add.reduceat
    (ref: beta_to_blocks.py:101-105, 198-206).
    """
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import make_mesh, pad_to_multiple
    from ..parallel.sharded import shard_map

    mesh = make_mesh()
    nsh = mesh.shape["sites"]
    data_p = pad_to_multiple(np.asarray(data, dtype=np.int32), nsh)
    seg_p = pad_to_multiple(np.asarray(seg, dtype=np.int32), nsh,
                            fill=n_blocks)  # pad rows drop into the gap id

    def f(d, sg):
        part = jax.ops.segment_sum(d, sg, num_segments=n_blocks + 1,
                                   indices_are_sorted=True)
        return jax.lax.psum(part, "sites")

    fn = jax.jit(shard_map(f, mesh, in_specs=(P("sites", None), P("sites")),
                           out_specs=P(None, None)))
    return np.asarray(fn(jnp.asarray(data_p), jnp.asarray(seg_p)))[:n_blocks]


def _segment_ids(s, e, n, n_blocks):
    """int32[n] mapping site offset -> covering block id (n_blocks = none)."""
    seg = np.full(n, n_blocks, dtype=np.int32)
    lengths = (e - s).astype(np.int64)
    nz = lengths > 0
    ids = np.repeat(np.arange(n_blocks, dtype=np.int32)[nz], lengths[nz])
    offs = np.repeat(s[nz] - np.concatenate([[0], np.cumsum(lengths[nz])[:-1]]),
                     lengths[nz])
    pos = np.arange(ids.shape[0], dtype=np.int64) + offs
    seg[pos] = ids
    return seg
