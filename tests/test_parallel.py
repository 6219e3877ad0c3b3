"""Sharded (samples x sites) pipeline correctness on the virtual CPU mesh."""

import numpy as np
import jax.numpy as jnp
import pytest

import jax

from tests.synth import random_frags
from wgbs_tools_tpu.ops.pileup import pileup_xla
from wgbs_tools_tpu.parallel.mesh import make_mesh
from wgbs_tools_tpu.parallel.sharded import bucket_fragments, build_analysis_step


@pytest.mark.parametrize("samples_axis,sites_shards", [(1, 8), (2, 4), (4, 2)])
def test_sharded_pileup_matches_single_device(rng, samples_axis, sites_shards):
    if len(jax.devices()) < samples_axis * sites_shards:
        pytest.skip("not enough devices")
    n_sites = 256 * sites_shards
    frags = random_frags(rng, 600, n_sites - 40, max_len=14)
    n_samples = samples_axis  # one sample per shard for simplicity
    sample_counts = np.zeros((n_samples, n_sites, 2), dtype=np.int32)
    loci = np.cumsum(np.full(n_sites, 10, dtype=np.int64)).astype(np.int32)

    mesh = make_mesh(samples_axis * sites_shards, samples_axis=samples_axis)
    rs, ln, cn, cd = bucket_fragments(
        frags.start, frags.length, frags.count, frags.codes, n_sites,
        sites_shards,
    )
    step = build_analysis_step(mesh, n_sites, halo=32, W=16, max_bp=0, pc=15.0)
    counts, tb, cov_lo, cov_f = step(
        jnp.asarray(rs), jnp.asarray(ln), jnp.asarray(cn), jnp.asarray(cd),
        jnp.asarray(sample_counts), jnp.asarray(loci[:, None]),
    )

    expect = pileup_xla(frags.start, frags.length, frags.count, frags.codes,
                        1, n_sites)
    got = np.asarray(counts)
    assert (got == expect).all()
    from wgbs_tools_tpu.parallel.sharded import decode_sum64
    assert decode_sum64(cov_lo, cov_f) == int(expect[:, 1].sum())
    assert tb.shape == (n_sites,)


def test_decode_sum64_past_int32(rng):
    """The overflow-safe coverage total is exact past 2^31 (the int64->int32
    silent truncation this replaces) and at wrap-adjacent values."""
    from wgbs_tools_tpu.parallel.sharded import _psum64, decode_sum64

    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    mesh = make_mesh(4, samples_axis=1)
    from jax.sharding import PartitionSpec as P
    from wgbs_tools_tpu.parallel.sharded import shard_map

    def f(x):
        lo, fl = _psum64(x, ("sites",))
        return lo, fl

    step = jax.jit(shard_map(f, mesh, in_specs=(P("sites"),),
                             out_specs=(P(), P())))
    for total in (2**31 + 12345, 2**32 - 7, 2**32 + 3, 3 * 2**32 + 2**31,
                  2**40 + 987654321, 1000, 0):
        n = 1 << 12
        base, rem = divmod(total, n)
        assert base < 2**31
        x = np.full(n, base, dtype=np.int64)
        x[:rem] += 1
        lo, fl = step(jnp.asarray(x, jnp.int32))
        assert decode_sum64(lo, fl) == total, total


def test_halo_crossing_reads(rng):
    """Fragments deliberately straddling shard boundaries."""
    from wgbs_tools_tpu.formats.pat import PatFrags, CODE_C

    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    sites_shards = 4
    n_sites = 256 * sites_shards
    starts = np.array([250, 255, 256, 511, 512, 767, 1000], dtype=np.int32)
    lengths = np.full(7, 12, dtype=np.int32)
    counts = np.arange(1, 8, dtype=np.int32)
    codes = np.full((7, 12), CODE_C, dtype=np.uint8)
    frags = PatFrags(starts, lengths, counts, codes,
                     np.zeros(7, dtype=np.int16), ["chr1"], None)

    mesh = make_mesh(4, samples_axis=1)
    rs, ln, cn, cd = bucket_fragments(starts, lengths, counts, codes, n_sites,
                                      sites_shards)
    step = build_analysis_step(mesh, n_sites, halo=32, W=8, max_bp=0, pc=1.0)
    sample_counts = np.zeros((1, n_sites, 2), dtype=np.int32)
    loci = np.arange(1, n_sites + 1, dtype=np.int32) * 3
    out, _, _, _ = step(
        jnp.asarray(rs), jnp.asarray(ln), jnp.asarray(cn), jnp.asarray(cd),
        jnp.asarray(sample_counts), jnp.asarray(loci[:, None]),
    )
    expect = pileup_xla(starts, lengths, counts, codes, 1, n_sites)
    assert (np.asarray(out) == expect).all()


def test_segment_windows_sharded_matches_single_device(rng):
    """Window-sharded fast segmentation == per-window single-device result,
    including the pad-to-device-count path (5 windows on 8 devices)."""
    from wgbs_tools_tpu.models.segment import segment_borders
    from wgbs_tools_tpu.parallel.sharded import segment_windows_sharded

    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    n, K, nw = 600, 2, 5
    datas = np.zeros((nw, K, n, 2), dtype=np.int64)
    locis = np.zeros((nw, n), dtype=np.int64)
    for w in range(nw):
        cov = rng.integers(1, 20, size=(K, n))
        meth = rng.binomial(cov, rng.random((K, 1)))
        datas[w, :, :, 0] = meth
        datas[w, :, :, 1] = cov
        locis[w] = np.cumsum(rng.integers(2, 100, size=n)) + 50
    mesh = make_mesh(8, samples_axis=2)
    got = segment_windows_sharded(mesh, datas, locis, max_cpg=150,
                                  max_bp=2000, pseudo_count=15.0)
    assert len(got) == nw
    for w in range(nw):
        single = segment_borders(datas[w], locis[w], 150, 2000, 15.0,
                                 mode="fast")
        assert got[w].tolist() == single.tolist()


def test_sharded_pileup_streaming_matches_xla(rng, tmp_path):
    """ShardedPileup over streamed chunks == one-shot single-device pileup,
    with fragments longer than a shard crossing several boundaries."""
    from wgbs_tools_tpu.parallel.sharded import ShardedPileup

    n_sites = 400
    frags = random_frags(rng, 3000, n_sites - 120, max_len=120).sort().collapse()
    mesh = make_mesh(8, samples_axis=1)
    acc = ShardedPileup(mesh, (1, n_sites + 1))
    assert acc.S == 50 and int(frags.length.max()) > 2 * acc.S
    # stream in uneven chunks
    bounds = [0, 700, 1100, 2500, frags.nr_frags]
    for a, b in zip(bounds[:-1], bounds[1:]):
        acc.add(frags.take(np.arange(a, b)))
    got = acc.result()
    expect = pileup_xla(frags.start, frags.length, frags.count, frags.codes,
                        1, n_sites)
    assert (got == expect).all()


def test_sharded_pileup_v3_streaming_matches_xla(rng):
    """ShardedPileup (XLA scatter per shard, boundary-clipped, no halo)
    over streamed chunks == one-shot single-device pileup, each shard's
    total on its own device."""
    from wgbs_tools_tpu.parallel.sharded import ShardedPileup

    n_sites = 40000
    frags = random_frags(rng, 5000, n_sites - 50, max_len=18).sort().collapse()
    mesh = make_mesh(8, samples_axis=1)
    acc = ShardedPileup(mesh, (1, n_sites + 1))
    bounds = [0, 700, 1100, 2500, frags.nr_frags]
    for a, b in zip(bounds[:-1], bounds[1:]):
        acc.add(frags.take(np.arange(a, b)))
    assert [t.devices() for t in acc.totals] == [{d} for d in acc.devices]
    assert len(set(acc.devices)) == 8
    got = acc.result()
    expect = pileup_xla(frags.start, frags.length, frags.count, frags.codes,
                        1, n_sites)
    assert (got == expect).all()
    # finalize (device saturation over the assembled sharded table)
    from wgbs_tools_tpu.formats.beta import trim_to_uint

    assert (acc.finalize(False) ==
            trim_to_uint(expect.astype(np.int64), False)).all()


def test_sharded_pileup_v3_uneven_tail(rng):
    """Last shard shorter than S (n not divisible by the shard count)."""
    from wgbs_tools_tpu.parallel.sharded import ShardedPileup

    n_sites = 40000 - 1234
    frags = random_frags(rng, 3000, n_sites - 30, max_len=12).sort().collapse()
    mesh = make_mesh(8, samples_axis=1)
    acc = ShardedPileup(mesh, (1, n_sites + 1))
    acc.add(frags)
    expect = pileup_xla(frags.start, frags.length, frags.count, frags.codes,
                        1, n_sites)
    assert (acc.result() == expect).all()


def test_pat2beta_sharded_equals_single(rng, tmp_path, mini_genome):
    """Production pat2beta: mesh path byte-identical to single device."""
    from wgbs_tools_tpu.formats.pat import write_pat
    from wgbs_tools_tpu.pipeline.pat2beta import pat2beta

    nr = mini_genome.index.nr_sites
    frags = random_frags(rng, 4000, nr - 40, max_len=16).sort().collapse()
    pat = str(tmp_path / "s.pat.gz")
    write_pat(frags, pat)
    p1 = pat2beta(pat, out_dir=str(tmp_path), genome=mini_genome,
                  sharded=False, out_path=str(tmp_path / "single.beta"),
                  chunk_bytes=1 << 16)
    p2 = pat2beta(pat, out_dir=str(tmp_path), genome=mini_genome,
                  sharded=True, out_path=str(tmp_path / "sharded.beta"),
                  chunk_bytes=1 << 16)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()


def test_analysis_step_window_tb_matches_single_device(rng):
    """The fused step's traceback = the single-device fast DP run
    independently on each shard's window (the documented contract)."""
    from wgbs_tools_tpu.models.segment import _traceback
    from wgbs_tools_tpu.parallel.sharded import (_dp_scan,
                                                 _segment_cost_local)

    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    sites_shards, samples_axis = 4, 2
    S = 256
    n_sites = S * sites_shards
    K, W = 2, 32
    cov = rng.integers(1, 25, size=(K, n_sites))
    meth = rng.binomial(cov, np.repeat(rng.random((K, n_sites // 64)), 64,
                                       axis=1))
    sample_counts = np.stack([meth, cov], axis=-1).astype(np.int32)
    loci = (np.cumsum(rng.integers(2, 60, size=n_sites)) + 9).astype(np.int32)

    mesh = make_mesh(8, samples_axis=samples_axis)
    step = build_analysis_step(mesh, n_sites, halo=16, W=W, max_bp=1500,
                               pc=15.0)
    F = 8  # a few fragments; the tb does not depend on them
    rs, ln, cn, cd = bucket_fragments(
        np.arange(1, F + 1, dtype=np.int32) * 100,
        np.full(F, 4, np.int32), np.ones(F, np.int32),
        np.full((F, 4), 1, np.uint8), n_sites, sites_shards)
    _, tb, _, _ = step(jnp.asarray(rs), jnp.asarray(ln), jnp.asarray(cn),
                    jnp.asarray(cd), jnp.asarray(sample_counts),
                    jnp.asarray(loci[:, None]))
    tb = np.asarray(tb)

    for w in range(sites_shards):
        sl = slice(w * S, (w + 1) * S)
        cost = jnp.zeros((S, W), dtype=jnp.float32)
        for d in range(K):
            cost = cost + _segment_cost_local(
                jnp.asarray(sample_counts[d, sl]), jnp.asarray(loci[sl]), W,
                1500, 15.0)
        ks = np.asarray(_dp_scan(cost, W))
        T_single = np.concatenate([[0], ks]).astype(np.int64)
        T_shard = np.concatenate([[0], tb[sl]]).astype(np.int64)
        b1 = _traceback(T_single, S)
        b2 = _traceback(T_shard, S)
        assert b1.tolist() == b2.tolist(), f"window {w} borders differ"


def test_reduce_blocks_sharded_matches_single(rng):
    """Sharded segment-sum block reduction == single-device (boundary-
    straddling blocks get partial sums psum'd across shards)."""
    from wgbs_tools_tpu.ops.reduceat import (_reduce_nice, _reduce_nice_sharded,
                                             _segment_ids)

    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    N = 1 << 12
    data = rng.integers(0, 200, size=(N, 2)).astype(np.int32)
    # random sorted non-overlapping blocks, several crossing the 512-site
    # shard boundaries
    cuts = np.sort(rng.choice(np.arange(1, N), 300, replace=False))
    s = np.concatenate([[0], cuts])
    e = np.concatenate([cuts, [N]])
    keep = rng.random(s.shape[0]) < 0.8  # gaps between some blocks
    s, e = s[keep], e[keep]
    seg = _segment_ids(s, e, N, s.shape[0])
    expect = np.asarray(_reduce_nice(jnp.asarray(data), jnp.asarray(seg),
                                     s.shape[0]))
    got = _reduce_nice_sharded(data, seg, s.shape[0])
    assert (got == expect).all()


def test_sharded_pileup_finalize_exact(rng):
    """ShardedPileup.finalize == trim_to_uint of the counts (saturation on
    the mesh, overflow rows patched exactly on host)."""
    from wgbs_tools_tpu.formats.beta import trim_to_uint
    from wgbs_tools_tpu.parallel.sharded import ShardedPileup

    n_sites = 4096
    # dense coverage so some sites exceed uint8 coverage
    frags = random_frags(rng, 8000, n_sites - 50, max_len=18,
                         max_count=40).sort().collapse()
    mesh = make_mesh(8, samples_axis=1)
    acc = ShardedPileup(mesh, (1, n_sites + 1))
    acc.add(frags)
    counts = acc.result()
    assert (counts[:, 1] > 255).any()  # the overflow path is exercised
    for lbeta in (False, True):
        ref = trim_to_uint(counts.astype(np.int64), lbeta)
        got = acc.finalize(lbeta)
        assert got.dtype == ref.dtype
        assert np.array_equal(ref, got)


def test_sharded_pileup_replicated_samples_axis(rng):
    """On a (samples=2, sites=4) mesh every device still takes one site
    range: eight shards, each fetched and saturated once."""
    from wgbs_tools_tpu.formats.beta import trim_to_uint
    from wgbs_tools_tpu.parallel.sharded import ShardedPileup

    n_sites = 20000
    frags = random_frags(rng, 3000, n_sites - 30, max_len=12).sort().collapse()
    acc = ShardedPileup(make_mesh(8, samples_axis=2), (1, n_sites + 1))
    assert acc.n_shards == 8 and acc.S == 2500
    acc.add(frags)
    expect = pileup_xla(frags.start, frags.length, frags.count, frags.codes,
                        1, n_sites)
    assert np.array_equal(acc.result(), expect)
    assert np.array_equal(acc.finalize(False),
                          trim_to_uint(expect.astype(np.int64), False))
