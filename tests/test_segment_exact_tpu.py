"""Device exact-parity segmentation (models/segment_exact_tpu.py): the
float64 DP's traceback must equal the host exact path bit-for-bit — same
borders on every input, not statistically close."""

import numpy as np
import pytest

from wgbs_tools_tpu.models.segment import (_cost_block_exact, _dp_exact,
                                           _prefix_sums, _traceback,
                                           segment_borders)
from wgbs_tools_tpu.models.segment_exact_tpu import (build_ll_table,
                                                     max_band_total,
                                                     segment_exact_device_T)


def _host_T(data, loci, W, max_bp, pc):
    pm, pt = _prefix_sums(data)
    n = loci.shape[0]
    C = _cost_block_exact(pm, pt, loci, 0, n, W, max_bp, pc)
    return _dp_exact(C)


def _rand_window(rng, K, n, cov_hi, bp_step=60):
    cov = rng.integers(0, cov_hi, size=(K, n))
    meth = rng.binomial(cov, rng.random((K, n, 1))[:, :, 0])
    data = np.stack([meth, cov], axis=2)
    loci = np.cumsum(rng.integers(2, bp_step, size=n)) + 100
    return data, loci


@pytest.mark.parametrize("K,n,cov_hi,W,max_bp", [
    (1, 220, 5, 32, 2000),
    (3, 300, 12, 48, 2000),
    (5, 256, 25, 64, 1500),
    (2, 400, 8, 64, 0),        # no bp cap
    (4, 180, 60, 32, 800),     # high coverage, tight band
])
def test_device_T_equals_host_T(K, n, cov_hi, W, max_bp):
    rng = np.random.default_rng(100 * K + n)
    data, loci = _rand_window(rng, K, n, cov_hi)
    T_dev = segment_exact_device_T(data, loci, W, max_bp, 15.0)
    assert T_dev is not None
    T_host = _host_T(data, loci, W, max_bp, 15.0)
    assert np.array_equal(T_dev[1:], T_host[1:]), \
        np.flatnonzero(T_dev[1:] != T_host[1:])[:10]


def test_device_borders_equal_exact_mode():
    """End-to-end: borders from the device DP == segment_borders exact."""
    rng = np.random.default_rng(77)
    data, loci = _rand_window(rng, 3, 500, 10)
    want = segment_borders(data, loci, max_cpg=64, max_bp=2000, mode="exact")
    T = segment_exact_device_T(data, loci, 64, 2000, 15.0)
    got = _traceback(T, loci.shape[0])
    assert np.array_equal(got, want)


def test_device_ties_and_zero_coverage():
    """Zero-coverage stretches produce exact cost ties — the first-argmax
    tie-break must match the reference scan order."""
    rng = np.random.default_rng(78)
    data, loci = _rand_window(rng, 2, 300, 3)
    data[:, 50:150] = 0  # long empty stretch: many exactly-equal candidates
    T_dev = segment_exact_device_T(data, loci, 40, 2000, 15.0)
    T_host = _host_T(data, loci, 40, 2000, 15.0)
    assert np.array_equal(T_dev[1:], T_host[1:])


def test_pseudocount_variants():
    rng = np.random.default_rng(79)
    data, loci = _rand_window(rng, 2, 250, 8)
    for pc in (1.0, 15.0, 0.5):
        T_dev = segment_exact_device_T(data, loci, 32, 2000, pc)
        T_host = _host_T(data, loci, 32, 2000, pc)
        assert np.array_equal(T_dev[1:], T_host[1:]), pc


def test_cap_fallback_and_nonmonotone():
    rng = np.random.default_rng(80)
    data, loci = _rand_window(rng, 1, 100, 5)
    assert segment_exact_device_T(data, loci, 16, 2000, 15.0,
                                  cap_limit=4) is None  # cap exceeded
    bad = loci.copy()
    bad[50] = bad[49] - 10  # non-monotone
    assert segment_exact_device_T(data, bad, 16, 2000, 15.0) is None


def test_ll_table_matches_cost_chain():
    """Table entries equal the reference chain emulation bit-for-bit."""
    tbl = build_ll_table(15.0, 64)
    pm = np.zeros((1, 2), dtype=np.int64)
    for nt in (1, 5, 33, 63):
        for nm in (0, nt // 2, nt):
            pm = np.array([[0, nm]], dtype=np.int64)
            pt = np.array([[0, nt]], dtype=np.int64)
            C = _cost_block_exact(pm, pt, np.array([100]), 0, 1, 1, 0, 15.0)
            want = np.float32(C[0, 0])
            got = tbl[nt * (nt + 1) // 2 + nm]
            assert got.view(np.uint32) == want.view(np.uint32), (nm, nt)


def test_max_band_total():
    data = np.zeros((2, 6, 2), dtype=np.int64)
    data[0, :, 1] = [1, 2, 3, 4, 5, 6]
    data[1, :, 1] = 1
    loci = np.array([100, 150, 200, 250, 300, 1000])
    # max_bp=200: from start 0 the band spans sites 0..4 (dist 0..200)
    got = max_band_total(data, loci, 6, 200)
    assert got == 1 + 2 + 3 + 4 + 5


def test_segment_borders_env_routes_to_device(monkeypatch):
    """WGBS_TPU_SEGMENT_EXACT_DEVICE=1 routes exact mode through the device
    DP and produces the same borders as the host path."""
    rng = np.random.default_rng(81)
    data, loci = _rand_window(rng, 2, 300, 8)
    want = segment_borders(data, loci, max_cpg=48, max_bp=2000, mode="exact")
    from wgbs_tools_tpu.models import segment as seg_mod

    monkeypatch.setattr(seg_mod, "DEVICE_EXACT_MIN_SITES", 2)
    monkeypatch.setenv("WGBS_TPU_SEGMENT_EXACT_DEVICE", "1")
    got = segment_borders(data, loci, max_cpg=48, max_bp=2000, mode="exact")
    assert np.array_equal(got, want)


def test_batched_device_equals_sequential():
    """Batched (vmapped) device DP == per-window device DP == host, with a
    non-multiple-of-batch count and one ineligible window mixed in."""
    rng = np.random.default_rng(82)
    wins = [_rand_window(rng, 2, 180, 7) for _ in range(5)]
    datas = np.stack([d for d, _ in wins])
    locis = np.stack([l for _, l in wins]).astype(np.int64)
    locis[3, 90] = locis[3, 89] - 5  # non-monotone -> host fallback slot
    from wgbs_tools_tpu.models.segment_exact_tpu import (
        segment_exact_device_batch)

    Ts = segment_exact_device_batch(datas, locis, 24, 2000, 15.0, batch=2)
    assert Ts[3] is None
    for w in range(5):
        if w == 3:
            continue
        T_host = _host_T(datas[w], locis[w], 24, 2000, 15.0)
        assert np.array_equal(Ts[w][1:], T_host[1:]), w


def test_segment_ranges_exact_device(monkeypatch, tmp_path):
    """segment_ranges with the device exact mode produces the same blocks
    as the host exact mode."""
    from wgbs_tools_tpu.formats.beta import save_beta
    from wgbs_tools_tpu.models.segment import SegmentConfig, segment_ranges

    rng = np.random.default_rng(83)
    n = 1200
    data, loci = _rand_window(rng, 2, n, 9)

    class _Idx:
        pass

    idx = _Idx()
    idx.loci = np.concatenate([loci, loci[-1:] + 100])
    paths = []
    for d in range(2):
        p = str(tmp_path / f"s{d}.beta")
        save_beta(p, data[d].astype(np.uint8))
        paths.append(p)
    cfg = SegmentConfig(max_cpg=32, max_bp=2000, chunk_size=400,
                        mode="exact", threads=1)
    want = segment_ranges(paths, [(1, n + 1)], idx, cfg)
    from wgbs_tools_tpu.models import segment as seg_mod

    monkeypatch.setattr(seg_mod, "DEVICE_EXACT_MIN_SITES", 2)
    monkeypatch.setenv("WGBS_TPU_SEGMENT_EXACT_DEVICE", "1")
    got = segment_ranges(paths, [(1, n + 1)], idx, cfg)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("K,n,cov_hi,W,max_bp", [
    (3, 2000, 20, 200, 2000),   # ~30x K=3, the production shape scaled down
    (1, 1500, 60, 128, 1000),   # high coverage, one dataset
    (4, 1200, 6, 256, 0),       # no bp cap: full-width band
    (2, 1800, 2, 96, 2000),     # near-empty coverage: exact-tie stretches
])
def test_f64_device_T_equals_native_cpp(K, n, cov_hi, W, max_bp):
    """The float64 device DP (under scoped x64) reproduces the C++ kernel
    (native/segment_exact.cpp) bit-for-bit: same traceback, every site."""
    from wgbs_tools_tpu.native import segment_exact_native

    rng = np.random.default_rng(1000 * K + n)
    data, loci = _rand_window(rng, K, n, cov_hi)
    T_nat = segment_exact_native(data, loci, W, max_bp, 15.0)
    if T_nat is None:
        pytest.skip("native library unavailable")
    T_dev = segment_exact_device_T(data, loci, W, max_bp, 15.0)
    assert np.array_equal(T_dev[1:], T_nat[1:]), \
        np.flatnonzero(T_dev[1:] != T_nat[1:])[:10]
