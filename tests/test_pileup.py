import numpy as np
import pytest

from tests.oracle import run_oracle
from tests.synth import random_frags
from wgbs_tools_tpu.formats.pat import frags_to_bytes
from wgbs_tools_tpu.ops.pileup import pileup_frags, pileup_xla


def ref_pileup(frags, start, end):
    """Run the reference stdin2beta oracle on the same fragments."""
    out = run_oracle("stdin2beta", [start, end], frags_to_bytes(frags))
    return np.array(out.split(), dtype=np.int64).reshape(-1, 2)


def numpy_pileup(frags, start, end):
    """Direct numpy emulation of stdin2beta.cpp:59-93."""
    n = end - start
    meth = np.zeros(n, dtype=np.int64)
    cov = np.zeros(n, dtype=np.int64)
    for i in range(frags.nr_frags):
        s, l, c = int(frags.start[i]), int(frags.length[i]), int(frags.count[i])
        for j in range(l):
            idx = s - start + j
            if not 0 <= idx < n:
                continue
            code = frags.codes[i, j]
            if code == 3:
                continue
            cov[idx] += c
            if code in (1, 2):
                meth[idx] += c
    return np.stack([meth, cov], axis=1)


def test_pileup_xla_matches_numpy(rng):
    frags = random_frags(rng, 800, 5000, max_len=14, h_rate=0.1)
    got = pileup_xla(frags.start, frags.length, frags.count, frags.codes, 1, 5000)
    expect = numpy_pileup(frags, 1, 5001)
    assert (got == expect).all()


def test_pileup_window_edges(rng):
    frags = random_frags(rng, 500, 3000, max_len=10)
    # window strictly inside: reads crossing both edges must clip correctly
    got = pileup_xla(frags.start, frags.length, frags.count, frags.codes, 1000, 500)
    expect = numpy_pileup(frags, 1000, 1500)
    assert (got == expect).all()


def test_pileup_matches_reference_oracle(rng):
    frags = random_frags(rng, 1500, 8000, max_len=16, h_rate=0.05)
    start, end = 1, 8001
    expect = ref_pileup(frags, start, end)
    got = pileup_xla(
        frags.start, frags.length, frags.count, frags.codes, start, end - start
    )
    assert got.shape == expect.shape
    assert (got == expect).all()


def test_pileup_oracle_subwindow(rng):
    frags = random_frags(rng, 1000, 6000, max_len=12)
    start, end = 2000, 4000
    expect = ref_pileup(frags, start, end)
    got = np.asarray(
        pileup_frags(frags, (start, end))
    )
    assert (got == expect).all()


def test_pileup_batched_accumulation(rng):
    frags = random_frags(rng, 2000, 4000, max_len=8)
    full = pileup_xla(frags.start, frags.length, frags.count, frags.codes, 1, 4000)
    batched = pileup_xla(
        frags.start, frags.length, frags.count, frags.codes, 1, 4000, batch=333
    )
    assert (full == batched).all()


def test_device_total_accumulator_matches_host(rng):
    """Device-resident running total == host int64 total, and finalize()
    == trim_to_uint of the counts (incl. dtype)."""
    from wgbs_tools_tpu.formats.beta import trim_to_uint
    from wgbs_tools_tpu.ops.pileup import PileupAccumulator

    frags = random_frags(rng, 30_000, 100_000, max_len=20, max_count=9)
    win = (1, 100_021)
    a_host = PileupAccumulator(win, device_total=False)
    a_dev = PileupAccumulator(win, device_total=True)
    for lo in range(0, frags.nr_frags, 7_000):
        sl = frags.take(slice(lo, min(lo + 7_000, frags.nr_frags)))
        a_host.add(sl)
        a_dev.add(sl)
    assert np.array_equal(a_host.result(), a_dev.result())
    for lbeta in (False, True):
        fh, fd = a_host.finalize(lbeta), a_dev.finalize(lbeta)
        assert fh.dtype == fd.dtype
        assert np.array_equal(fh, fd)
        assert np.array_equal(fh, trim_to_uint(a_host.result(), lbeta))


def test_saturate_device_counts_exact(rng):
    """Device saturation is byte-identical to the reference float64 chain,
    including coverage-overflow rows, exact-integer ratios, and the
    compaction-cap fallback."""
    import jax.numpy as jnp

    from wgbs_tools_tpu.formats.beta import trim_to_uint
    from wgbs_tools_tpu.ops.pileup import saturate_device_counts

    counts = np.zeros((2048, 2), np.int64)
    counts[:, 1] = rng.integers(0, 5000, 2048)
    counts[:, 0] = (counts[:, 1] * rng.random(2048)).astype(np.int64)
    counts[0] = [300, 765]   # meth*255/cov exactly 100
    counts[1] = [2, 510]     # exactly 1
    counts[2] = [255, 256]
    counts[3] = [0, 0]
    counts[4] = [256, 256]
    dev = jnp.asarray(counts, jnp.int32)
    for lbeta, mult in ((False, 1), (True, 37)):
        ref = trim_to_uint(counts * mult, lbeta)
        got = saturate_device_counts(jnp.asarray(counts * mult, jnp.int32),
                                     lbeta)
        assert got.dtype == ref.dtype
        assert np.array_equal(ref, got)
    # cap smaller than the overflow count: exact host fallback
    ref = trim_to_uint(counts, False)
    assert np.array_equal(ref, saturate_device_counts(dev, False, cap=4))


def test_fetch_chunked_edges():
    import jax.numpy as jnp

    from wgbs_tools_tpu.ops.pileup import fetch_chunked

    x = jnp.arange(1003 * 2, dtype=jnp.int32).reshape(1003, 2)
    for mb in (8, 128, 4096, 1 << 20):
        assert np.array_equal(fetch_chunked(x, max_bytes=mb), np.asarray(x))

def test_pileup_native_matches_oracle(rng):
    """C++ host pileup (native/wgbsio.cpp::pat_pileup) == reference
    stdin2beta == xla path, threaded (sorted input) and single-thread."""
    from wgbs_tools_tpu.native import pileup_native

    frags = random_frags(rng, 4000, 9000, max_len=18, h_rate=0.07)
    start, end = 1, 9001
    if pileup_native(frags.start, frags.length, frags.count, frags.codes,
                     start, end - start, threads=1) is None:
        pytest.skip("native library unavailable")
    expect = ref_pileup(frags, start, end)
    for threads in (1, 2, 4):
        got = pileup_native(frags.start, frags.length, frags.count,
                            frags.codes, start, end - start, threads=threads)
        assert np.array_equal(got, expect), threads
    # subwindow clipping (fragments crossing both edges)
    got = pileup_native(frags.start, frags.length, frags.count, frags.codes,
                        3000, 2000, threads=3)
    assert np.array_equal(got, numpy_pileup(frags, 3000, 5000))


def test_pileup_native_threaded_partition(rng):
    """The multithreaded native branch (site-axis partition + lower_bound
    fragment ranges, wgbsio.cpp) only engages at >= 1<<16 fragments; exercise
    it for real against the single-thread result and the numpy oracle,
    including a subwindow whose edges fall inside thread partitions."""
    from wgbs_tools_tpu.native import pileup_native

    n_frags = (1 << 16) + 4_321
    frags = random_frags(rng, n_frags, 50_000, max_len=20, max_count=4,
                         h_rate=0.03)
    order = np.argsort(frags.start, kind="stable")
    frags = frags.take(order)  # threaded path requires sorted starts
    if pileup_native(frags.start, frags.length, frags.count, frags.codes,
                     1, 50_000, threads=1) is None:
        pytest.skip("native library unavailable")
    expect = numpy_pileup(frags, 1, 50_001)
    for threads in (2, 3, 4, 8):
        got = pileup_native(frags.start, frags.length, frags.count,
                            frags.codes, 1, 50_000, threads=threads)
        assert np.array_equal(got, expect), threads
    # subwindow: partition boundaries + window clipping together
    got = pileup_native(frags.start, frags.length, frags.count, frags.codes,
                        17_001, 9_000, threads=4)
    assert np.array_equal(got, numpy_pileup(frags, 17_001, 26_001))


def test_backend_env_override_only_applies_to_auto(rng, monkeypatch):
    """WGBS_TPU_PILEUP must not override an explicitly requested backend
    (keeps A/B comparisons meaningful); native+device_total=True must
    resolve to a host total without crashing."""
    from wgbs_tools_tpu.native import get_lib
    from wgbs_tools_tpu.ops.pileup import PileupAccumulator

    if get_lib() is None:
        pytest.skip("native library unavailable")
    monkeypatch.setenv("WGBS_TPU_PILEUP", "native")
    a = PileupAccumulator((1, 1001), backend="xla", device_total=False)
    assert a.backend == "xla"
    a = PileupAccumulator((1, 1001), backend="auto", device_total=False)
    assert a.backend == "native"
    monkeypatch.delenv("WGBS_TPU_PILEUP")
    # explicit native + device_total=True: total must be a host array and
    # add() must not feed a device array to the C++ kernel
    a = PileupAccumulator((1, 2001), backend="native", device_total=True)
    assert not a.device_total
    assert isinstance(a.total, np.ndarray)
    frags = random_frags(rng, 300, 2000, max_len=8)
    a.add(frags)
    assert np.array_equal(a.result(), numpy_pileup(frags, 1, 2001))


def test_native_accumulator_matches_host(rng):
    """PileupAccumulator(backend='native') == the array-path accumulator,
    streaming chunks, including unsorted chunk handling."""
    from wgbs_tools_tpu.native import get_lib
    from wgbs_tools_tpu.ops.pileup import PileupAccumulator

    if get_lib() is None:
        pytest.skip("native library unavailable")
    frags = random_frags(rng, 25_000, 80_000, max_len=16, max_count=5)
    win = (1, 80_017)
    a_ref = PileupAccumulator(win, backend="xla", device_total=False)
    a_nat = PileupAccumulator(win, backend="native")
    assert not a_nat.device_total
    perm = np.random.default_rng(3).permutation(frags.nr_frags)
    for lo in range(0, frags.nr_frags, 6_000):
        sl = frags.take(slice(lo, min(lo + 6_000, frags.nr_frags)))
        a_ref.add(sl)
        a_nat.add(sl)
    # one deliberately unsorted chunk (forces the single-thread guard)
    shuf = frags.take(perm[:5_000])
    a_ref.add(shuf)
    a_nat.add(shuf)
    assert np.array_equal(a_ref.result(), a_nat.result())
    assert np.array_equal(a_ref.finalize(), a_nat.finalize())


def _frags(starts, lengths, counts, codes):
    from wgbs_tools_tpu.formats.pat import PatFrags

    n = len(starts)
    return PatFrags(np.asarray(starts, np.int32), np.asarray(lengths, np.int32),
                    np.asarray(counts, np.int32), np.asarray(codes, np.uint8),
                    np.zeros(n, np.int16), ["chr1"], None)


def _boundary_crossers(rng):
    # heterogeneous counts (one past 2^16) on fragments straddling
    # power-of-two site boundaries
    from wgbs_tools_tpu.formats.pat import CODE_C

    starts = [120, 125, 126, 127, 128, 1020, 1023, 1024, 2047, 2048]
    return (_frags(starts, [10] * 10, [1, 7, 1, 250000, 1, 2, 2, 1, 3, 1],
                   np.full((10, 10), CODE_C)), 1, 3072)


def _dense(rng, count_lo, count_hi):
    F = 3000
    lengths = rng.integers(1, 30, size=F)
    codes = rng.integers(0, 4, size=(F, 30))
    codes[np.arange(30)[None] >= lengths[:, None]] = 3
    return (_frags(np.sort(rng.integers(1, 200, size=F)), lengths,
                   rng.integers(count_lo, count_hi, size=F), codes), 1, 1024)


PILEUP_CASES = {
    "small": lambda r: (random_frags(r, 400, 2000, max_len=12, h_rate=0.05),
                        1, 2000),
    "multi_batch": lambda r: (random_frags(r, 9000, 5000, max_len=20,
                                           dot_rate=0.1), 1, 5000),
    "offset_window": lambda r: (random_frags(r, 2000, 6000, max_len=16),
                                2500, 2048),
    "long_fragments": lambda r: (random_frags(r, 300, 9000, max_len=400),
                                 1, 9000),
    "counts_past_255": lambda r: (random_frags(r, 300, 4000, max_len=10,
                                               max_count=3000, dot_rate=0.1,
                                               h_rate=0.05), 1, 4000),
    "boundary_crossers": _boundary_crossers,
    "dense_overlap": lambda r: _dense(r, 1, 4),
    "dense_counts_near_255": lambda r: _dense(r, 200, 256),
    "sparse": lambda r: (random_frags(r, 60, 50000, max_len=10), 1, 50000),
    "single_fragment": lambda r: (random_frags(r, 1, 1500, max_len=5),
                                  1, 1500),
    "empty": lambda r: (_frags([], [], [], np.zeros((0, 4))), 1, 1500),
    "window_inside": lambda r: (random_frags(r, 500, 3000, max_len=10),
                                1000, 500),
}


@pytest.mark.parametrize("case", sorted(PILEUP_CASES))
def test_pileup_scenarios(case):
    """XLA scatter (the GPU path) == host C++ kernel == the numpy loop over
    stdin2beta.cpp's rule, on scenarios that stress batching, window
    edges, long fragments, high counts and deep overlap (batch=4096 makes
    the larger cases span several padded launches)."""
    from wgbs_tools_tpu.native import get_lib, pileup_native

    rng = np.random.default_rng(sorted(PILEUP_CASES).index(case) + 31)
    frags, ws, wl = PILEUP_CASES[case](rng)
    expect = numpy_pileup(frags, ws, ws + wl)
    got = pileup_xla(frags.start, frags.length, frags.count, frags.codes,
                     ws, wl, batch=4096)
    assert got.shape == (wl, 2) and np.array_equal(got, expect)
    if get_lib() is not None:
        nat = pileup_native(frags.start, frags.length, frags.count,
                            frags.codes, ws, wl, threads=1)
        assert np.array_equal(nat, expect)
