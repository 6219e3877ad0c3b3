"""ctypes bindings for the native IO library (native/wgbsio.cpp).

Built on demand with g++ into native/build/; all callers fall back to the
pure-Python implementations when the toolchain or build is unavailable, so
the native layer is an accelerator, never a hard dependency.
"""

import ctypes
import os
import os.path as op
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_NATIVE_DIR = op.join(op.dirname(op.dirname(op.dirname(op.abspath(__file__)))),
                      "native")
_SRCS = [op.join(_NATIVE_DIR, "wgbsio.cpp"),
         op.join(_NATIVE_DIR, "segment_exact.cpp")]
_BUILD_DIR = op.join(_NATIVE_DIR, "build")
_SO = op.join(_BUILD_DIR, "libwgbsio.so")


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("WGBS_TPU_NO_NATIVE"):
        return None
    try:
        newest_src = max(op.getmtime(s) for s in _SRCS)
        if not op.isfile(_SO) or op.getmtime(_SO) < newest_src:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            subprocess.check_call(
                ["g++", "-O3", "-shared", "-fPIC", "-o", _SO] + _SRCS
                + ["-lz", "-lpthread"],
                stderr=subprocess.DEVNULL,
            )
        lib = ctypes.CDLL(_SO)
        _bind_symbols(lib)
    except Exception:
        # includes AttributeError from a stale cached .so missing a newer
        # symbol: honor the module contract (return None, callers fall back)
        return None

    _LIB = lib
    return _LIB


def _bind_symbols(lib):
    i64 = ctypes.c_int64
    lib.pat_scan.restype = ctypes.c_int
    # void_p (not char_p) so sub-range ADDRESSES can be passed for the
    # multithreaded parse (ctypes releases the GIL during the C calls)
    lib.pat_scan.argtypes = [ctypes.c_void_p, i64, ctypes.POINTER(i64),
                             ctypes.POINTER(i64)]
    lib.pat_parse.restype = ctypes.c_int
    lib.pat_parse.argtypes = [ctypes.c_void_p, i64, i64, i64] \
        + [ctypes.c_void_p] * 5 + [ctypes.c_char_p, i64, ctypes.c_void_p]
    lib.pat_serialize.restype = i64
    lib.bgzf_compress_mt.restype = i64
    lib.bgzf_scan_blocks.restype = i64
    lib.bgzf_decompress_mt.restype = ctypes.c_int
    lib.bam_count.restype = i64
    lib.bam_scan.restype = i64
    lib.bam_mmml_scan.restype = i64
    lib.mm_count.restype = i64
    lib.mm_fill.restype = i64
    lib.segment_exact_dp.restype = i64
    lib.segment_exact_dp.argtypes = [
        ctypes.c_void_p, i64, i64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.pat_pileup.restype = None
    lib.pat_pileup.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        i64, i64, i64, i64, ctypes.c_void_p, ctypes.c_int,
    ]


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_pat_native(data: bytes, threads=None):
    """pat text -> SoA arrays via the C++ parser, or None on fallback.

    Large buffers parse in parallel: the text splits at line boundaries
    into per-thread ranges (scan + parse per range, GIL released inside
    the C calls), each range writing its rows directly into the shared
    output at its prefix offset; per-range chromosome tables merge in
    range order, which equals first-appearance order over the whole
    buffer."""
    lib = get_lib()
    if lib is None or not data:
        return None
    view = np.frombuffer(data, dtype=np.uint8)  # zero-copy address anchor
    base = view.ctypes.data
    n_bytes = len(data)
    if threads is None:
        threads = min(os.cpu_count() or 1, 8)
    if n_bytes < (4 << 20):
        threads = 1
    cuts = [0]
    for t in range(1, threads):
        pos = n_bytes * t // threads
        nl = data.find(b"\n", pos)
        pos = n_bytes if nl < 0 else nl + 1
        if pos > cuts[-1]:
            cuts.append(pos)
    if cuts[-1] != n_bytes:
        cuts.append(n_bytes)
    ranges = list(zip(cuts[:-1], cuts[1:]))

    def scan(rng):
        a, b = rng
        nl_ = ctypes.c_int64()
        ml_ = ctypes.c_int64()
        rc = lib.pat_scan(ctypes.c_void_p(base + a), b - a,
                          ctypes.byref(nl_), ctypes.byref(ml_))
        return None if rc != 0 else (nl_.value, ml_.value)

    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(len(ranges)) if len(ranges) > 1 else None
    scans = list(pool.map(scan, ranges)) if pool else [scan(ranges[0])]
    if any(s is None for s in scans):
        if pool:
            pool.shutdown()
        return None
    per_n = [s[0] for s in scans]
    n = sum(per_n)
    L = max(max((s[1] for s in scans), default=1), 1)
    offs = np.concatenate([[0], np.cumsum(per_n)]).astype(np.int64)

    starts = np.empty(n, dtype=np.int32)
    lengths = np.empty(n, dtype=np.int32)
    counts = np.empty(n, dtype=np.int32)
    codes = np.empty((n, L), dtype=np.uint8)
    chrom_ids = np.empty(n, dtype=np.int16)
    extras_off = np.empty(2 * n + 2, dtype=np.int64)
    cbufs = [ctypes.create_string_buffer(65536) for _ in ranges]

    def parse(t):
        a, b = ranges[t]
        o = int(offs[t])
        nt = per_n[t]
        if nt == 0:
            return 0
        return lib.pat_parse(
            ctypes.c_void_p(base + a), b - a, nt, L,
            ctypes.c_void_p(starts.ctypes.data + 4 * o),
            ctypes.c_void_p(lengths.ctypes.data + 4 * o),
            ctypes.c_void_p(counts.ctypes.data + 4 * o),
            ctypes.c_void_p(codes.ctypes.data + L * o),
            ctypes.c_void_p(chrom_ids.ctypes.data + 2 * o),
            cbufs[t], 65536,
            ctypes.c_void_p(extras_off.ctypes.data + 16 * o),
        )
    rcs = list(pool.map(parse, range(len(ranges)))) if pool else \
        [parse(0)]
    if pool:
        pool.shutdown()
    if any(r < 0 for r in rcs):
        return None

    # merge per-range chromosome tables (range order == first appearance)
    chrom_names = []
    cmap = {}
    for t, rc in enumerate(rcs):
        if per_n[t] == 0:
            continue
        local = cbufs[t].value.decode().split("\n")[:rc]
        lut = np.empty(max(rc, 1), dtype=np.int16)
        for i, name in enumerate(local):
            if name not in cmap:
                cmap[name] = len(chrom_names)
                chrom_names.append(name)
            lut[i] = cmap[name]
        sl = slice(int(offs[t]), int(offs[t + 1]))
        if not (np.arange(rc, dtype=np.int16) == lut[:rc]).all():
            chrom_ids[sl] = lut[chrom_ids[sl]]
        # extras offsets are relative to the range start
        extras_off[2 * int(offs[t]) : 2 * int(offs[t + 1])] += ranges[t][0]

    eo = extras_off[: 2 * n].reshape(n, 2)
    extras = None
    if n and (eo[:, 1] > eo[:, 0]).any():
        extras = np.array(
            [data[a:b] if b > a else None for a, b in eo.tolist()],
            dtype=object,
        )
    return starts, lengths, counts, codes, chrom_ids, chrom_names, extras


def serialize_pat_native(starts, lengths, counts, codes, chrom_ids,
                         chrom_names):
    lib = get_lib()
    if lib is None:
        return None
    n, L = codes.shape
    chrom_buf = ("\n".join(chrom_names) + "\n").encode() + b"\x00"
    cap = int(n * (L + 40) + 1024)
    out = ctypes.create_string_buffer(cap)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    chrom_ids = np.ascontiguousarray(chrom_ids, dtype=np.int16)
    w = lib.pat_serialize(
        ctypes.c_int64(n), ctypes.c_int64(L),
        _ptr(starts, ctypes.c_int32), _ptr(lengths, ctypes.c_int32),
        _ptr(counts, ctypes.c_int32), _ptr(codes, ctypes.c_uint8),
        _ptr(chrom_ids, ctypes.c_int16), chrom_buf, out, ctypes.c_int64(cap),
    )
    if w < 0:
        return None
    return out.raw[:w]


def bgzf_compress_native(data: bytes, n_threads=None, level=6):
    lib = get_lib()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    n_blocks = (len(data) + 65279) // 65280
    cap = (n_blocks + 2) * (65280 + 1064) + 64
    out = ctypes.create_string_buffer(cap)
    w = lib.bgzf_compress_mt(data, ctypes.c_int64(len(data)), out,
                             ctypes.c_int(max(n_threads, 1)),
                             ctypes.c_int(level))
    if w < 0:
        return None
    return out.raw[:w]


def bam_scan_native(buf: bytes, records_off: int):
    """Columnar scan of a decompressed BAM record region.

    Returns (cols int32 [n, 8], offs int64 [n, 5], rec_end int64 [n]) where
    cols = [ref_id, pos, flag, mapq, l_seq, n_cigar, first_cigar, l_qname]
    and offs = [qname, cigar, seq, qual, tags] byte offsets, or None.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = lib.bam_count(buf, ctypes.c_int64(len(buf)),
                      ctypes.c_int64(records_off))
    if n < 0:
        return None
    n = int(n)
    cols = np.zeros((max(n, 1), 8), dtype=np.int32)
    offs = np.zeros((max(n, 1), 5), dtype=np.int64)
    rec_end = np.zeros(max(n, 1), dtype=np.int64)
    got = lib.bam_scan(buf, ctypes.c_int64(len(buf)),
                       ctypes.c_int64(records_off), ctypes.c_int64(n),
                       _ptr(cols, ctypes.c_int32), _ptr(offs, ctypes.c_int64),
                       _ptr(rec_end, ctypes.c_int64))
    if got != n:
        return None
    return cols[:n], offs[:n], rec_end[:n]


def bam_mmml_scan_native(buf, tags_off, rec_end):
    """Locate MM/Mm:Z + ML/Ml:B,C aux tags for each record.

    Returns (mm_off, mm_len, ml_off, ml_n) int64 arrays (see wgbsio.cpp for
    the -1 / -9 sentinel conventions), or None when the library is absent.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = tags_off.shape[0]
    tags_off = np.ascontiguousarray(tags_off, dtype=np.int64)
    rec_end = np.ascontiguousarray(rec_end, dtype=np.int64)
    mm_off = np.empty(max(n, 1), dtype=np.int64)
    mm_len = np.empty(max(n, 1), dtype=np.int64)
    ml_off = np.empty(max(n, 1), dtype=np.int64)
    ml_n = np.empty(max(n, 1), dtype=np.int64)
    i64 = ctypes.c_int64
    lib.bam_mmml_scan(buf, i64(n), _ptr(tags_off, i64), _ptr(rec_end, i64),
                      _ptr(mm_off, i64), _ptr(mm_len, i64),
                      _ptr(ml_off, i64), _ptr(ml_n, i64))
    return mm_off[:n], mm_len[:n], ml_off[:n], ml_n[:n]


def mm_parse_native(buf, mm_off, mm_len):
    """Batch-parse all MM tag strings into a flat section table.

    Returns (sec_rec int32[S], sec_mod int8[S], sec_npdot int8[S],
    sec_part_idx int32[S], sec_nskip int64[S], skips int32[K]) where
    sections appear in record order, or None when the library is absent.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = mm_off.shape[0]
    mm_off = np.ascontiguousarray(mm_off, dtype=np.int64)
    mm_len = np.ascontiguousarray(mm_len, dtype=np.int64)
    n_sec = np.empty(max(n, 1), dtype=np.int64)
    n_skip = np.empty(max(n, 1), dtype=np.int64)
    i64 = ctypes.c_int64
    lib.mm_count(buf, i64(n), _ptr(mm_off, i64), _ptr(mm_len, i64),
                 _ptr(n_sec, i64), _ptr(n_skip, i64))
    S = int(n_sec[:n].sum())
    K = int(n_skip[:n].sum())
    sec_rec = np.empty(max(S, 1), dtype=np.int32)
    sec_mod = np.empty(max(S, 1), dtype=np.int8)
    sec_npdot = np.empty(max(S, 1), dtype=np.int8)
    sec_part_idx = np.empty(max(S, 1), dtype=np.int32)
    sec_nskip = np.empty(max(S, 1), dtype=np.int64)
    skips = np.empty(max(K, 1), dtype=np.int32)
    got = lib.mm_fill(buf, i64(n), _ptr(mm_off, i64), _ptr(mm_len, i64),
                      _ptr(sec_rec, ctypes.c_int32),
                      _ptr(sec_mod, ctypes.c_int8),
                      _ptr(sec_npdot, ctypes.c_int8),
                      _ptr(sec_part_idx, ctypes.c_int32),
                      _ptr(sec_nskip, i64), _ptr(skips, ctypes.c_int32))
    if got != S:
        return None
    return (sec_rec[:S], sec_mod[:S], sec_npdot[:S], sec_part_idx[:S],
            sec_nskip[:S], skips[:K])


def bgzf_decompress_native(data: bytes, n_threads=None):
    lib = get_lib()
    if lib is None or not data:
        return None
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    max_blocks = len(data) // 28 + 2
    in_offs = np.empty(max_blocks + 1, dtype=np.int64)
    out_offs = np.empty(max_blocks + 1, dtype=np.int64)
    nb = lib.bgzf_scan_blocks(data, ctypes.c_int64(len(data)),
                              _ptr(in_offs, ctypes.c_int64),
                              _ptr(out_offs, ctypes.c_int64),
                              ctypes.c_int64(max_blocks))
    if nb < 0:
        return None  # plain gzip, not BGZF — caller falls back
    total = int(out_offs[nb])
    out = ctypes.create_string_buffer(max(total, 1))
    rc = lib.bgzf_decompress_mt(data, ctypes.c_int64(len(data)),
                                _ptr(in_offs, ctypes.c_int64),
                                _ptr(out_offs, ctypes.c_int64),
                                ctypes.c_int64(nb), out,
                                ctypes.c_int(max(n_threads, 1)))
    if rc != 0:
        return None
    return out.raw[:total]


def segment_exact_native(data, loci, max_cpg, max_bp, pseudo_count):
    """Exact-parity segmentation DP traceback via the C++ kernel.

    data: (K, n, 2) integer counts; loci: (n,) basepair positions.
    Returns the traceback array T (n+1,) int64, or None on fallback.
    The numeric chain matches the reference segmentor bit-for-bit
    (ref: src/segment_betas/segmentor.cpp:60-159) — see
    native/segment_exact.cpp.
    """
    lib = get_lib()
    if lib is None:
        return None
    K, n, _ = data.shape
    dataf = np.ascontiguousarray(data, dtype=np.float32)
    dists = np.ascontiguousarray(loci, dtype=np.uint32)
    T = np.empty(n + 1, dtype=np.int32)
    rc = lib.segment_exact_dp(
        dataf.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(K),
        ctypes.c_int64(n), dists.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int32(int(max_cpg)),
        ctypes.c_uint32(int(max_bp) if max_bp else 0),
        ctypes.c_float(float(pseudo_count)),
        T.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        return None
    return T.astype(np.int64)


def pileup_native(start, length, count, codes, window_start, n_sites,
                  out=None, threads=None):
    """Host pileup of pat fragments into an int64 (n_sites, 2) [meth, cov]
    table via the C++ kernel (native/wgbsio.cpp::pat_pileup), or None on
    fallback. Same reduction as ops/pileup.py (ref: stdin2beta.cpp:59-93).

    `start` must be sorted ascending when threads > 1 (threads partition the
    site axis and binary-search their fragment range). Adds into `out` when
    given (must be zero-initialized by the first caller).
    """
    lib = get_lib()
    if lib is None:
        return None
    start = np.ascontiguousarray(start, dtype=np.int32)
    length = np.ascontiguousarray(length, dtype=np.int32)
    count = np.ascontiguousarray(count, dtype=np.int32)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    f = start.shape[0]
    max_len = codes.shape[1] if codes.ndim == 2 else 0
    if out is None:
        out = np.zeros((n_sites, 2), dtype=np.int64)
    assert out.shape == (n_sites, 2) and out.dtype == np.int64 \
        and out.flags.c_contiguous
    if threads is None:
        threads = min(os.cpu_count() or 1, 8)
    lib.pat_pileup(
        start.ctypes.data_as(ctypes.c_void_p),
        length.ctypes.data_as(ctypes.c_void_p),
        count.ctypes.data_as(ctypes.c_void_p),
        codes.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(f), ctypes.c_int64(max_len),
        ctypes.c_int64(int(window_start)), ctypes.c_int64(int(n_sites)),
        out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(int(threads)))
    return out
