"""Device-side methylation calling + mate merging (bam2pat on the chip).

Re-expresses pipeline/calling.py::call_reads_mat and merge_pe_mat
(themselves array-native translations of ref: src/pipeline_wgbs/
patter.cpp:105-184 and patter_utils.cpp:292-342) as jitted JAX kernels over
fixed launch shapes:

  - reads arrive as a zero-padded (R, L) uint8 sequence matrix (already
    CIGAR-normalized on host — ragged string work stays off-device);
  - the chromosome's CpG loci live on device; each kernel binary-searches
    its reads' windows and gathers the covered loci itself;
  - each read's calls occupy a dense (R, K) slot window (K = padded max
    CpGs per read; PE merged reads are <= MAX_PE_PAT_LEN sites by format);
  - results return as 2-bit-packed pat codes (K/4 bytes per read), packed
    on the device and unpacked by a host LUT (4x less device->host copy).

Everything is integer gathers/selects, so results are bit-identical to the
numpy path (and hence to the reference binaries, which the numpy path is
byte-compared against).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

DOT = ord(".")
B_C, B_T, B_G, B_A = ord("C"), ord("T"), ord("G"), ord("A")
MAX_PE_PAT_LEN = 300  # ref: patter_utils.h:21

# call chars <-> 2-bit codes (formats/pat.py convention: T=0 C=1 H=2 .=3)
_CHAR2CODE = np.full(256, 3, dtype=np.uint8)
_CHAR2CODE[B_T] = 0
_CHAR2CODE[B_C] = 1
_CHAR2CODE[ord("H")] = 2
_CODE2CHAR = np.frombuffer(b"TCH.", dtype=np.uint8)


def _pack2bit(codes):
    """(R, K) uint8 codes -> (R, K//4) packed, K multiple of 4. (device)"""
    R, K = codes.shape
    c = codes.reshape(R, K // 4, 4).astype(jnp.uint32)
    packed = (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
              | (c[..., 3] << 6))
    return packed.astype(jnp.uint8)


def _unpack2bit_host(packed, K):
    R = packed.shape[0]
    out = np.empty((R, K), dtype=np.uint8)
    for t in range(4):
        out[:, t::4] = (packed >> (2 * t)) & 3
    return out


@partial(jax.jit, static_argnames=("K", "clip"))
def _call_kernel(seqmat, lens, pos1, bottom, loci_dev, K, clip):
    """seqmat (R,L) u8; loci_dev (n,) i32 chromosome CpG loci (device-
    resident). Returns (k0 i32 (R,), first i32 (R,), span i32 (R,),
    packed u8 (R,K//4) 2-bit pat codes aligned to each read's first call)."""
    R, L = seqmat.shape
    n = loci_dev.shape[0]
    pos1 = pos1.astype(jnp.int32)
    k0 = jnp.searchsorted(loci_dev, pos1, side="left").astype(jnp.int32)
    k1 = jnp.searchsorted(loci_dev, pos1 + lens.astype(jnp.int32),
                          side="left").astype(jnp.int32)
    nvalid = k1 - k0

    kcols = jnp.arange(K, dtype=jnp.int32)[None, :]
    valid = kcols < nvalid[:, None]
    kk = jnp.minimum(k0[:, None] + kcols, n - 1)
    loci_g = loci_dev[kk]

    i = loci_g - pos1[:, None]
    j = i + bottom[:, None].astype(jnp.int32)
    n_r = lens[:, None].astype(jnp.int32)
    jn = jnp.clip(j, 0, L - 1)
    s = jnp.take_along_axis(seqmat, jn, axis=1)
    prev = jnp.take_along_axis(seqmat, jnp.clip(j - 1, 0, L - 1), axis=1)
    nxt = jnp.take_along_axis(seqmat, jnp.clip(j + 1, 0, L - 1), axis=1)

    bot = bottom[:, None].astype(bool)
    iscpg = jnp.where(
        bot,
        (j > 0) & ((s == B_G) | (s == B_A)) & (prev == B_C),
        (j < n_r - 1) & ((s == B_C) | (s == B_T)) & (nxt == B_G),
    )
    ref_chr = jnp.where(bot, B_G, B_C)
    unmeth_chr = jnp.where(bot, B_A, B_T)
    codes = jnp.full((R, K), 3, dtype=jnp.uint8)  # 3 = '.'
    codes = jnp.where(iscpg & (s == unmeth_chr), 0, codes)  # T
    codes = jnp.where(iscpg & (s == ref_chr), 1, codes)  # C
    if clip > 0:
        codes = jnp.where((j >= clip) & (j < n_r - clip), codes, 3)
    codes = jnp.where((j >= 0) & (j < n_r) & valid, codes, 3)

    known = codes != 3
    any_ = known.any(axis=1)
    first = jnp.argmax(known, axis=1).astype(jnp.int32)
    last = (K - 1 - jnp.argmax(known[:, ::-1], axis=1)).astype(jnp.int32)
    span = jnp.where(any_, last - first + 1, 0).astype(jnp.int32)

    oidx = first[:, None] + kcols
    aligned = jnp.take_along_axis(codes, jnp.clip(oidx, 0, K - 1), axis=1)
    aligned = jnp.where(kcols < span[:, None], aligned, 3).astype(jnp.uint8)
    first = jnp.where(any_, first, -1)
    return k0, first, span, _pack2bit(aligned)


@partial(jax.jit, static_argnames=("W",))
def _merge_kernel(s1, p1, sp1, s2, p2, sp2, W):
    """Mate merging on device over 2-bit CODES (3 = unknown); same selection
    rules as merge_pe_mat. p1/p2: (n,S) u8 codes. Returns (start i32 (n,),
    span i32, packed u8 (n,W//4), too_long bool)."""
    S = p1.shape[1]
    swap = s1 > s2
    a_s = jnp.where(swap, s2, s1)
    b_s = jnp.where(swap, s1, s2)
    a_sp = jnp.where(swap, sp2, sp1)
    b_sp = jnp.where(swap, sp1, sp2)
    a_p = jnp.where(swap[:, None], p2, p1)
    b_p = jnp.where(swap[:, None], p1, p2)

    last = jnp.maximum(a_s + a_sp, b_s + b_sp)
    width = last - a_s
    too_long = width > MAX_PE_PAT_LEN
    cols = jnp.arange(W, dtype=jnp.int32)[None, :]
    A = jnp.where(cols < a_sp[:, None],
                  a_p[:, jnp.minimum(jnp.arange(W), S - 1)], 3)
    bidx = cols - (b_s - a_s)[:, None]
    validB = (bidx >= 0) & (bidx < b_sp[:, None])
    B = jnp.where(validB,
                  jnp.take_along_axis(b_p, jnp.clip(bidx, 0, S - 1), axis=1),
                  3)
    merged = jnp.where(A == 3, B, jnp.where((B != 3) & (A != B), 3, A))
    merged = jnp.where(cols < jnp.minimum(width, W)[:, None], merged, 3)

    known = merged != 3
    any_ = known.any(axis=1) & ~too_long
    firstc = jnp.argmax(known, axis=1).astype(jnp.int32)
    lastc = (W - 1 - jnp.argmax(known[:, ::-1], axis=1)).astype(jnp.int32)
    span = jnp.where(any_, lastc - firstc + 1, 0).astype(jnp.int32)
    starts = jnp.where(any_, (a_s + firstc).astype(jnp.int32), -1)
    oidx = firstc[:, None] + cols
    patm = jnp.take_along_axis(merged, jnp.clip(oidx, 0, W - 1), axis=1)
    patm = jnp.where(cols < span[:, None], patm, 3).astype(jnp.uint8)
    return starts, span, _pack2bit(patm), too_long


def _pow2(n, lo=256):
    b = lo
    while b < n:
        b <<= 1
    return b


_LOCI_CACHE = {}


def _loci_device(loci):
    key = (id(loci), loci.shape[0])
    hit = _LOCI_CACHE.get(key)
    if hit is None:
        dev = jnp.asarray(np.ascontiguousarray(loci, dtype=np.int32))
        _LOCI_CACHE.clear()  # keep at most one chromosome resident
        # hold the host array too so its id cannot be recycled while cached
        _LOCI_CACHE[key] = (loci, dev)
        return dev
    return hit[1]


def call_reads_device(positions, flags, paired, loci, site_base, seqmat,
                      lens, clip=0, chunk=1 << 17):
    """Drop-in device replacement for calling.call_reads_mat (mbias excluded
    — m-bias runs stay on the host path). Returns (start, patmat-of-chars,
    span) with identical values/dtypes. All chunks are dispatched before the
    first fetch; outputs come back 2-bit packed (K/4 bytes per read)."""
    from ..pipeline.calling import FREVERSE

    R = seqmat.shape[0]
    no_calls = (np.full(R, -1, dtype=np.int64),
                np.full((R, 1), DOT, dtype=np.uint8),
                np.zeros(R, dtype=np.int64))
    if R == 0:
        return no_calls
    lens = np.asarray(lens, dtype=np.int64)
    pos1 = np.asarray(positions, dtype=np.int64)
    flags = np.asarray(flags, dtype=np.int64)
    if paired:
        bottom = ((flags & 0x53) == 83) | ((flags & 0xA3) == 163)
    else:
        bottom = (flags & FREVERSE) != 0

    # K bound: CpGs per read <= ceil(max read len / 2) (a CpG every 2 bp)
    Lmax = int(lens.max(initial=0))
    K = _pow2(min(Lmax // 2 + 2, 1 << 17), lo=16)
    L = seqmat.shape[1]
    L_b = (L + 31) // 32 * 32
    loci_dev = _loci_device(loci)

    outs = []
    for lo in range(0, R, chunk):
        hi = min(lo + chunk, R)
        n = hi - lo
        Rb = _pow2(n)
        sl = slice(lo, hi)
        seq_b = np.zeros((Rb, L_b), dtype=np.uint8)
        seq_b[:n, :L] = seqmat[sl]
        lens_b = np.zeros(Rb, dtype=np.int32)
        lens_b[:n] = lens[sl]
        pos_b = np.ones(Rb, dtype=np.int32)
        pos_b[:n] = pos1[sl]
        bot_b = np.zeros(Rb, dtype=np.int32)
        bot_b[:n] = bottom[sl]
        outs.append((n, sl, _call_kernel(
            jnp.asarray(seq_b), jnp.asarray(lens_b), jnp.asarray(pos_b),
            jnp.asarray(bot_b), loci_dev, K, int(clip))))

    starts = np.full(R, -1, dtype=np.int64)
    spans = np.zeros(R, dtype=np.int64)
    pats = np.full((R, K), 3, dtype=np.uint8)
    for n, sl, (k0, first, span, packed) in outs:
        k0 = np.asarray(k0)[:n].astype(np.int64)
        first = np.asarray(first)[:n]
        spans[sl] = np.asarray(span)[:n]
        has = first >= 0
        starts[sl] = np.where(has, site_base + k0 + first, -1)
        pats[sl] = _unpack2bit_host(np.asarray(packed)[:n], K)
    maxspan = max(int(spans.max(initial=1)), 1)
    return starts, _CODE2CHAR[pats[:, :maxspan]], spans


def merge_pe_device(s1, pat1, sp1, s2, pat2, sp2):
    """Drop-in device replacement for calling.merge_pe_mat (char matrices
    in/out; codes on the wire)."""
    n = s1.shape[0]
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros((0, 1), np.uint8),
                np.zeros(0, np.int64), np.zeros(0, bool))
    S = max(pat1.shape[1], pat2.shape[1], 1)

    def pad_codes(p):
        out = np.full((p.shape[0], S), 3, dtype=np.uint8)
        out[:, : p.shape[1]] = _CHAR2CODE[p]
        return out

    Rb = _pow2(n)

    def padR(a, fill=0):
        out = np.full((Rb,) + a.shape[1:], fill, dtype=a.dtype)
        out[:n] = a
        return out

    W = MAX_PE_PAT_LEN
    starts, span, packed, too_long = _merge_kernel(
        jnp.asarray(padR(np.asarray(s1, np.int32))),
        jnp.asarray(padR(pad_codes(pat1), fill=3)),
        jnp.asarray(padR(np.asarray(sp1, np.int32))),
        jnp.asarray(padR(np.asarray(s2, np.int32), fill=1)),
        jnp.asarray(padR(pad_codes(pat2), fill=3)),
        jnp.asarray(padR(np.asarray(sp2, np.int32))),
        W)
    starts = np.asarray(starts)[:n].astype(np.int64)
    span = np.asarray(span)[:n].astype(np.int64)
    too_long = np.asarray(too_long)[:n]
    codes = _unpack2bit_host(np.asarray(packed)[:n], W)
    Wout = max(int(span.max(initial=1)), 1)
    return starts, _CODE2CHAR[codes[:, :Wout]], span, too_long
