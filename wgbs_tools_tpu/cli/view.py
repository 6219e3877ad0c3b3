"""view / cview: render pat and beta files as text, filtered by region/blocks.

Mirrors the reference's view/cview composition (ref: src/python/view.py,
cview.py): pat goes through region/blocks filtering + optional subsample +
sort + collapse; beta prints `chr  loc-1  loc+1  meth  cov` rows
(ref: src/view_beta.sh).
"""

import sys

import numpy as np

from ..formats.beta import load_beta
from ..formats.blocks import load_blocks
from ..formats.pat import PatFrags, frags_to_bytes, read_pat
from ..genome.region import GenomicRegion
from ..ops.frag_ops import filter_by_blocks, sample_frags
from ..utils import IllegalArgumentError


def view_pat(pat_path, genome, region=None, sites=None, bed_file=None,
             strict=False, strip=False, min_len=1, no_gaps=False,
             sub_sample=None, seed=None, no_sort=False) -> PatFrags:
    """Load + filter a pat file, returning sorted/collapsed fragments."""
    gr = GenomicRegion(region=region, sites=sites, genome=genome)
    if bed_file is not None:
        blocks = load_blocks(bed_file)
        bstart, bend = blocks["startCpG"], blocks["endCpG"]
        keep = bstart >= 0
        bstart, bend = bstart[keep], bend[keep]
        order = np.argsort(bstart, kind="stable")
        bstart, bend = bstart[order], bend[order]
        if len(bstart):
            # bound the read to the blocks' site envelope (index-seekable,
            # overlap-inclusive) instead of materializing the whole pat —
            # the reference likewise tabixes only extended block regions
            # (ref: src/python/cview.py:82-101). Whole-genome bed files
            # still stream through iter_view_pat in the CLI paths.
            lo = int(bstart[0])
            hi = int(bend.max())
            frags = read_pat(pat_path, region_sites=(lo, hi))
        else:
            frags = read_pat(pat_path, region_sites=(1, 1))
    elif gr.is_whole():
        frags = read_pat(pat_path)
        bstart = np.array([1])
        bend = np.array([genome.get_nr_sites() + 1])
    else:
        s, e = gr.sites
        frags = read_pat(pat_path, region_sites=(s, e))
        bstart, bend = np.array([s]), np.array([e])

    frags = filter_by_blocks(frags, bstart, bend, strict=strict, strip=strip,
                             min_cpgs=min_len, no_gaps=no_gaps)
    if sub_sample is not None:
        if sub_sample < 0:
            raise IllegalArgumentError("sub-sampling rate must be >= 0")
        # rate > 0.25 handled by doubling reps (ref: cview.py:55-67); rates
        # above 1 (coverage-boosting mixes) duplicate reads the same way
        # (ref: mix_pat.py:108-111)
        ss, rep = sub_sample, 1
        while ss > 0.25:
            rep *= 2
            ss /= 2
        frags = sample_frags(frags, ss, reps=rep, seed=seed)
    if not no_sort:
        frags = frags.sort().collapse()
    return frags


def view_beta_text(beta_path, genome, region=None, sites=None, bed_file=None,
                   out=None):
    """beta -> text rows `chr  loc-1  loc+1  meth  cov`, optionally
    restricted to bed regions (replaces the reference's
    `| bedtools intersect` post-filter, ref: view.py:47-50)."""
    out = out or sys.stdout
    gr = GenomicRegion(region=region, sites=sites, genome=genome)
    idx = genome.index
    if gr.is_whole():
        s, e = 1, idx.nr_sites + 1
    else:
        s, e = gr.sites
    data = load_beta(beta_path, sites=(s, e))
    loci = idx.loci[s - 1 : e - 1]
    cids = idx.site2chrom_id(np.arange(s, e))
    names = idx.chrom_names
    keep = None
    if bed_file is not None:
        blocks = load_blocks(bed_file)
        valid = blocks["startCpG"] >= 0
        bstart = blocks["startCpG"][valid]
        bend = blocks["endCpG"][valid]
        order = np.argsort(bstart, kind="stable")
        bstart, bend = bstart[order], bend[order]
        site_ids = np.arange(s, e)
        j = np.searchsorted(bstart, site_ids, side="right") - 1
        jc = np.clip(j, 0, max(len(bstart) - 1, 0))
        be_max = np.maximum.accumulate(bend) if len(bend) else bend
        keep = (j >= 0) & (len(bend) > 0) & (site_ids < be_max[jc])
    # vectorized row formatting: a whole-genome view is 28M rows — a
    # per-row f-string loop takes minutes; numpy digit matrices build the
    # same bytes in seconds (chunked to bound memory)
    n_rows = e - s
    step = 1 << 20
    for lo in range(0, n_rows, step):
        hi = min(lo + step, n_rows)
        sel = slice(lo, hi)
        if keep is not None:
            m = keep[sel]
            if not m.any():
                continue
            loc = loci[sel][m].astype(np.int64)
            cid = cids[sel][m]
            d = data[sel][m]
        else:
            loc = loci[sel].astype(np.int64)
            cid = cids[sel]
            d = data[sel]
        out.write(tsv_lines([_name_field(cid, names), _int_field(loc - 1),
                             _int_field(loc + 1), _int_field(d[:, 0]),
                             _int_field(d[:, 1])]).decode())


_DIGITS = np.frombuffer(b"0123456789", dtype=np.uint8)


def _int_field(v):
    """Decimal text of non-negative integers as a (chars, mask) pair of
    (n, w) arrays: row i's text is chars[i][mask[i]]."""
    v = np.asarray(v, dtype=np.int64)
    if v.size and v.min() < 0:
        raise ValueError("negative value in a non-negative text column")
    w = len(str(int(v.max()))) if v.size else 1
    p = 10 ** np.arange(w - 1, -1, -1, dtype=np.int64)
    chars = _DIGITS[(v[:, None] // p[None, :]) % 10]
    mask = (v[:, None] >= p[None, :]) | (np.arange(w) == w - 1)[None, :]
    return chars, mask


def _name_field(codes, names):
    """names[codes[i]] as a (chars, mask) pair."""
    enc = [n.encode() for n in names]
    w = max((len(b) for b in enc), default=1)
    mat = np.zeros((len(enc), w), dtype=np.uint8)
    for i, b in enumerate(enc):
        mat[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    lens = np.array([len(b) for b in enc], dtype=np.int64)
    codes = np.asarray(codes, dtype=np.int64)
    return mat[codes], np.arange(w)[None, :] < lens[codes][:, None]


def tsv_lines(fields):
    """Tab-separated, newline-terminated lines from (chars, mask) fields."""
    n = fields[0][0].shape[0]
    chars, masks = [], []
    for i, (c, m) in enumerate(fields):
        sep = ord("\n") if i == len(fields) - 1 else ord("\t")
        chars += [c, np.full((n, 1), sep, dtype=np.uint8)]
        masks += [m, np.ones((n, 1), dtype=bool)]
    return np.concatenate(chars, axis=1)[np.concatenate(masks, axis=1)] \
        .tobytes()


def print_frags(frags, out=None):
    out = out or sys.stdout
    data = frags_to_bytes(frags)
    if hasattr(out, "buffer"):
        out.buffer.write(data)
    elif isinstance(out, str):
        mode = "wb"
        if out.endswith(".gz"):
            from ..formats.bgzf import BgzfWriter

            with BgzfWriter(out) as w:
                w.write(data)
            return
        with open(out, mode) as f:
            f.write(data)
    else:
        try:
            out.write(data)
        except TypeError:  # text-mode stream (e.g. StringIO)
            out.write(data.decode())
