"""find_markers: differentially-methylated region discovery across sample
groups (ref: src/python/find_markers.py, fm_load_params.py, dmb.py).

The screening pipeline per target group: coverage/NA filters, U/M direction
scans with mean + quantile delta thresholds, then t-test / Mann-Whitney /
M-value t-test column statistics. Defaults mirror
supplemental/find_markers_defaults.txt.
"""

import csv
import os.path as op
import warnings

import numpy as np

from ..formats.beta import beta2vec
from ..formats.blocks import load_blocks
from ..utils import IllegalArgumentError, eprint, mkdirp, pretty_name

DEFAULTS = dict(
    blocks_path=None, groups_file=None, targets=None, background=None,
    betas=None, min_bp=0, max_bp=10_000_000_000, min_cpg=0,
    max_cpg=10_000_000_000, min_cov=5, na_rate_tg=0.334, na_rate_bg=0.334,
    only_hyper=False, only_hypo=False, delta_means=0.3, delta_quants=0.0,
    tg_quant=0.25, bg_quant=0.025, unmeth_quant_thresh=1.0,
    meth_quant_thresh=0.0, unmeth_mean_thresh=1.0, meth_mean_thresh=0.0,
    out_dir=".", top=None, header=False, verbose=False, chunk_size=150000,
    pval=0.05, test_type="t", sort_by=None, delta_maxmin=-1,
)


class MarkerParams:
    """Layered config: defaults < config file < explicit kwargs
    (ref: fm_load_params.py:14-44)."""

    def __init__(self, config_file=None, **kwargs):
        for k, v in DEFAULTS.items():
            setattr(self, k, v)
        if config_file:
            for k, v in _load_param_file(config_file).items():
                setattr(self, k, v)
        for k, v in kwargs.items():
            if v is None:
                continue
            if isinstance(v, bool) and not v:
                continue
            setattr(self, k, v)
        self.validate()

    def validate(self):
        if self.only_hyper and self.only_hypo:
            raise IllegalArgumentError(
                "at most one of (only_hyper, only_hypo) can be specified")
        for key in ("na_rate_tg", "na_rate_bg", "tg_quant", "bg_quant",
                    "unmeth_quant_thresh", "meth_quant_thresh",
                    "unmeth_mean_thresh", "meth_mean_thresh", "pval"):
            v = float(getattr(self, key))
            if not 0 <= v <= 1:
                raise IllegalArgumentError(f"{key} must be in [0, 1]")
        for key in ("delta_means", "delta_quants", "delta_maxmin"):
            v = float(getattr(self, key))
            if not -1 <= v <= 1:
                raise IllegalArgumentError(f"{key} must be in [-1, 1]")
        if self.test_type not in ("t", "mw", "m_t"):
            raise IllegalArgumentError("test_type must be t, mw or m_t")

    def as_dict(self):
        return {k: getattr(self, k) for k in DEFAULTS}


def _load_param_file(path):
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line or ":" not in line:
                continue
            key, val = line.split(":", 1)
            val = val.strip()
            if val in ("NA", "None", ""):
                val = None
            elif val == "True":
                val = True
            elif val == "False":
                val = False
            elif key.strip() == "targets":
                val = val.split()
            else:
                try:
                    val = int(val)
                except ValueError:
                    try:
                        val = float(val)
                    except ValueError:
                        pass
            out[key.strip()] = val
    return out


def _read_groups_csv(groups_file):
    """Header + rows of a groups csv; '#' starts a comment."""
    with open(groups_file, newline="") as f:
        lines = [l.split("#", 1)[0] for l in f]
    rows = [r for r in csv.reader(l for l in lines if l.strip())]
    if not rows:
        raise IllegalArgumentError(f"empty groups file: {groups_file}")
    return [h.strip() for h in rows[0]], rows[1:]


def load_groups(groups_file, betas):
    """(fnames, groups, paths) from a groups csv (ref: dmb.py:24-80): the
    first column names a beta by prefix, `group` its group, an optional
    boolean `include` column drops rows. Groups that are all integers
    compare as integers, as the reference's pandas reader makes them."""
    header, rows = _read_groups_csv(groups_file)
    if "group" not in header:
        raise IllegalArgumentError('groups file must have a "group" column')
    gi = header.index("group")
    ii = header.index("include") if "include" in header else None
    fnames, groups = [], []
    for r in rows:
        r = [c.strip() for c in r] + [""] * (len(header) - len(r))
        if ii is not None and r[ii].lower() not in ("true", "1"):
            continue
        if r[0] and r[gi]:
            fnames.append(r[0])
            groups.append(r[gi])
    if groups and all(g.lstrip("-").isdigit() for g in groups):
        groups = [int(g) for g in groups]
    paths = []
    for prefix in fnames:
        matches = [b for b in betas
                   if op.basename(b) in (prefix + ".beta", prefix + ".lbeta")
                   or pretty_name(b) == prefix]
        if not matches:
            raise IllegalArgumentError(f"no beta file for prefix {prefix}")
        paths.append(matches[0])
    return fnames, groups, paths


def build_block_table(blocks, fnames, paths, min_cov):
    """(block columns, sample names, blocks x samples methylation matrix
    with NaN below min_cov)."""
    from ..cli.cmd_beta import reduce_beta_to_blocks

    names = list(dict.fromkeys(fnames))
    path_of = dict(zip(fnames, paths))
    mat = np.stack([beta2vec(reduce_beta_to_blocks(path_of[n], blocks),
                             min_cov=min_cov) for n in names], axis=1)
    cols = {k: np.asarray(blocks[k]) for k in
            ("chr", "start", "end", "startCpG", "endCpG")}
    return cols, names, mat.astype(np.float64)


def _take(tab, keep):
    """Row subset of a table (dict of equal-length columns)."""
    return {k: v[keep] for k, v in tab.items()}


def _find_x_markers(tab, tg, bg, p, tg_quant, bg_quant):
    """Direction scan (ref: find_markers.py:335-369). tg = hypo group;
    tab["_M"] holds the sample matrix, tg/bg its column indices."""
    M = tab["_M"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        tab = dict(tab, delta_maxmin=np.nanmin(M[:, bg], axis=1)
                   - np.nanmax(M[:, tg], axis=1),
                   tg_mean=np.nanmean(M[:, tg], axis=1),
                   bg_mean=np.nanmean(M[:, bg], axis=1))
    tab["delta_means"] = tab["bg_mean"] - tab["tg_mean"]
    with np.errstate(invalid="ignore"):
        keep = ((tab["tg_mean"] <= p.unmeth_mean_thresh)
                & (tab["bg_mean"] >= p.meth_mean_thresh)
                & (tab["delta_means"] >= p.delta_means)
                & (tab["delta_maxmin"] >= p.delta_maxmin))
    tab = _take(tab, keep)
    if not keep.any():
        return tab
    M = tab["_M"]
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        tab["tg_quant"] = np.nanquantile(M[:, tg], 1 - tg_quant, axis=1)
        tab["bg_quant"] = np.nanquantile(M[:, bg], bg_quant, axis=1)
    tab["delta_quants"] = tab["bg_quant"] - tab["tg_quant"]
    with np.errstate(invalid="ignore"):
        keep = ((tab["tg_quant"] <= p.unmeth_quant_thresh)
                & (tab["bg_quant"] >= p.meth_quant_thresh)
                & (tab["delta_quants"] >= p.delta_quants))
    return _take(tab, keep)


def _n_rows(tab):
    return tab["_M"].shape[0]


def _add_tests(tab, tg, bg, p):
    """t-test / MW / M-value t-test columns (ref: find_markers.py:203-316).
    A row whose p-value is NaN passes the p-value filter."""
    from scipy.stats import mannwhitneyu, ttest_1samp, ttest_ind

    n = _n_rows(tab)
    if n == 0:
        return tab
    single = len(tg) == len(bg) == 1

    def _tt(a, b, equal_var=True):
        if single:
            return np.full(a.shape[0], np.nan)
        if a.shape[1] == 1:
            return ttest_1samp(b, a, axis=1, nan_policy="omit").pvalue
        if b.shape[1] == 1:
            return ttest_1samp(a, b, axis=1, nan_policy="omit").pvalue
        return ttest_ind(a, b, axis=1, nan_policy="omit",
                         equal_var=equal_var).pvalue

    def _filter(tab, col):
        with np.errstate(invalid="ignore"):
            return _take(tab, ~(np.asarray(tab[col]) > p.pval))

    M = tab["_M"]
    tab = dict(tab, ttest=np.asarray(_tt(M[:, tg], M[:, bg]), float))
    if p.test_type == "t":
        tab = _filter(tab, "ttest")
        if _n_rows(tab) == 0:
            return tab
    M = tab["_M"]
    if single:
        tab["mw_test"] = np.full(M.shape[0], np.nan)
    else:
        try:
            r = mannwhitneyu(M[:, tg], M[:, bg], axis=1, nan_policy="omit",
                             alternative="two-sided")
            tab["mw_test"] = np.asarray(r.pvalue, float)
        except ValueError:
            tab["mw_test"] = np.full(M.shape[0], np.nan)
    if p.test_type == "mw":
        tab = _filter(tab, "mw_test")
        if _n_rows(tab) == 0:
            return tab
    c = np.clip(tab["_M"], 1e-4, 1 - 1e-4)
    mv = np.log2(c / (1 - c))
    tab["mvalue_ttest"] = np.asarray(_tt(mv[:, tg], mv[:, bg],
                                         equal_var=False), float)
    if p.test_type == "m_t":
        tab = _filter(tab, "mvalue_ttest")
    return tab


def find_markers(params: MarkerParams, betas, blocks_path=None,
                 groups_file=None):
    """Run the full marker scan; returns {target: table (dict of column
    arrays)} and writes Markers.<group>.bed + params.txt under out_dir."""
    p = params
    blocks_path = blocks_path or p.blocks_path
    groups_file = groups_file or p.groups_file
    if not blocks_path or not groups_file:
        raise IllegalArgumentError("blocks_path and groups_file are required")

    fnames, gcol, paths = load_groups(groups_file, betas)
    groups = sorted(set(gcol))
    targets = p.targets if p.targets else groups
    background = p.background if p.background else groups

    blocks = load_blocks(blocks_path)
    lencpg = blocks["endCpG"] - blocks["startCpG"]
    lenbp = blocks["end"] - blocks["start"]
    keep = (
        (blocks["startCpG"] >= 0)
        & (lencpg >= p.min_cpg) & (lencpg <= p.max_cpg)
        & (lenbp >= p.min_bp) & (lenbp <= p.max_bp)
    )
    blocks = {k: v[keep] for k, v in blocks.items()}

    mkdirp(p.out_dir)
    _dump_params(p, betas)

    cols, names, mat = build_block_table(blocks, fnames, paths, p.min_cov)
    col_of = {n: i for i, n in enumerate(names)}
    results = {}
    for target in targets:
        tg_names = list(dict.fromkeys(
            f for f, g in zip(fnames, gcol) if g == target))
        bg_names = [f for f in dict.fromkeys(
            f for f, g in zip(fnames, gcol) if g in background)
            if f not in tg_names]
        if not bg_names or not tg_names:
            continue
        tg = [col_of[n] for n in tg_names]
        bg = [col_of[n] for n in bg_names]
        present = ~np.isnan(mat)
        keep = ((present[:, tg].sum(axis=1) / len(tg) >= 1 - p.na_rate_tg)
                & (present[:, bg].sum(axis=1) / len(bg)
                   >= 1 - p.na_rate_bg))
        tab = _take(dict(cols, _M=mat), keep)

        parts = []
        if not p.only_hyper:  # U (hypo) markers
            tU = _find_x_markers(tab, tg, bg, p, p.tg_quant, p.bg_quant)
            if _n_rows(tU):
                tU["direction"] = np.full(_n_rows(tU), "U")
                parts.append(tU)
        if not p.only_hypo:  # M (hyper) markers: swap roles
            tM = _find_x_markers(tab, bg, tg, p, p.bg_quant, p.tg_quant)
            if _n_rows(tM):
                tM["tg_mean"], tM["bg_mean"] = tM["bg_mean"], tM["tg_mean"]
                tM["direction"] = np.full(_n_rows(tM), "M")
                parts.append(tM)
        if parts:
            tab = {k: np.concatenate([t[k] for t in parts])
                   for k in parts[0]}
        else:
            tab = _take(tab, np.zeros(_n_rows(tab), bool))
        tab = _add_tests(tab, tg, bg, p)
        results[target] = tab
        _dump_group(tab, target, tg_names, bg_names, p)
    return results


_OUT_COLS = ["chr", "start", "end", "startCpG", "endCpG", "target", "region",
             "lenCpG", "bp", "tg_mean", "bg_mean", "delta_means",
             "delta_quants", "delta_maxmin", "ttest", "mw_test",
             "mvalue_ttest", "direction"]


def _sort_desc(vals):
    """Descending order with NaN last, as pandas' sort_values(ascending=
    False) computes it (pandas.core.sorting.nargsort, quicksort)."""
    vals = np.asarray(vals, dtype=np.float64)
    nan = np.isnan(vals)
    idx = np.arange(vals.shape[0])
    non_nan_idx = idx[~nan][::-1]
    order = non_nan_idx[vals[~nan][::-1].argsort(kind="quicksort")][::-1]
    return np.concatenate([order, idx[nan]])


def _cell(v):
    """One output field: floats as %.3g (NaN as NA), the rest as str."""
    if isinstance(v, (float, np.floating)):
        return "NA" if np.isnan(v) else "%.3g" % v
    return str(v)


def _dump_group(tab, group, tg_names, bg_names, p):
    n = _n_rows(tab)
    eprint(f"[wt fm] {group}: {n:,} markers")
    outpath = op.join(p.out_dir, f"Markers.{group}.bed")
    rows = []
    if n:
        order = _sort_desc(tab[p.sort_by]) if p.sort_by else np.arange(n)
        if p.top:
            order = order[: int(p.top)]
        t = _take(tab, order)
        t["target"] = np.full(order.shape[0], group)
        t["lenCpG"] = [f"{l}CpGs" for l in (t["endCpG"] - t["startCpG"])]
        t["bp"] = [f"{l}bp" for l in (t["end"] - t["start"])]
        t["region"] = [f"{c}:{s}-{e}" for c, s, e in
                       zip(t["chr"], t["start"], t["end"])]
        rows = zip(*(t[c] for c in _OUT_COLS))
    with open(outpath, "w") as f:
        if p.header:
            for s in sorted(tg_names):
                f.write(f"#> {s}\n")
            for s in sorted(bg_names):
                f.write(f"#< {s}\n")
        f.write("\t".join(["#chr"] + _OUT_COLS[1:]) + "\n")
        for r in rows:
            f.write("\t".join(_cell(v) for v in r) + "\n")


def _dump_params(p, betas):
    with open(op.join(p.out_dir, "params.txt"), "w") as f:
        for key, val in p.as_dict().items():
            if key == "betas":
                val = " ".join(betas)
            elif key == "targets" and val is not None:
                val = " ".join(val)
            f.write(f"{key}:{val}\n")
