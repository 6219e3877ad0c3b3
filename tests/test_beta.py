import numpy as np
import pytest

from tests.synth import random_beta
from wgbs_tools_tpu.formats.beta import (
    beta2vec,
    load_beta,
    merge_betas,
    save_beta,
    trim_to_uint,
)


def test_trim_to_uint8_matches_reference_semantics():
    # ref utils_wgbs.py:277-290 example (docs/beta_format.md:41-43):
    # (100, 510) -> (50, 255)
    data = np.array([[100, 510], [3, 7], [255, 255], [300, 600]], dtype=np.int64)
    out = trim_to_uint(data)
    assert out.dtype == np.uint8
    assert out[0].tolist() == [50, 255]
    assert out[1].tolist() == [3, 7]
    assert out[2].tolist() == [255, 255]
    assert out[3].tolist() == [127, 255]  # 300/600*255 = 127.5 -> trunc 127


def test_trim_to_uint16():
    data = np.array([[70000, 140000]], dtype=np.int64)
    out = trim_to_uint(data, lbeta=True)
    assert out.dtype == np.uint16
    assert out[0].tolist() == [32767, 65535]


def test_save_load_roundtrip(tmp_path, rng):
    data = random_beta(rng, 1000, max_cov=40)
    p = str(tmp_path / "a.beta")
    save_beta(p, data)
    got = load_beta(p)
    assert (got == data).all()
    # sliced load (1-based)
    sl = load_beta(p, sites=(11, 21))
    assert (sl == data[10:20]).all()


def test_lbeta_roundtrip(tmp_path, rng):
    data = random_beta(rng, 500, max_cov=1000)
    p = str(tmp_path / "a.lbeta")
    save_beta(p, data)
    got = load_beta(p)
    assert (got == data).all()


def test_beta2vec():
    data = np.array([[1, 2], [0, 0], [3, 3]])
    v = beta2vec(data)
    assert v[0] == 0.5
    assert np.isnan(v[1])
    assert v[2] == 1.0


def test_merge_betas(tmp_path, rng):
    a = random_beta(rng, 300, max_cov=10)
    b = random_beta(rng, 300, max_cov=10)
    pa, pb = str(tmp_path / "a.beta"), str(tmp_path / "b.beta")
    save_beta(pa, a)
    save_beta(pb, b)
    out = str(tmp_path / "m.beta")
    merged = merge_betas([pa, pb], out)
    assert (merged == trim_to_uint(a + b)).all()
    assert (load_beta(out) == merged).all()


def test_tsv_lines_match_python_formatting():
    """The vectorized text writer of `view` (beta) formats like f-strings:
    zero, powers of ten, the widest value, any chromosome name."""
    from wgbs_tools_tpu.cli.view import _int_field, _name_field, tsv_lines

    rng = np.random.default_rng(8)
    v = np.concatenate([[0, 9, 10, 99, 100, 1, 3_000_000_000],
                        rng.integers(0, 10 ** 9, 2000)])
    c = rng.integers(0, 3, v.shape[0])
    names = ["chr1", "chr22", "chrX"]
    got = tsv_lines([_name_field(c, names), _int_field(v),
                     _int_field(v % 256)]).decode()
    assert got == "".join(f"{names[a]}\t{b}\t{b % 256}\n"
                          for a, b in zip(c, v))
    with pytest.raises(ValueError):
        _int_field(np.array([3, -1]))


def test_view_beta_text_rows(mini_genome, tmp_path):
    """view of a beta == the per-row rule `chr  loc-1  loc+1  meth  cov`."""
    import io

    from wgbs_tools_tpu.cli.view import view_beta_text

    idx = mini_genome.index
    rng = np.random.default_rng(9)
    cov = rng.integers(0, 40, idx.nr_sites)
    p = str(tmp_path / "v.beta")
    save_beta(p, np.stack([rng.binomial(cov, 0.3), cov], axis=1))
    data = load_beta(p)
    out = io.StringIO()
    view_beta_text(p, mini_genome, out=out)
    cids = idx.site2chrom_id(np.arange(1, idx.nr_sites + 1))
    want = "".join(
        f"{idx.chrom_names[c]}\t{l - 1}\t{l + 1}\t{m}\t{t}\n"
        for c, l, (m, t) in zip(cids, idx.loci.tolist(), data.tolist()))
    assert out.getvalue() == want
