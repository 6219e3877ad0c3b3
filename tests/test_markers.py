"""find_markers helpers that replaced the pandas reader and writer
(models/markers.py): groups csv parsing and the output sort order."""

import numpy as np
import pytest

from wgbs_tools_tpu.models.markers import _cell, _sort_desc, load_groups
from wgbs_tools_tpu.utils import IllegalArgumentError


def test_load_groups_csv(tmp_path):
    """First column names the sample; `include` drops rows; '#' comments
    and blank lines are skipped; integer groups compare as integers."""
    betas = [str(tmp_path / f"{n}.beta") for n in ("a", "b", "c", "d")]
    g = tmp_path / "g.csv"
    g.write_text("sample,group,include\n# note\na,10,True\n\nb,2,true\n"
                 "c,2,False\nd,10,True  # trailing comment\n")
    fnames, groups, paths = load_groups(str(g), betas)
    assert fnames == ["a", "b", "d"] and groups == [10, 2, 10]
    assert sorted(set(groups)) == [2, 10]
    assert paths == [betas[0], betas[1], betas[3]]
    g.write_text("name,grp\na,A\n")
    with pytest.raises(IllegalArgumentError, match="group"):
        load_groups(str(g), betas)
    g.write_text("name,group\nzz,A\n")
    with pytest.raises(IllegalArgumentError, match="zz"):
        load_groups(str(g), betas)


def test_sort_desc_and_cells():
    """Descending by value with NaN rows last in their original order;
    floats print as %.3g and NaN as NA."""
    v = np.array([0.5, np.nan, 2.0, -1.0, np.nan, 0.75])
    order = _sort_desc(v)
    assert order[:4].tolist() == [2, 5, 0, 3] and order[4:].tolist() == [1, 4]
    assert [_cell(x) for x in (np.float64(1.2345e-7), np.nan, 0.5, 7, "U")] \
        == ["1.23e-07", "NA", "0.5", "7", "U"]
