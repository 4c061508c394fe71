"""Building the kernels (psulvsb_tpu_torch/ops/_build.py), without nvcc.

A kernel's library is named by a digest of its source. The digest must
cover every file under csrc/ that the source includes, directly or through
another header, or an edited header would leave a stale library in build/;
and it must not move when an unrelated file under csrc/ changes, or every
edit would rebuild every kernel. Nothing is built, and nvcc is not looked
for, when the modules are imported. `KERNELS` names every C entry point
`<name>_launch` under csrc/, and `launch` takes no other name.
"""

import re
import shutil

import pytest

from psulvsb_tpu_torch.ops import _build

PAIR_GRID = ("pair_ratio_hist", "pair_beta_count", "consistency_degree")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/ that _build reads in place of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


def test_pair_grid_kernels_are_built_from_the_shared_header():
    for name in PAIR_GRID:
        names = {p.name for p in _build.source_files(name)}
        assert names == {f"{name}.cu", "pair_sweep.cuh"}
    assert [p.name for p in _build.source_files("gnc_batch")] == ["gnc_batch.cu"]


@pytest.mark.parametrize("name", PAIR_GRID)
def test_digest_follows_an_included_header(csrc_copy, name):
    before = _build.source_digest(name)
    other = _build.source_digest("gnc_batch")
    with open(csrc_copy / "pair_sweep.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.source_digest(name) != before
    assert _build.source_digest("gnc_batch") == other


def test_digest_follows_a_header_of_a_header(csrc_copy):
    (csrc_copy / "inner.cuh").write_text("#pragma once\n")
    with open(csrc_copy / "pair_sweep.cuh", "a") as f:
        f.write('#  include "inner.cuh"\n')
    before = _build.source_digest("pair_beta_count")
    assert "inner.cuh" in {p.name for p in _build.source_files("pair_beta_count")}
    (csrc_copy / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert _build.source_digest("pair_beta_count") != before


@pytest.mark.parametrize("name", PAIR_GRID + ("gnc_batch",))
def test_digest_ignores_unrelated_files(csrc_copy, name):
    before = _build.source_digest(name)
    (csrc_copy / "unrelated.cuh").write_text("// not included by any kernel\n")
    others = [n for n in PAIR_GRID + ("gnc_batch",) if n != name]
    with open(csrc_copy / f"{others[0]}.cu", "a") as f:
        f.write("// edited\n")
    assert _build.source_digest(name) == before
    with open(csrc_copy / f"{name}.cu", "a") as f:
        f.write("// edited\n")
    assert _build.source_digest(name) != before


def test_system_includes_are_not_followed(csrc_copy):
    # <cuda_runtime.h> is the toolkit's; a quoted name that is not under
    # csrc/ is left to the compiler.
    (csrc_copy / "k.cu").write_text('#include <cuda_runtime.h>\n#include "elsewhere.h"\n')
    assert [p.name for p in _build.source_files("k")] == ["k.cu"]


def test_nothing_is_built_at_import():
    """A fresh interpreter imports every module of ops/ with nvcc out of
    reach, and has loaded no library, looked up no entry point and counted
    no launch."""
    import subprocess
    import sys

    code = (
        "import shutil, subprocess\n"
        "def no_build(*a, **k): raise AssertionError('built at import')\n"
        "subprocess.run = no_build; shutil.which = lambda name: None\n"
        "from psulvsb_tpu_torch.ops import _build, gnc, hist, init, local, pairs\n"
        "import psulvsb_tpu_torch\n"
        "assert _build._LOADED == {} and _build._LAUNCHERS == {} and _build.BUILD_INFO == {}\n"
        "assert callable(_build.launch)\n"
        "assert _build.LAUNCHES == dict.fromkeys(_build.KERNELS, 0)\n"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert done.returncode == 0, done.stderr


def test_kernels_are_the_entry_points_under_csrc():
    """`KERNELS` is the set of `<name>_launch` entry points of csrc/*.cu,
    read as text, each in the library `launch` loads for it; `launch`
    refuses any other name before it builds or loads anything."""
    found = {}
    for path in _build.CSRC_DIR.glob("*.cu"):
        for name in re.findall(r'extern\s+"C"\s+int\s+(\w+)_launch\s*\(', path.read_text()):
            found[name] = path.stem
    assert sorted(found) == sorted(_build.KERNELS)
    assert len(set(_build.KERNELS)) == len(_build.KERNELS)
    assert found == {name: _build._LIBRARY.get(name, name) for name in _build.KERNELS}
    assert set(_build.LAUNCHES) == set(_build.KERNELS)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="not one of the kernels"):
        _build.launch("graph_cond_stamp", [], "cpu")
    assert _build.LAUNCHES == before and "graph_cond_stamp" not in _build._LAUNCHERS
