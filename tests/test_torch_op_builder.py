"""The port's kernel builder: a library is named by what it is built from.

Runs on the CPU: it reads the sources and names the library, and never
calls nvcc.
"""

import shutil

import pytest

from deepspeed_tpu_torch.ops import op_builder

REPO_CSRC = op_builder.CSRC_DIR


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the port's csrc/ that a test may edit, put in its place."""
    copy = shutil.copytree(REPO_CSRC, tmp_path / "csrc")
    monkeypatch.setattr(op_builder, "CSRC_DIR", copy)
    return copy


def _path(name="flash_attention_fwd"):
    return op_builder.CudaKernel(name, {}).library_path


def test_shared_header_exists_and_is_included():
    headers = sorted(p.name for p in REPO_CSRC.glob("*.cuh"))
    assert "hopper_mma.cuh" in headers
    for src in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        assert '#include "hopper_mma.cuh"' in (REPO_CSRC / src).read_text()


def test_unchanged_sources_keep_their_library(csrc, monkeypatch):
    copied = _path()
    assert copied == _path()
    monkeypatch.setattr(op_builder, "CSRC_DIR", REPO_CSRC)
    assert copied.name == _path().name


@pytest.mark.parametrize("edit", ["header", "source", "new_header"])
def test_an_edit_names_a_new_library(csrc, edit):
    """Editing the .cu, editing a header in csrc/ or adding one rebuilds: a
    stale library is never reused."""
    before = _path()
    if edit == "header":
        h = csrc / "hopper_mma.cuh"
        h.write_text(h.read_text() + "\n// edited\n")
    elif edit == "source":
        s = csrc / "flash_attention_fwd.cu"
        s.write_text(s.read_text() + "\n// edited\n")
    else:
        (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _path() != before
    assert _path().parent == op_builder.BUILD_DIR


def test_a_header_edit_rebuilds_every_kernel_of_the_directory(csrc):
    names = ("flash_attention_fwd", "flash_attention_bwd", "decode_attention")
    before = {n: _path(n) for n in names}
    h = csrc / "hopper_mma.cuh"
    h.write_text(h.read_text().replace("kLog2e", "kLog2E"))
    assert all(_path(n) != before[n] for n in names)


def test_launch_counts_cover_every_kernel_and_take_credits():
    """Every kernel's entries are in ``launch_counts``; ``add_launches``
    credits (and takes back) launches, as the decode loop does per replay
    of a captured graph."""
    from deepspeed_tpu_torch.ops.pallas import decode_attention as tda
    from deepspeed_tpu_torch.ops.pallas import flash_attention as tfa

    counts = op_builder.launch_counts()
    for kern in (tda.KERNEL, tfa.KERNEL, tfa.BWD_KERNEL, tfa.SPARSE_KERNEL):
        assert {(kern, fn) for fn in kern.functions} <= counts.keys()
    before = tda.KERNEL.launches
    op_builder.add_launches({(tda.KERNEL, "decode_attention"): 3})
    assert tda.KERNEL.launches == before + 3
    op_builder.add_launches({(tda.KERNEL, "decode_attention"): -3})
    assert tda.KERNEL.launches == before
