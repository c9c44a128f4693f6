"""The kernel build of the PyTorch port (dynolog_tpu_torch.ops._build) on
the CPU, with a stand-in for nvcc: one compiler process per library, all
started together, libraries reused by content hash, failures raised with
the compiler's log. (The real nvcc runs only on the machine with the
card, through chip_smoke.py.)"""

import os
import stat

import pytest

from dynolog_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
# Writes its -o target, like nvcc, after logging like ptxas -v.
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "ptxas info    : Used 64 registers"
{fail}
echo lib > "$out"
"""


@pytest.fixture()
def fake_cuda(tmp_path, monkeypatch):
    def install(fail: str = "") -> None:
        nvcc = tmp_path / "cuda" / "bin" / "nvcc"
        nvcc.parent.mkdir(parents=True, exist_ok=True)
        nvcc.write_text(FAKE_NVCC.format(fail=fail))
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)

    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("DYNOLOG_TORCH_BUILD_DIR", str(tmp_path / "out"))
    return install


def test_build_all_builds_each_library_once(fake_cuda, tmp_path):
    fake_cuda()
    first = _build.build_all()
    assert set(first) == set(_build.LIBRARIES)
    for name in _build.LIBRARIES:
        lib = _build._lib_path(name)
        assert lib.parent == tmp_path / "out" and lib.exists()
        assert "registers" in lib.with_suffix(".log").read_text()
    assert _build.build_all() == {name: 0.0 for name in _build.LIBRARIES}


def test_build_failure_raises_with_the_compiler_log(fake_cuda, tmp_path):
    fake_cuda(fail='echo "error: no such intrinsic"; exit 1')
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build_all(["flash_fwd"])
    assert not _build._lib_path("flash_fwd").exists()
    assert not [p for p in os.listdir(tmp_path / "out")
                if p.endswith(".tmp")]


def test_library_name_follows_its_sources(fake_cuda):
    assert _build._lib_path("flash_fwd") != _build._lib_path("flash_bwd")
    assert _build._lib_path("flash_fwd") == _build._lib_path("flash_fwd")


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("a CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_every_source_is_built_and_every_header_hashed():
    """Every csrc/*.cu is the source of a library and every csrc/*.cuh is
    in HEADERS, whose bytes name every library: an edited header can never
    reuse a library built from the old one."""
    sources = {src for src, _ in _build.LIBRARIES.values()}
    assert sources == {p.name for p in _build.CSRC.glob("*.cu")}
    assert set(_build.HEADERS) == {p.name for p in _build.CSRC.glob("*.cuh")}


def test_a_header_edit_renames_every_library(fake_cuda, tmp_path,
                                             monkeypatch):
    """The library names follow the headers' bytes."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build._lib_path(name) for name in _build.LIBRARIES}
    (csrc / "sm90_common.cuh").write_text("// edited\n")
    for name in _build.LIBRARIES:
        assert _build._lib_path(name) != before[name]


@pytest.mark.parametrize("header", _build.HEADERS)
def test_tensor_core_forward_is_built_and_named_by_each_header(
        fake_cuda, tmp_path, monkeypatch, header):
    """flash_fwd_sm90.cu is built as its own library, exporting flash_fwd,
    and an edit of either header renames it."""
    fake_cuda()
    src, exports = _build.LIBRARIES["flash_fwd_sm90"]
    assert src == "flash_fwd_sm90.cu" and list(exports) == ["flash_fwd"]
    assert exports["flash_fwd"] == _build.LIBRARIES["flash_fwd"][1][
        "flash_fwd"]
    assert _build.build_all(["flash_fwd_sm90"])["flash_fwd_sm90"] > 0.0
    assert _build._lib_path("flash_fwd_sm90").exists()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._lib_path("flash_fwd_sm90")
    (csrc / header).write_text("// edited\n")
    assert _build._lib_path("flash_fwd_sm90") != before
