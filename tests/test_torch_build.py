"""The kernel build's cache key: `_build.library_path` names a library by a
hash of its source, of every local header the source includes (directly or
through another header) and of the nvcc flags, so that editing a shared
header such as `csrc/hopper.cuh` rebuilds every library that includes it
and no other.  CPU only: nothing here runs nvcc."""

import shutil

import pytest

from localdiffusion_tpu_torch.ops import _build

SOURCES = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
HOPPER_USERS = ["flash_attention", "groupnorm_film_silu", "groupnorm_tiled", "linear_attention",
                "resnet_block"]
# the GroupNorm sources' shared header, which includes csrc/hopper.cuh
GN_COMMON_USERS = ["groupnorm_film_silu", "groupnorm_tiled"]


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/ that the build module reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", SOURCES)
def test_sources_are_the_file_and_its_local_headers(name):
    found = _build.sources(name)
    assert _build.CSRC / f"{name}.cu" in found
    assert all(p.exists() and p.parent == _build.CSRC for p in found)
    assert (_build.CSRC / "hopper.cuh" in found) == (name in HOPPER_USERS)
    assert (_build.CSRC / "groupnorm_common.cuh" in found) == (name in GN_COMMON_USERS)


@pytest.mark.parametrize("name", GN_COMMON_USERS)
def test_editing_the_groupnorm_header_changes_both_groupnorm_libraries(csrc_copy, name):
    before = _build.library_path(name)
    others = {n: _build.library_path(n) for n in SOURCES if n not in GN_COMMON_USERS}
    header = csrc_copy / "groupnorm_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(name) != before
    assert {n: _build.library_path(n) for n in others} == others


@pytest.mark.parametrize("name", HOPPER_USERS)
def test_editing_an_included_header_changes_the_library(csrc_copy, name):
    before = _build.library_path(name)
    header = csrc_copy / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(name) != before


def test_editing_a_header_leaves_other_libraries(csrc_copy):
    others = [n for n in SOURCES if n not in HOPPER_USERS]
    before = {n: _build.library_path(n) for n in others}
    header = csrc_copy / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert {n: _build.library_path(n) for n in others} == before


def test_headers_are_followed_through_headers(csrc_copy):
    """A header included only by another header counts too."""
    (csrc_copy / "inner.cuh").write_text("#pragma once\n")
    header = csrc_copy / "hopper.cuh"
    header.write_text(header.read_text() + '\n#include "inner.cuh"\n')
    before = _build.library_path("flash_attention")
    assert csrc_copy / "inner.cuh" in _build.sources("flash_attention")
    (csrc_copy / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert _build.library_path("flash_attention") != before


def test_editing_the_source_or_the_flags_changes_the_library(csrc_copy, monkeypatch):
    before = _build.library_path("resnet_block")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    flagged = _build.library_path("resnet_block")
    assert flagged != before
    src = csrc_copy / "resnet_block.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("resnet_block") != flagged
