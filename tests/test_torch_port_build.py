"""The kernel build's cache key: a library is named by a hash of its
source, of every header under ``csrc/`` and of the flags, so an edited
header rebuilds every library (no ``nvcc`` is needed to check that)."""

from __future__ import annotations

import re
import shutil

import pytest

from mudiff_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A private copy of ``csrc/`` that ``_build`` reads from."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _headers():
    return sorted(p.name for p in _build.CSRC.glob("*.cuh"))


def test_csrc_has_a_shared_header():
    assert "tensor_core.cuh" in _headers()


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_header_edit_changes_every_library_path(csrc_copy, name):
    before = _build.library_path(name)
    header = csrc_copy / "tensor_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path(name)
    assert after != before
    assert after.parent == before.parent and after.name.startswith(f"lib{name}_")


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_source_edit_changes_only_its_library_path(csrc_copy, name):
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    src = csrc_copy / _build.SOURCES[name]
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert {n for n in before if before[n] != after[n]} == {name}


def test_new_header_changes_the_path(csrc_copy):
    before = _build.library_path("conv3x3")
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("conv3x3") != before


def test_flags_change_the_path(monkeypatch):
    before = _build.library_path("flash_attn")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build.library_path("flash_attn") != before


def test_path_is_stable_and_distinct_per_library():
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert paths == {n: _build.library_path(n) for n in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_every_local_include_is_a_hashed_header(name):
    """A source includes from ``csrc/`` only ``.cuh`` headers, all of
    which the hash covers; the tensor-core kernels include the shared
    one."""
    text = (_build.CSRC / _build.SOURCES[name]).read_text()
    local = re.findall(r'^#include "([^"]+)"', text, flags=re.M)
    assert all(inc in _headers() for inc in local), local
    if name in ("conv3x3", "flash_attn"):
        assert "tensor_core.cuh" in local
