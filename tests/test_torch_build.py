"""The port's kernel build helpers (nerfmlp_torch/ops/_build.py) and the
source variants of the backward's ablation script, on the CPU: where a
library goes, what its name depends on, and how a build or a variant
fails. Nothing here compiles."""

import os
import shutil

import pytest

from nerfmlp_torch.ops import _build
from nerfmlp_torch.scripts import bwd_ablate


@pytest.mark.parametrize("edit, same", [("", True), ("\n// edited\n", False)])
def test_library_path_hashes_the_source_in_one_build_dir(tmp_path, edit, same):
    """A copy of a source in another directory builds into the same build
    directory, under the same name when its text is the same and another
    name when it differs."""
    name = "fused_mlp_bwd"
    src, *headers = _build.sources(name)
    assert headers, "the kernels share csrc/mlp_tile.cuh"
    for path in headers:
        shutil.copy(path, tmp_path)
    with open(src) as f:
        (tmp_path / _build.KERNELS[name]).write_text(f.read() + edit)
    here = _build.library_path(name)
    there = _build.library_path(name, str(tmp_path))
    assert os.path.dirname(there) == os.path.dirname(here) == _build.build_dir()
    assert (there == here) is same


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_library_path_hashes_the_shared_header(tmp_path, name):
    """Both kernels include csrc/mlp_tile.cuh: an edit of the header alone
    renames (so rebuilds) each library."""
    src, *headers = _build.sources(name)
    shutil.copy(src, tmp_path)
    for path in headers:
        with open(path) as f:
            (tmp_path / os.path.basename(path)).write_text(f.read() + "\n")
    assert _build.library_path(name, str(tmp_path)) != _build.library_path(name)


def test_build_without_nvcc_names_it(tmp_path, monkeypatch):
    monkeypatch.setenv("NERFMLP_TORCH_BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["fused_mlp_fwd"])
    assert not any(p.suffix == ".so" for p in (tmp_path / "out").iterdir())


def test_ablation_variant_whose_text_is_gone_fails_by_name(monkeypatch):
    monkeypatch.setitem(bwd_ablate.VARIANTS, "phase 1 without nothing",
                        [("no such line in the kernel", "")])
    with pytest.raises(RuntimeError, match="phase 1 without nothing"):
        bwd_ablate.variant_files("fused_mlp_bwd", "phase 1 without nothing",
                                 bwd_ablate.VARIANTS["phase 1 without nothing"])
    files = bwd_ablate.variant_files("fused_mlp_bwd", "as built", [])
    assert files == {os.path.basename(p): open(p).read()
                     for p in _build.sources("fused_mlp_bwd")}


def test_forward_ablation_variant_whose_text_is_gone_fails_by_name(
        monkeypatch):
    monkeypatch.setitem(bwd_ablate.FWD_VARIANTS, "forward without nothing",
                        [("mlp_tile.cuh", "no such line in the core", "")])
    with pytest.raises(RuntimeError, match="forward without nothing"):
        bwd_ablate.variant_files(
            "fused_mlp_fwd", "forward without nothing",
            bwd_ablate.FWD_VARIANTS["forward without nothing"])
    files = bwd_ablate.variant_files("fused_mlp_fwd", "as built", [])
    assert files == {os.path.basename(p): open(p).read()
                     for p in _build.sources("fused_mlp_fwd")}
