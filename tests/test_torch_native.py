"""The port's kernel builder (tacotron2_tpu_torch/native/build.py) on the
CPU, with a stand-in for nvcc: libraries are keyed by their sources, built
once, all compilers started together, and a failing build raises with the
compiler's output."""

import os
import stat

import pytest

from tacotron2_tpu_torch.native import build


@pytest.fixture
def sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "common.cuh").write_text("// shared\n")
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    return csrc


def _fake_nvcc(tmp_path, monkeypatch, body):
    exe = tmp_path / "nvcc"
    exe.write_text("#!/bin/sh\n" + body)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(exe))
    return exe


def test_library_key_follows_sources(sources):
    a0, b0 = build._lib_path("a"), build._lib_path("b")
    assert a0 != b0 and a0 == build._lib_path("a")
    (sources / "b.cu").write_text("// b changed\n")
    assert build._lib_path("a") == a0 and build._lib_path("b") != b0
    (sources / "common.cuh").write_text("// shared changed\n")
    assert build._lib_path("a") != a0


def test_builds_once_and_in_parallel(sources, tmp_path, monkeypatch):
    log = tmp_path / "calls"
    # copy the source named last on the command line to the -o path
    _fake_nvcc(tmp_path, monkeypatch,
               'out=""; prev=""; for a in "$@"; do\n'
               '  [ "$prev" = "-o" ] && out="$a"; prev="$a"; src="$a"; done\n'
               f'echo "$src" >> {log}\ncp "$src" "$out"\n')
    paths = build.build(["a", "b"])
    assert set(paths) == {"a", "b"}
    assert all(os.path.exists(p) for p in paths.values())
    assert open(paths["a"]).read() == "// a\n"
    assert len(open(log).read().splitlines()) == 2
    assert build.build(["a", "b"]) == paths             # cached: no rebuild
    assert len(open(log).read().splitlines()) == 2
    assert not [f for f in os.listdir(build.BUILD_DIR) if f.endswith(".tmp")]


def test_failed_build_raises_with_compiler_output(sources, tmp_path,
                                                  monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, 'echo "error: no such intrinsic"\n'
               'exit 1\n')
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        build.build(["a"])
    assert not os.path.exists(build._lib_path("a"))


def test_missing_nvcc_is_reported(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    looked = []
    monkeypatch.setattr(build.os.path, "exists",
                        lambda p: looked.append(p) or False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
    assert os.path.join(str(tmp_path), "bin", "nvcc") in looked


def test_nonzero_cuda_status_raises():
    build.check(0, "launch")
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        build.check(2, "launch")
