"""The kernel build (r2l_tpu_torch/kernels/_build.py) without a compiler:
the nvcc command line, the source-hash naming that makes an edited source
rebuild, and that importing the port builds nothing."""
import os
import subprocess
import sys

import pytest

from r2l_tpu_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_compile_command_targets_hopper_without_fast_math(name, monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    cmd = _build._compile_cmd(name, _build.BUILD_DIR / "x.so")
    assert cmd[0] == "nvcc"
    joined = " ".join(cmd)
    for flag in ("-gencode arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler -fPIC"):
        assert flag in joined, flag
    # the ladder and the int8 epilogue depend on accurate sinf/cosf/expf
    assert "fast_math" not in joined and "fast-math" not in joined
    assert cmd[-1] == str(_build.CSRC / f"{name}.cu")
    assert os.path.isfile(cmd[-1])


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_library_name_follows_its_sources(name, tmp_path, monkeypatch):
    """A library is named by a hash of its own .cu, the shared headers and
    the flags: editing any of them gives a new name (a rebuild), editing
    another kernel's .cu does not."""
    for src in _build.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    base = _build._library_path(name)
    assert base.parent == _build.BUILD_DIR and base.name.startswith(name)
    assert _build._library_path(name) == base
    other = next(k for k in _build.KERNELS if k != name)
    with open(tmp_path / f"{other}.cu", "a") as f:
        f.write("\n// another kernel\n")
    assert _build._library_path(name) == base
    with open(tmp_path / "r2l_common.cuh", "a") as f:
        f.write("\n// shared header\n")
    changed = _build._library_path(name)
    assert changed != base
    with open(tmp_path / f"{name}.cu", "a") as f:
        f.write("\n// own source\n")
    assert _build._library_path(name) not in (base, changed)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._library_path(name) != base


def test_each_entry_point_is_declared_in_its_source():
    """The ctypes argtypes match the C entry point's parameter count."""
    for name, (entry, argtypes) in _build.KERNELS.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        head = src.split(f'extern "C" int {entry}(', 1)[1].split(")", 1)[0]
        assert len(head.split(",")) == len(argtypes), name


def test_import_builds_nothing():
    """Importing every module of the port starts no compiler and loads no
    library: a kernel is built at its first launch only."""
    script = (
        "import importlib, pkgutil, r2l_tpu_torch\n"
        "for m in pkgutil.walk_packages(r2l_tpu_torch.__path__, "
        "'r2l_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from r2l_tpu_torch.kernels import _build\n"
        "print(_build.load.cache_info().currsize)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO, PATH=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "0"
