"""The kernel build step (`ops/cuda_build.py`) with a stand-in compiler.

The real `nvcc` exists only on GPU machines; a small script in its place
records its arguments and writes the output file, so the build logic — one
compiler per source started together, outputs keyed by a hash of the source,
no rebuild when current, a failed compile raising with the compiler's log —
is checked anywhere.
"""

from __future__ import annotations

import os
import stat
import sys

import pytest

from verbatim_rag_tpu_torch.ops import cuda_build

FAKE_NVCC = """#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
src = args[-1]
with open(os.path.join(os.path.dirname(out), "calls.txt"), "a") as f:
    f.write(" ".join(args) + "\\n")
if os.environ.get("FAKE_NVCC_FAIL") and src.endswith(os.environ["FAKE_NVCC_FAIL"]):
    print("error: something the compiler refused")
    sys.exit(1)
start = time.time()
time.sleep(0.5)
with open(os.path.join(os.path.dirname(out), "spans.txt"), "a") as f:
    f.write(f"{{start}} {{time.time()}}\\n")
print("ptxas info    : Used 42 registers")
open(out, "w").write("library")
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    cuda_home = tmp_path / "cuda"
    (cuda_home / "bin").mkdir(parents=True)
    nvcc = cuda_home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build = tmp_path / "build"
    monkeypatch.setenv("CUDA_HOME", str(cuda_home))
    monkeypatch.setenv("VERBATIM_TORCH_BUILD_DIR", str(build))
    return build


def _calls(build):
    path = build / "calls.txt"
    return path.read_text().splitlines() if path.exists() else []


def test_builds_every_source_once_with_the_hopper_flags(fake_toolkit):
    logs = cuda_build.build_all()
    assert set(logs) == set(cuda_build.KERNEL_SOURCES)
    assert all("42 registers" in log for log in logs.values())
    calls = _calls(fake_toolkit)
    assert len(calls) == len(cuda_build.KERNEL_SOURCES)
    assert all("arch=compute_90a,code=sm_90a" in c and "-shared" in c for c in calls)
    for name in cuda_build.KERNEL_SOURCES:
        assert cuda_build._target(name).exists()
        assert cuda_build._target(name).parent == fake_toolkit
    assert cuda_build.build_all() == {n: "" for n in cuda_build.KERNEL_SOURCES}
    assert len(_calls(fake_toolkit)) == len(calls)  # current builds are reused


def test_compilers_run_together(fake_toolkit):
    cuda_build.build_all()
    lines = (fake_toolkit / "spans.txt").read_text().splitlines()
    spans = [tuple(map(float, line.split())) for line in lines]
    assert len(spans) == len(cuda_build.KERNEL_SOURCES)
    # Every compile was running while every other one was: they overlap.
    assert max(start for start, _ in spans) < min(end for _, end in spans)


def test_failed_compile_raises_with_the_log(fake_toolkit, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "rescore.cu")
    with pytest.raises(RuntimeError, match="something the compiler refused"):
        cuda_build.build_all()
    assert not cuda_build._target("rescore").exists()
    assert not list(fake_toolkit.glob("*.tmp"))


def test_output_name_follows_the_shared_headers(fake_toolkit, tmp_path, monkeypatch):
    """An edit to a shared header (`csrc/*.cuh`) changes every source's
    target, so a stale library is never loaded; the compiler command links
    libcuda, which encodes the flash kernels' TMA tensor maps."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in cuda_build.CSRC.iterdir():
        if path.suffix in (".cu", ".cuh"):
            (csrc / path.name).write_bytes(path.read_bytes())
    assert (csrc / "hopper.cuh").exists()
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    before = {n: cuda_build._target(n).name for n in cuda_build.KERNEL_SOURCES}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build._target(n).name for n in cuda_build.KERNEL_SOURCES}
    assert all(before[n] != after[n] for n in before)
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert cuda_build._target("flash_attention").name != after["flash_attention"]
    cuda_build.build_all(("flash_attention",))
    (call,) = _calls(fake_toolkit)
    assert "-lcuda" in call.split() and call.split()[-1] == str(csrc / "flash_attention.cu")
    assert cuda_build._target("flash_attention").exists()


def test_output_name_follows_the_source(fake_toolkit):
    names = {cuda_build._target(n).name for n in cuda_build.KERNEL_SOURCES}
    assert len(names) == len(cuda_build.KERNEL_SOURCES)
    assert all(name.endswith(".so") for name in names)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("VERBATIM_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all()


def test_kernel_check_raises_on_a_cuda_error():
    cuda_build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        cuda_build.check(9, "kernel")
    assert os.path.isdir(cuda_build.CSRC)
