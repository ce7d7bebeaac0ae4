"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC -lcuda`` into ``build/kernels/<name>-<hash>.so`` at the repository root
(or under ``$VERBATIM_TORCH_BUILD_DIR``), keyed by a hash of the source, of
every shared header ``csrc/*.cuh`` and of the flags, then loaded with
``ctypes``. ``-lcuda`` links libcuda, whose ``cuTensorMapEncodeTiled``
encodes the flash kernels' TMA tensor maps. :func:`build_all` starts one
``nvcc`` per source at once, so a fresh machine pays for the slowest file,
not the sum.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lcuda",
)
KERNEL_SOURCES = ("flash_attention", "flash_attention_bwd", "rescore", "section")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("VERBATIM_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any of them
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    key = digest.hexdigest()[:16]
    return build_dir() / f"{name}-{key}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    target = _target(name)
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, target = job
    log, _ = proc.communicate()
    target.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, target)


def build_all(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every kernel source that has no current build, in parallel.

    :return: ``{name: compiler log}`` (``-Xptxas -v`` register and shared
        memory report; empty for sources that were already built).
    """
    with _lock:
        jobs = {n: _start(n) for n in names}
        # Wait for every compiler before raising, so a failed source leaves
        # no other compile running or half written.
        errors = []
        for n, job in jobs.items():
            if job is not None:
                try:
                    _finish(n, job)
                except RuntimeError as err:
                    errors.append(err)
        if errors:
            raise errors[0]
    logs = {}
    for n in names:
        log = _target(n).with_suffix(".log")
        logs[n] = log.read_text() if jobs[n] is not None and log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


#: The largest ``gridDim.y`` (and ``gridDim.z``) a CUDA launch may have.
GRID_Y_MAX = 65535


def grid_chunks(rows: int, per_row: int = 1) -> list[tuple[int, int]]:
    """``[start, stop)`` slices of ``rows`` leading rows, each small enough
    that ``(stop − start) · per_row`` fits ``gridDim.y``: a kernel that puts
    batch × heads (or batch) there runs once per slice. One slice when the
    whole fits; none for no rows."""
    if per_row < 1 or per_row > GRID_Y_MAX:
        raise ValueError(f"{per_row} grid rows per leading row do not fit gridDim.y ({GRID_Y_MAX})")
    step = GRID_Y_MAX // per_row
    return [(start, min(start + step, rows)) for start in range(0, rows, step)]
