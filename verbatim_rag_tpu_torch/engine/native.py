"""ctypes bindings of the port's C++ host runtime (`csrc/host/`).

`csrc/host/verbatim_host.cpp` is the host runtime of the JAX package
(`native/verbatim_host.cpp`), byte for byte: the hash tokenizer's scan
(`hash_tokenize`), the BM25 analyzer (`analyze_text`), and the sketching and
rescore loops (`project_rows`, `exact_rescore`). `verbatim_host_batch.cpp`
compiles it into one library with `analyze_texts`, the analyzer over many
texts in one call, in parallel over texts (`VERBATIM_NATIVE_THREADS` pins
the worker count, as in the original).

The library is built with the C++ compiler (``$CXX``, default ``g++``) and
the JAX package's `native/Makefile` flags at first use, into
``build/host/verbatim_host-<hash>.so`` at the repository root (or
``$VERBATIM_TORCH_BUILD_DIR``), keyed by a hash of the sources, the compiler,
the flags and the host CPU (``-march=native`` code runs only on its own kind
of CPU). Each process compiles to a name of its own and renames it into
place, so processes that build at once all load one whole library. A build or
load that fails raises `RuntimeError` with the compiler's output: there is no
quiet fallback. The callers keep their Python paths only where the JAX
package takes them whatever the library does: non-ASCII text in the
tokenizer, and texts of 4096 or more unique slots in the analyzer.

Nothing is built at import time. The counters below count the calls whose
result the callers took (the proof that a path went through the scanner).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

HOST_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
SOURCES = ("verbatim_host.cpp", "verbatim_host_batch.cpp")
#: `native/Makefile`'s CXXFLAGS.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")

#: `hash_tokenize` calls whose tokens the caller took.
tokenize_calls = 0
#: `analyze_texts` calls, and the texts they analyzed.
analyze_calls = 0
analyze_texts = 0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_dir() -> Path:
    env = os.environ.get("VERBATIM_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return HOST_SRC.parent.parent.parent / "build" / "host"


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _cpu_key() -> bytes:
    """What ``-march=native`` depends on: the CPU's model and flags."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine().encode() + platform.processor().encode()
    keep = [line for line in lines if line.startswith(("model name", "flags", "Features", "CPU part"))]
    return platform.machine().encode() + "\n".join(sorted(set(keep))).encode()


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update(name.encode() + (HOST_SRC / name).read_bytes())
    digest.update(" ".join((_compiler(), *CXX_FLAGS)).encode())
    digest.update(_cpu_key())
    return build_dir() / f"verbatim_host-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(HOST_SRC / SOURCES[1])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        raise RuntimeError(f"host runtime: cannot run {cmd[0]!r}: {err}") from err
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"host runtime: {' '.join(cmd)} failed (rc {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.project_rows.argtypes = [p, p, i64, i64, p, i64, i64, p]
    lib.exact_rescore.argtypes = [p, i64, i64, p, p, i64, i64, p, i64, p]
    lib.analyze_text.argtypes = [ctypes.c_char_p, i64, i64, p, p, i64, p]
    lib.analyze_text.restype = i64
    lib.hash_tokenize.argtypes = [ctypes.c_char_p, i64, i64, i64, i64, p, p]
    lib.hash_tokenize.restype = i64
    lib.analyze_texts.argtypes = [ctypes.c_char_p, p, i64, i64, i64, p, p, p, p, p]
    lib.analyze_texts.restype = i64
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises `RuntimeError`."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _build(target)
            try:
                _lib = _bind(ctypes.CDLL(str(target)))
            except OSError as err:
                raise RuntimeError(f"host runtime: cannot load {target}: {err}") from err
        return _lib


def hash_tokenize(
    text: str, vocab_size: int, reserved: int, max_tokens: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """The hash tokenizer's scan: ``(ids int32[n], offsets int32[n, 2])``,
    or None for text that is not pure ASCII (the caller's Python path)."""
    global tokenize_calls
    if not text.isascii():
        return None
    lib = load()
    raw = text.encode("ascii")
    cap = max(1, min(max_tokens, len(raw)))  # ≤ 1 token per input byte
    ids = np.empty(cap, np.int32)
    offsets = np.empty((cap, 2), np.int32)
    n = lib.hash_tokenize(raw, len(raw), vocab_size, reserved, cap, ids.ctypes.data, offsets.ctypes.data)
    if n < 0:
        return None
    tokenize_calls += 1
    # Copies: a cached result must not pin the cap-sized buffers.
    return ids[:n].copy(), offsets[:n].copy()


def analyze_text(text: str, vocab_size: int, max_terms: int = 4096):
    """One text through `analyze_text`: (unique slots int32, counts int32,
    document length), or None when ``max_terms`` unique slots fill the
    buffer (the binding of `native.py::analyze_text_native` in the JAX
    package)."""
    lib = load()
    raw = text.encode("utf-8", errors="ignore")
    term_ids = np.zeros(max_terms, np.int32)
    term_tfs = np.zeros(max_terms, np.int32)
    n_terms = ctypes.c_int64(0)
    dl = lib.analyze_text(
        raw, len(raw), vocab_size, term_ids.ctypes.data, term_tfs.ctypes.data, max_terms,
        ctypes.byref(n_terms),
    )
    n = n_terms.value
    if n >= max_terms:
        return None
    return term_ids[:n].copy(), term_tfs[:n].copy(), int(dl)


def analyze_batch(texts, vocab_size: int, max_terms: int):
    """Every text through `analyze_texts`: (slots int32, counts int32,
    offsets int64 [n+1], lengths int64 [n]); text i's slots are
    ``slots[offsets[i]:offsets[i+1]]``, as `analyze_text` orders them. A text
    whose unique count reaches ``max_terms`` holds ``max_terms`` slots: the
    caller replaces it."""
    global analyze_calls, analyze_texts
    lib = load()
    n = len(texts)
    joined = "".join(texts)
    if joined.isascii():
        data = joined.encode("ascii")
        sizes = np.fromiter(map(len, texts), np.int64, count=n)
    else:
        raws = [t.encode("utf-8", errors="ignore") for t in texts]
        data = b"".join(raws)
        sizes = np.fromiter(map(len, raws), np.int64, count=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    caps = np.minimum((sizes + 1) // 2, max_terms)
    cap_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(caps, out=cap_offsets[1:])
    slots = np.empty(max(int(cap_offsets[-1]), 1), np.int32)
    counts = np.empty_like(slots)
    out_offsets = np.empty(n + 1, np.int64)
    lengths = np.empty(n, np.int64)
    total = lib.analyze_texts(
        data, offsets.ctypes.data, n, vocab_size, max_terms, cap_offsets.ctypes.data,
        slots.ctypes.data, counts.ctypes.data, out_offsets.ctypes.data, lengths.ctypes.data,
    )
    analyze_calls += 1
    analyze_texts += n
    return slots[:total].copy(), counts[:total].copy(), out_offsets, lengths


def project_rows(token_ids: np.ndarray, weights: np.ndarray, projection: np.ndarray) -> np.ndarray:
    """`project_rows` on host arrays: out[n] = Σ_j w[n, j] · P[ids[n, j]]."""
    lib = load()
    ids = np.ascontiguousarray(token_ids, np.int32)
    w = np.ascontiguousarray(weights, np.float32)
    proj = np.ascontiguousarray(projection, np.float32)
    n, m = ids.shape
    vocab, d = proj.shape
    if w.shape != ids.shape:
        raise ValueError(f"weights {w.shape} do not match token ids {ids.shape}")
    out = np.empty((n, d), np.float32)
    lib.project_rows(ids.ctypes.data, w.ctypes.data, n, m, proj.ctypes.data, vocab, d, out.ctypes.data)
    return out


def exact_rescore(
    candidate_rows: np.ndarray, sp_ids: np.ndarray, sp_weights: np.ndarray, q_dense: np.ndarray
) -> np.ndarray:
    """`exact_rescore` on host arrays: scores [B, C] of the candidates'
    forward-index rows against dense query rows; −inf where a row is < 0."""
    lib = load()
    rows = np.ascontiguousarray(candidate_rows, np.int64)
    ids = np.ascontiguousarray(sp_ids, np.int32)
    w = np.ascontiguousarray(sp_weights, np.float32)
    q = np.ascontiguousarray(q_dense, np.float32)
    batch, c = rows.shape
    n, m = ids.shape
    if w.shape != ids.shape or q.shape[0] != batch:
        raise ValueError(f"shapes: rows {rows.shape}, ids {ids.shape}, weights {w.shape}, queries {q.shape}")
    if ids.size and (ids.min() < 0 or ids.max() >= q.shape[1]):
        raise ValueError(f"forward-index ids outside the queries' vocabulary of {q.shape[1]}")
    out = np.empty((batch, c), np.float32)
    lib.exact_rescore(
        rows.ctypes.data, batch, c, ids.ctypes.data, w.ctypes.data, n, m, q.ctypes.data,
        q.shape[1], out.ctypes.data,
    )
    out[rows < 0] = -np.inf
    return out
