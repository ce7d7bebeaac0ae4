"""The port's C++ host runtime (`engine/native.py`, `csrc/host/`) against the
JAX package's (`verbatim_rag_tpu/engine/native.py`).

The JAX library is built by the module fixture `native_scanner` of
`test_torch_full_text.py` into this process's own temporary directory; the
port builds its own copy of the source into its own build directory. The
same inputs go through both.

Tolerances:
- `hash_tokenize`: ids and offsets bit-equal to JAX's `hash_tokenize_native`
  and to the port's Python regex loop, for ASCII text (hypothesis:
  letters, digits, punctuation, ``_``, whitespace, control bytes; cut-offs
  by ``max_tokens``); non-ASCII text takes the Python path on both sides
  and stays equal;
- the analyzer: slots in the same order, counts and lengths equal to the
  JAX store's `_analyze` with its scanner, on both sides of 4096 unique
  slots; the batch entry equal to one `analyze_text` call per text at 1 and
  at 4 worker threads, and to the plain numpy version;
- `project_rows`, `exact_rescore`: bit-equal to JAX's native results (the
  same source, the same flags);
- a compiler that fails raises `RuntimeError`; processes that build at once
  all load one whole library.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from test_torch_full_text import native_scanner  # noqa: F401
from verbatim_rag_tpu.engine import native as jax_native
from verbatim_rag_tpu.engine import store as jax_store
from verbatim_rag_tpu.models import tokenizer as jax_tokenizer
from verbatim_rag_tpu_torch.engine import analyzer, native
from verbatim_rag_tpu_torch.models import tokenizer

pytestmark = pytest.mark.usefixtures("native_scanner")

REPO = Path(__file__).resolve().parent.parent
VOCAB, RESERVED = 30522, 3
FT_VOCAB = 1 << 17

ASCII_TEXT = st.lists(
    st.sampled_from([chr(c) for c in range(0x80)] + list("abcXYZ019_ ") * 4 + ["don't", "a" * 300]),
    max_size=120,
).map("".join)


def _regex(text: str, max_tokens):
    return tokenizer.HashTokenizer(VOCAB)._regex_arrays(text, max_tokens)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=ASCII_TEXT, max_tokens=st.one_of(st.none(), st.integers(1, 40)))
def test_hash_tokenize_bit_equal_to_jax_and_the_regex_loop(text, max_tokens):
    cap = max_tokens if max_tokens is not None else 1 << 62
    ids, offsets = native.hash_tokenize(text, VOCAB, RESERVED, cap)
    e_ids, e_offsets = jax_native.hash_tokenize_native(text, VOCAB, RESERVED, cap)
    r_ids, r_offsets = _regex(text, max_tokens)
    for got, want in ((ids, e_ids), (offsets, e_offsets), (ids, r_ids), (offsets, r_offsets)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert offsets.shape == (ids.size, 2)


@pytest.mark.parametrize("max_length", [16, 512, 8192])
def test_tokenizer_takes_the_scanner_on_ascii_text(max_length):
    """encode_batch's ids, offsets and padding equal JAX's; every ASCII text
    goes through the scanner (the counter rises once a text and pair)."""
    texts = [
        "Solar panels convert sunlight, efficiently (about 22%)! " * 40 + f"#{max_length}",
        "A_b c_d; [x=1] \"quoted\" \\ tab\tnew\nline\x00 ctrl" + f"#{max_length}",
    ]
    ours, theirs = tokenizer.HashTokenizer(VOCAB), jax_tokenizer.HashTokenizer(VOCAB)
    pair = [f"question {max_length} one", f"question {max_length} two"]
    before = native.tokenize_calls
    a = ours.encode_batch(texts, max_length=max_length, pair=pair, with_offsets=True)
    assert native.tokenize_calls - before == 4
    b = theirs.encode_batch(texts, max_length=max_length, pair=pair, with_offsets=True)
    np.testing.assert_array_equal(a.input_ids, b.input_ids)
    np.testing.assert_array_equal(a.attention_mask, b.attention_mask)
    assert a.offsets == b.offsets


@pytest.mark.parametrize(
    "text", ["Ünïcode wörds — mixed; ASCII words too", "ascii until the end é", "\u212a", "\ud7ff ok"]
)
@pytest.mark.parametrize("max_tokens", [None, 3])
def test_non_ascii_text_takes_the_python_path(text, max_tokens):
    ours, theirs = tokenizer.HashTokenizer(VOCAB), jax_tokenizer.HashTokenizer(VOCAB)
    before = native.tokenize_calls
    assert native.hash_tokenize(text, VOCAB, RESERVED, 1 << 62) is None
    got = ours._tokenize_arrays(text, max_tokens)
    assert native.tokenize_calls == before
    want = theirs._tokenize_arrays(text, max_tokens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _words_with_unique_slots(n: int, vocab: int, seed: int) -> list[str]:
    """Words whose analyzer slots are ``n`` distinct values."""
    rng = np.random.default_rng(seed)
    seen, words = set(), []
    while len(words) < n:
        word = "w" + "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz0123456789"), 7))
        slot = analyzer.fnv1a(word) % (vocab - 1) + 1
        if slot not in seen:
            seen.add(slot)
            words.append(word)
    return words


def _unique_text(n: int, vocab: int, seed: int) -> str:
    words = _words_with_unique_slots(n, vocab, seed)
    rng = np.random.default_rng(seed + 1)
    return " ".join(rng.permutation(words + words[: n // 3]))


ANALYZER_TEXTS = {
    "empty": "",
    "no tokens": " ,.;-- \t\n !!",
    "tied words": "Zeta alpha beta alpha Beta GAMMA zeta",
    "long tokens": "x" * 257 + " " + "y" * 1000 + "z" + " " + "x" * 256 + " " + "q" * 255,
    "mixed utf-8": "Ünïcode wörds — the Kelvin sign K, İstanbul, ASCII 123abc! ok \ud800 x",
    "control bytes": "tab\tnew\nline\x00nul\x01\x7f end",
    "4095 slots": _unique_text(4095, 4096 * 8, 0),
    "4096 slots": _unique_text(4096, 4096 * 8, 1),
    "5000 slots": _unique_text(5000, 4096 * 8, 2),
}


@pytest.mark.parametrize("name", sorted(ANALYZER_TEXTS))
def test_analyzer_matches_jax(name):
    text, vocab = ANALYZER_TEXTS[name], 4096 * 8
    before = native.analyze_calls
    slots, counts, dl = analyzer.analyze(text, vocab)
    assert native.analyze_calls == before + 1
    e_slots, e_counts, e_dl = jax_store._analyze(text, vocab)
    assert slots.dtype == counts.dtype == np.int32 and dl == e_dl
    np.testing.assert_array_equal(slots, e_slots)
    np.testing.assert_array_equal(counts, e_counts)
    scanned = jax_native.analyze_text_native(text, vocab)
    assert (native.analyze_text(text, vocab) is None) == (scanned is None)
    if name.endswith("slots"):
        assert (slots.size, scanned is None) == (int(name[:4]), int(name[:4]) >= 4096)
        assert (np.diff(slots) > 0).all() == (scanned is None)  # the fallback sorts


@settings(max_examples=100, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(texts=st.lists(st.text(max_size=80), max_size=12), vocab=st.sampled_from([2, 97, 4096, FT_VOCAB]))
def test_analyze_texts_matches_jax_and_the_plain_version(texts, vocab):
    slots, counts, offsets, lengths = analyzer.analyze_texts(texts, vocab)
    plain = analyzer.analyze_texts_plain(texts, vocab)
    for got, want in zip((slots, counts, offsets, lengths), plain):
        np.testing.assert_array_equal(got, want)
    for i, text in enumerate(texts):
        e_slots, e_counts, e_dl = jax_store._analyze(text, vocab)
        np.testing.assert_array_equal(slots[offsets[i] : offsets[i + 1]], e_slots)
        np.testing.assert_array_equal(counts[offsets[i] : offsets[i + 1]], e_counts)
        assert lengths[i] == e_dl


BATCH_CHECK = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from verbatim_rag_tpu_torch.engine import analyzer, native

rng = np.random.default_rng(0)
words = np.array(["solar", "Wind", "x" * 300, "caf\\u00e9", "t_1", "42", "a.b", "\\u00dcber"] +
                 ["w%d" % i for i in range(5000)], dtype=object)
texts = [" ".join(rng.choice(words, size=int(rng.integers(0, 60)))) for _ in range(3000)]
texts += ["", " ".join(words[:4400])]
slots, counts, offsets, lengths = native.analyze_batch(texts, 1 << 17, 4096)
same = True
for i, text in enumerate(texts[:-1]):
    one = native.analyze_text(text, 1 << 17)
    same &= bool(np.array_equal(slots[offsets[i]:offsets[i + 1]], one[0]))
    same &= bool(np.array_equal(counts[offsets[i]:offsets[i + 1]], one[1]) and lengths[i] == one[2])
full = offsets[-1] - offsets[-2]
got = analyzer.analyze_texts(texts, 1 << 17)
plain = analyzer.analyze_texts_plain(texts, 1 << 17)
print(json.dumps({
    "same": same, "full": int(full), "n": len(texts),
    "plain": all(bool(np.array_equal(a, b)) for a, b in zip(got, plain)),
}))
"""


def _python(code: str, *args: str, env: dict | None = None) -> dict:
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(env or {})
    out = subprocess.run(
        [sys.executable, "-c", code, str(REPO), *args], cwd=REPO, env=full, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("threads", ["1", "4"])
def test_batch_entry_equals_one_call_a_text(threads):
    """The worker count is read once a process (`native_threads`), so each
    count runs in its own interpreter."""
    result = _python(BATCH_CHECK, env={"VERBATIM_NATIVE_THREADS": threads})
    assert result == {"same": True, "full": 4096, "n": 3002, "plain": True}


def test_project_rows_and_exact_rescore_equal_jax_native():
    rng = np.random.default_rng(3)
    vocab, d, n, m = 500, 24, 200, 9
    proj = rng.standard_normal((vocab, d)).astype(np.float32)
    ids = rng.integers(-2, vocab + 3, size=(n, m)).astype(np.int32)  # out-of-range ids skipped
    w = rng.random((n, m), dtype=np.float32)
    w[:, -3:] = 0.0
    got = native.project_rows(ids, w, proj)
    np.testing.assert_array_equal(got, jax_native.project_rows_native(ids, w, proj))

    ids = np.abs(ids) % vocab
    rows = rng.integers(-1, n, size=(17, 33)).astype(np.int64)
    q = rng.standard_normal((17, vocab)).astype(np.float32)
    got = native.exact_rescore(rows, ids, w, q)
    np.testing.assert_array_equal(got, jax_native.exact_rescore_native(rows, ids, w, q))
    assert np.isneginf(got[rows < 0]).all()
    with pytest.raises(ValueError, match="vocabulary"):
        native.exact_rescore(rows, ids, w, q[:, : vocab // 2])
    with pytest.raises(ValueError, match="shapes"):
        native.exact_rescore(rows, ids, w[:, :-1], q)
    with pytest.raises(ValueError, match="do not match"):
        native.project_rows(ids, w[:-1], proj)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: with a compiler that fails, the scanner's users
    raise `RuntimeError` (the compiler's output in it) instead of taking
    their Python paths."""
    monkeypatch.setenv("VERBATIM_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="false"):
        native.load()
    with pytest.raises(RuntimeError, match="host runtime"):
        tokenizer.HashTokenizer(VOCAB)._tokenize_arrays("plain ascii text, never cached before", None)
    with pytest.raises(RuntimeError, match="host runtime"):
        analyzer.analyze_texts(["a text"], FT_VOCAB)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.load()
    assert not list((tmp_path / "build").glob("*"))  # nothing half written


BUILD_AT_ONCE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from verbatim_rag_tpu_torch.engine import native
from verbatim_rag_tpu_torch.models.tokenizer import HashTokenizer

ids, _ = HashTokenizer()._tokenize_arrays("built at once " + sys.argv[2], None)
print(json.dumps({"path": str(native.library_path()), "ids": ids.tolist(), "calls": native.tokenize_calls}))
"""


def test_processes_that_build_at_once_load_one_library(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["VERBATIM_TORCH_BUILD_DIR"] = str(tmp_path)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", BUILD_AT_ONCE, str(REPO), "x"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(3)
    ]
    results = []
    for proc in procs:
        out, err = proc.communicate(timeout=180)
        assert proc.returncode == 0, err[-3000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert len({r["path"] for r in results}) == 1 and all(r["calls"] == 1 for r in results)
    assert results[0]["ids"] == results[1]["ids"] == results[2]["ids"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [Path(results[0]["path"]).name]
