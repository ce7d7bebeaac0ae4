"""Host-side tokenization for the encoders.

Copy of `verbatim_rag_tpu/models/tokenizer.py`: the file-free
:class:`HashTokenizer` (word-level hashing into the configured vocab with
BERT-style special ids; ASCII text through the compiled scan of
`engine/native.py`, other text through its Python regex loop) and
:class:`HFTokenizer`,
which wraps a checkpoint's ``tokenizer.json`` through the ``tokenizers``
library (imported in its constructor, so nothing on the offline path needs
it). Ids, offsets and the padded batch layout are identical to the original
(pinned by `tests/test_torch_copies.py` and `tests/test_torch_hf_convert.py`).
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod
from dataclasses import dataclass

import numpy as np

from verbatim_rag_tpu_torch.engine import native
from verbatim_rag_tpu_torch.engine.filters import stable_hash64

_WORD_RE = re.compile(r"[a-z0-9]+|[^\w\s]")

#: Pad batches to these sequence lengths to bound the set of shapes.
DEFAULT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


@dataclass
class TokenizedBatch:
    input_ids: np.ndarray  # [B, S] int32
    attention_mask: np.ndarray  # [B, S] int32
    #: per text: list of (char_start, char_end) per token (specials = (0, 0))
    offsets: list[list[tuple[int, int]]] | None = None


def bucket_length(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest padded length ≥ n: one of `buckets`, or past the last bucket
    a multiple of it (callers cap with their own max_length)."""
    for b in buckets:
        if n <= b:
            return b
    last = buckets[-1]
    return -(-n // last) * last


class Tokenizer(ABC):
    pad_id: int = 0
    cls_id: int = 101
    sep_id: int = 102

    @abstractmethod
    def encode_batch(
        self,
        texts: list[str],
        max_length: int = 512,
        pair: list[str] | None = None,
        with_offsets: bool = False,
    ) -> TokenizedBatch: ...


class HashTokenizer(Tokenizer):
    """Deterministic word-hash tokenizer (no vocab files needed)."""

    #: word→id memo cap (guards against unbounded token streams).
    _CACHE_MAX = 1 << 20

    def __init__(self, vocab_size: int = 30522, buckets=DEFAULT_BUCKETS):
        self.vocab_size = vocab_size
        self.buckets = buckets
        self._hash = stable_hash64
        self.pad_id, self.cls_id, self.sep_id = 0, 1, 2
        self._reserved = 3
        self._word_cache: dict[str, int] = {}

    def _word_id(self, word: str) -> int:
        wid = self._word_cache.get(word)
        if wid is None:
            span = self.vocab_size - self._reserved
            wid = self._reserved + int(self._hash(word.lower())) % span
            if len(self._word_cache) < self._CACHE_MAX:
                self._word_cache[word] = wid
        return wid

    def describe(self) -> dict:
        return {"class": "HashTokenizer", "vocab_size": self.vocab_size}

    #: class-level (vocab, max_tokens, text) → (ids, offsets) memo shared by
    #: every instance; bounded, cleared wholesale when full.
    _text_cache: dict = {}
    _TEXT_CACHE_MAX = 8192
    #: long documents are not cached: the token bound caps the cached arrays,
    #: the char bound caps the key string itself.
    _TEXT_CACHE_MAX_TOKENS = 4096
    _TEXT_CACHE_MAX_CHARS = 16384

    def _tokenize_arrays(
        self, text: str, max_tokens: int | None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Tokenize to ``(ids int32[n], offsets int32[n, 2])``: the compiled
        scan (`engine/native.py::hash_tokenize`, bit-exact for ASCII), the
        Python regex loop for other text. ``max_tokens`` stops the scan
        early."""
        key = (self.vocab_size, max_tokens, text)
        cache = HashTokenizer._text_cache
        hit = cache.get(key)
        if hit is not None:
            return hit
        out = native.hash_tokenize(
            text,
            self.vocab_size,
            self._reserved,
            max_tokens if max_tokens is not None else (1 << 62),
        )
        if out is None:
            out = self._regex_arrays(text, max_tokens)
        if (
            out[0].size <= self._TEXT_CACHE_MAX_TOKENS
            and len(text) <= self._TEXT_CACHE_MAX_CHARS
        ):
            if len(cache) >= self._TEXT_CACHE_MAX:
                cache.clear()
            cache[key] = out
        return out

    def _regex_arrays(
        self, text: str, max_tokens: int | None
    ) -> tuple[np.ndarray, np.ndarray]:
        """The Python regex loop: what the compiled scan computes for ASCII
        text, and the path for every other text."""
        ids_l: list[int] = []
        offs_l: list[tuple[int, int]] = []
        for m in _WORD_RE.finditer(text.lower()):
            ids_l.append(self._word_id(m.group(0)))
            offs_l.append((m.start(), m.end()))
            if max_tokens is not None and len(ids_l) >= max_tokens:
                break
        return (
            np.asarray(ids_l, np.int32),
            np.asarray(offs_l, np.int32).reshape(len(offs_l), 2),
        )

    def tokenize_with_offsets(
        self, text: str, max_tokens: int | None = None
    ) -> tuple[list[int], list[tuple[int, int]]]:
        ids, offsets = self._tokenize_arrays(text, max_tokens)
        return ids.tolist(), list(
            zip(offsets[:, 0].tolist(), offsets[:, 1].tolist())
        )

    def encode_batch(
        self,
        texts: list[str],
        max_length: int = 512,
        pair: list[str] | None = None,
        with_offsets: bool = False,
    ) -> TokenizedBatch:
        per: list[tuple[np.ndarray, np.ndarray, np.ndarray | None]] = []
        lengths = []
        for i, text in enumerate(texts):
            ids, offsets = self._tokenize_arrays(text, max_tokens=max_length)
            p_ids = None
            if pair is not None:
                p_ids, _ = self._tokenize_arrays(pair[i], max_tokens=max_length)
            per.append((ids, offsets, p_ids))
            full = 2 + len(ids) + (len(p_ids) + 1 if p_ids is not None else 0)
            lengths.append(min(full, max_length))

        seq = min(bucket_length(max(lengths), self.buckets), max_length)
        batch = np.full((len(per), seq), self.pad_id, np.int32)
        mask = np.zeros((len(per), seq), np.int32)
        offs_out: list[list[tuple[int, int]]] | None = [] if with_offsets else None
        for i, (ids, offsets, p_ids) in enumerate(per):
            batch[i, 0] = self.cls_id
            pos = 1
            n = min(len(ids), seq - pos)
            batch[i, pos : pos + n] = ids[:n]
            pos += n
            if pos < seq:
                batch[i, pos] = self.sep_id
                pos += 1
            if p_ids is not None:
                pn = min(len(p_ids), seq - pos)
                batch[i, pos : pos + pn] = p_ids[:pn]
                pos += pn
                if pos < seq:
                    batch[i, pos] = self.sep_id
                    pos += 1
            mask[i, :pos] = 1
            if offs_out is not None:
                row = [(0, 0)] + list(
                    zip(offsets[:n, 0].tolist(), offsets[:n, 1].tolist())
                )
                row += [(0, 0)] * (pos - len(row))
                offs_out.append(row)
        return TokenizedBatch(batch, mask, offs_out)


class HFTokenizer(Tokenizer):
    """Wraps a HuggingFace fast tokenizer file (tokenizer.json)."""

    def __init__(self, path: str, buckets=DEFAULT_BUCKETS):
        from tokenizers import Tokenizer as RustTokenizer

        self._tok = (
            RustTokenizer.from_file(path)
            if path.endswith(".json")
            else RustTokenizer.from_pretrained(path)
        )
        self.path = path
        self.buckets = buckets
        self.pad_id = self._tok.token_to_id("[PAD]") or 0
        self.cls_id = self._tok.token_to_id("[CLS]") or 101
        self.sep_id = self._tok.token_to_id("[SEP]") or 102
        self._tok.no_padding()
        self._tok.no_truncation()

    def describe(self) -> dict:
        return {"class": "HFTokenizer", "path": self.path}

    def encode_batch(
        self,
        texts: list[str],
        max_length: int = 512,
        pair: list[str] | None = None,
        with_offsets: bool = False,
    ) -> TokenizedBatch:
        inputs = list(zip(texts, pair)) if pair is not None else list(texts)
        encodings = self._tok.encode_batch(inputs)
        rows = [e.ids[:max_length] for e in encodings]
        offs = [list(e.offsets[:max_length]) for e in encodings]

        seq = min(bucket_length(max(len(r) for r in rows), self.buckets), max_length)
        batch = np.full((len(rows), seq), self.pad_id, np.int32)
        mask = np.zeros((len(rows), seq), np.int32)
        for i, ids in enumerate(rows):
            ids = ids[:seq]
            batch[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
            offs[i] = offs[i][:seq]
        return TokenizedBatch(batch, mask, offs if with_offsets else None)

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()


BERT_SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def train_wordpiece_tokenizer(path: str, texts, vocab_size: int = 8000):
    """Train a BERT-style WordPiece ``tokenizer.json`` on ``texts`` (BERT
    normalizer and specials, ``[CLS] a [SEP] b [SEP]`` pairs) and save it at
    ``path``. A directory staged from a checkpoint trained with
    :class:`HashTokenizer` has no tokenizer file; this gives the tests and
    the smoke run one. Returns the `tokenizers.Tokenizer`."""
    from tokenizers import Tokenizer as RustTokenizer
    from tokenizers import models, normalizers, pre_tokenizers, processors, trainers

    tok = RustTokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.train_from_iterator(
        list(texts),
        trainers.WordPieceTrainer(vocab_size=vocab_size, special_tokens=list(BERT_SPECIAL_TOKENS)),
    )
    cls_id, sep_id = tok.token_to_id("[CLS]"), tok.token_to_id("[SEP]")
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]",
        pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", cls_id), ("[SEP]", sep_id)],
    )
    tok.save(str(path))
    return tok
