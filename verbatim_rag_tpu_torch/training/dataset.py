"""Training data model + fixed-shape encoding for the sentence classifier.

Copy of `verbatim_rag_tpu/training/dataset.py` (pinned by
`tests/test_torch_copies.py`): the Sentence/Document/QASample/QAData JSON
hierarchy and the encoding that packs ``[CLS] question [SEP] s1 [SEP] s2 …``
with per-sentence token boundaries and whole-sentence truncation at
max_length. Token ids are padded to a bucket length and sentence boundaries
to ``max_sentences`` with a sentence mask, so a batch's shape is one of a
few.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np

from verbatim_rag_tpu_torch.models.tokenizer import bucket_length


@dataclass
class Sentence:
    text: str
    relevant: bool = False


@dataclass
class QADocument:
    sentences: list[Sentence] = field(default_factory=list)


@dataclass
class QASample:
    question: str
    documents: list[QADocument] = field(default_factory=list)
    split: str = "train"


@dataclass
class QAData:
    samples: list[QASample] = field(default_factory=list)

    @classmethod
    def from_json(cls, path: str) -> "QAData":
        with open(path) as f:
            raw = json.load(f)
        samples = []
        for item in raw if isinstance(raw, list) else raw.get("samples", []):
            documents = []
            for doc in item.get("documents", []):
                sentences = [
                    Sentence(text=s["text"], relevant=bool(s.get("relevant", False)))
                    for s in doc.get("sentences", [])
                ]
                documents.append(QADocument(sentences=sentences))
            samples.append(
                QASample(
                    question=item.get("question", ""),
                    documents=documents,
                    split=item.get("split", "train"),
                )
            )
        return cls(samples)

    def to_json(self, path: str) -> None:
        data = [
            {
                "question": s.question,
                "split": s.split,
                "documents": [
                    {
                        "sentences": [
                            {"text": sent.text, "relevant": sent.relevant}
                            for sent in d.sentences
                        ]
                    }
                    for d in s.documents
                ],
            }
            for s in self.samples
        ]
        with open(path, "w") as f:
            json.dump(data, f)

    def filter_split(self, split: str) -> list[QASample]:
        return [s for s in self.samples if s.split == split]


@dataclass
class EncodedBatch:
    """Fixed-shape batch for the sentence classifier."""

    input_ids: np.ndarray  # [B, S]
    attention_mask: np.ndarray  # [B, S]
    boundaries: np.ndarray  # [B, max_sent, 2] token (start, end)
    sentence_mask: np.ndarray  # [B, max_sent] {0,1}
    labels: np.ndarray  # [B, max_sent] {0,1}


class QADatasetEncoder:
    """Encode (question, document) pairs into fixed-shape arrays."""

    def __init__(
        self,
        tokenizer,
        max_length: int = 4096,
        max_sentences: int = 64,
    ):
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.max_sentences = max_sentences

    def encode_pairs(self, pairs: list[tuple[str, QADocument]]) -> EncodedBatch:
        """Encode [(question, document)] → one fixed-shape batch.

        Packs ``[CLS] q [SEP] s1 [SEP] s2 [SEP] …`` keeping whole sentences
        until max_length (truncation parity: `dataset.py:199-218`).
        """
        rows, bounds, masks, labels = [], [], [], []
        tok = self.tokenizer
        for question, document in pairs:
            q_ids, _ = tok.tokenize_with_offsets(question)
            ids = [tok.cls_id] + q_ids[:256] + [tok.sep_id]
            row_bounds, row_labels = [], []
            for sentence in document.sentences[: self.max_sentences]:
                s_ids, _ = tok.tokenize_with_offsets(sentence.text)
                if not s_ids:
                    continue
                if len(ids) + len(s_ids) + 1 > self.max_length:
                    break  # whole-sentence truncation
                start = len(ids)
                ids.extend(s_ids)
                end = len(ids)
                ids.append(tok.sep_id)
                row_bounds.append((start, end))
                row_labels.append(1 if sentence.relevant else 0)
            rows.append(ids)
            bounds.append(row_bounds)
            labels.append(row_labels)
            masks.append([1] * len(row_bounds))

        seq = min(bucket_length(max((len(r) for r in rows), default=1)), self.max_length)
        batch = len(rows)
        input_ids = np.full((batch, seq), tok.pad_id, np.int32)
        attention_mask = np.zeros((batch, seq), np.int32)
        boundaries = np.zeros((batch, self.max_sentences, 2), np.int32)
        sentence_mask = np.zeros((batch, self.max_sentences), np.int32)
        label_arr = np.zeros((batch, self.max_sentences), np.int32)
        for i in range(batch):
            ids = rows[i][:seq]
            input_ids[i, : len(ids)] = ids
            attention_mask[i, : len(ids)] = 1
            for j, (s, e) in enumerate(bounds[i]):
                if e > seq:
                    break
                boundaries[i, j] = (s, e)
                sentence_mask[i, j] = 1
                label_arr[i, j] = labels[i][j]
        return EncodedBatch(input_ids, attention_mask, boundaries, sentence_mask, label_arr)

    def iter_batches(
        self,
        samples: list[QASample],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
    ) -> Iterator[EncodedBatch]:
        """Flatten samples to (question, document) pairs and batch them."""
        pairs: list[tuple[str, QADocument]] = []
        for s in samples:
            for d in s.documents:
                if d.sentences:
                    pairs.append((s.question, d))
        order = np.arange(len(pairs))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(pairs), batch_size):
            idx = order[start : start + batch_size]
            if drop_remainder and len(idx) < batch_size:
                break
            yield self.encode_pairs([pairs[i] for i in idx])


def make_synthetic_qadata(
    n_samples: int = 32,
    sentences_per_doc: int = 6,
    seed: int = 0,
    task: str = "marker",
) -> QAData:
    """Tiny synthetic dataset for tests/benchmarks.

    task="marker": relevance is signaled by an in-sentence marker token —
    trivially learnable, so tests exercising the train→extract→eval plumbing
    converge deterministically. task="keyword": relevance = sentence mentions
    the question's topic — a harder matching task for optimization studies.
    """
    rng = np.random.default_rng(seed)
    topics = ["solar", "wind", "pasta", "rivers", "metals", "birds"]
    samples = []
    for i in range(n_samples):
        topic = topics[rng.integers(len(topics))]
        others = [t for t in topics if t != topic]
        sentences = []
        for j in range(sentences_per_doc):
            relevant = bool(rng.random() < 0.3)
            if task == "marker":
                word = topic if relevant else others[rng.integers(len(others))]
                flag = "noteworthy" if relevant else "ordinary"
                text = f"Sentence {j} has {flag} detail about {word} number {rng.integers(100)}."
            else:
                word = topic if relevant else others[rng.integers(len(others))]
                text = f"Sentence {j} about {word} with detail {rng.integers(100)}."
            sentences.append(Sentence(text=text, relevant=relevant))
        samples.append(
            QASample(
                question=f"what about {topic}?",
                documents=[QADocument(sentences=sentences)],
                split="train" if i % 5 else "dev",
            )
        )
    return QAData(samples)
