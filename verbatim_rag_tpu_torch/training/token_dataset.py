"""Token-classification training data for the v2 highlighter.

Copy of `verbatim_rag_tpu/training/token_dataset.py` (pinned by
`tests/test_torch_copies.py`): (question, context, gold char spans) examples
are encoded into the same windowed layout the inference path uses
(`models/highlighter.py`), with per-token binary labels from char-span
overlap, so a model trained on them is directly consumable by
`ModelSpanExtractor`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from verbatim_rag_tpu_torch.models.tokenizer import bucket_length


@dataclass
class TokenSpanExample:
    question: str
    context: str
    #: gold answer spans as (start, end) char offsets into context
    spans: list[tuple[int, int]] = field(default_factory=list)
    split: str = "train"

    @classmethod
    def from_dict(cls, data: dict) -> "TokenSpanExample":
        spans = []
        for ans in data.get("answers", []):
            if isinstance(ans, (list, tuple)) and len(ans) == 2:
                spans.append((int(ans[0]), int(ans[1])))
            elif isinstance(ans, str):
                pos = data["context"].find(ans)
                if pos >= 0:
                    spans.append((pos, pos + len(ans)))
        return cls(
            question=data["question"],
            context=data["context"],
            spans=spans,
            split=data.get("split", "train"),
        )


def load_token_examples(path: str) -> list[TokenSpanExample]:
    """JSON array or JSONL of {question, context, answers, split?}."""
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        raw = json.load(f) if head == "[" else [json.loads(ln) for ln in f if ln.strip()]
    return [TokenSpanExample.from_dict(d) for d in raw]


@dataclass
class TokenBatch:
    input_ids: np.ndarray  # [B, S]
    attention_mask: np.ndarray  # [B, S]
    labels: np.ndarray  # [B, S] {0,1}
    label_mask: np.ndarray  # [B, S] — 1 only on context tokens


class TokenDatasetEncoder:
    """(question, context, char spans) → windowed token-labeled batches."""

    def __init__(self, tokenizer, max_length: int = 512, doc_stride: int = 128):
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.doc_stride = doc_stride

    def encode(self, examples: list[TokenSpanExample]) -> TokenBatch:
        tok = self.tokenizer
        rows, labels_rows, mask_rows = [], [], []
        for ex in examples:
            q_ids, _ = tok.tokenize_with_offsets(ex.question)
            q_frame = [tok.cls_id] + q_ids[:64] + [tok.sep_id]
            ctx_ids, ctx_offsets = tok.tokenize_with_offsets(ex.context)

            token_labels = np.zeros(len(ctx_ids), np.int32)
            for start, end in ex.spans:
                for j, (t_start, t_end) in enumerate(ctx_offsets):
                    if t_start < end and t_end > start:
                        token_labels[j] = 1

            budget = max(self.max_length - len(q_frame) - 1, 8)
            step = max(budget - self.doc_stride, 1)
            for w_start in range(0, max(len(ctx_ids), 1), step):
                w_ids = ctx_ids[w_start : w_start + budget]
                w_labels = token_labels[w_start : w_start + budget]
                row = q_frame + list(w_ids) + [tok.sep_id]
                row_labels = [0] * len(q_frame) + list(w_labels) + [0]
                row_mask = [0] * len(q_frame) + [1] * len(w_ids) + [0]
                rows.append(row)
                labels_rows.append(row_labels)
                mask_rows.append(row_mask)
                if w_start + budget >= len(ctx_ids):
                    break

        seq = min(bucket_length(max((len(r) for r in rows), default=1)), self.max_length)
        batch = len(rows)
        input_ids = np.full((batch, seq), tok.pad_id, np.int32)
        attention = np.zeros((batch, seq), np.int32)
        labels = np.zeros((batch, seq), np.int32)
        label_mask = np.zeros((batch, seq), np.int32)
        for i in range(batch):
            row = rows[i][:seq]
            input_ids[i, : len(row)] = row
            attention[i, : len(row)] = 1
            labels[i, : len(row)] = labels_rows[i][:seq]
            label_mask[i, : len(row)] = mask_rows[i][:seq]
        return TokenBatch(input_ids, attention, labels, label_mask)

    def iter_batches(
        self,
        examples: list[TokenSpanExample],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
    ) -> Iterator[TokenBatch]:
        order = np.arange(len(examples))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(examples), batch_size):
            idx = order[start : start + batch_size]
            yield self.encode([examples[i] for i in idx])


def make_synthetic_token_data(
    n_examples: int = 64, seed: int = 0
) -> list[TokenSpanExample]:
    """Synthetic marker task at span level: 'noteworthy' clauses are gold."""
    rng = np.random.default_rng(seed)
    topics = ["solar", "wind", "pasta", "rivers", "metals", "birds"]
    out = []
    for i in range(n_examples):
        topic = topics[rng.integers(len(topics))]
        parts, spans, pos = [], [], 0
        for j in range(5):
            relevant = bool(rng.random() < 0.35)
            flag = "noteworthy" if relevant else "ordinary"
            sentence = f"Clause {j} is {flag} about {topic} item {rng.integers(50)}. "
            if relevant:
                spans.append((pos, pos + len(sentence.rstrip())))
            parts.append(sentence)
            pos += len(sentence)
        out.append(
            TokenSpanExample(
                question=f"what about {topic}?",
                context="".join(parts),
                spans=spans,
                split="train" if i % 5 else "dev",
            )
        )
    return out
