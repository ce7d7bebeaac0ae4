"""Micro Word-F1 evaluation for span extraction (copy of
`verbatim_rag_tpu/training/eval_f1.py`).

- each example: {question, context, answers: [gold span, ...]}
- prediction: the extractor's spans for (question, context)
- **micro Word-F1**: word multisets of predicted vs gold spans, TP/FP/FN
  accumulated over ALL examples, F1 computed once at the end (micro), the
  standard extractive-QA word-overlap scoring.

CLI: ``python -m verbatim_rag_tpu_torch.training.eval_f1 --data data.json
[--model-path ckpt_dir] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import re
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, Iterable

_WORD_RE = re.compile(r"\w+", re.UNICODE)


def words(text: str) -> list[str]:
    return [w.lower() for w in _WORD_RE.findall(text)]


@dataclass
class F1Counts:
    tp: float = 0.0
    fp: float = 0.0
    fn: float = 0.0

    def add(self, predicted: Iterable[str], gold: Iterable[str]) -> None:
        pred_counts = Counter()
        for span in predicted:
            pred_counts.update(words(span))
        gold_counts = Counter()
        for span in gold:
            gold_counts.update(words(span))
        overlap = sum((pred_counts & gold_counts).values())
        self.tp += overlap
        self.fp += sum(pred_counts.values()) - overlap
        self.fn += sum(gold_counts.values()) - overlap

    @property
    def precision(self) -> float:
        return self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0

    @property
    def recall(self) -> float:
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0


def evaluate_extractor(
    extract: Callable[[str, str], list[str]],
    examples: list[dict[str, Any]],
) -> dict[str, float]:
    """Score ``extract(question, context) -> [span, ...]`` with micro Word-F1."""
    counts = F1Counts()
    for ex in examples:
        predicted = extract(ex["question"], ex["context"])
        counts.add(predicted, ex.get("answers", []))
    return {
        "micro_word_f1": round(100 * counts.f1, 2),
        "precision": round(100 * counts.precision, 2),
        "recall": round(100 * counts.recall, 2),
        "n_examples": len(examples),
    }


def load_examples(path: str) -> list[dict[str, Any]]:
    """Accept a JSON array or JSONL of {question, context, answers}."""
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "[":
            return json.load(f)
        return [json.loads(line) for line in f if line.strip()]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", required=True, help="JSON/JSONL eval file")
    parser.add_argument("--model-path", help="highlighter checkpoint dir (native or HF format)")
    parser.add_argument("--threshold", type=float, default=0.2)
    parser.add_argument("--min-span-chars", type=int, default=30)
    parser.add_argument("--merge-gap-chars", type=int, default=20)
    parser.add_argument("--max-length", type=int, default=8192)
    parser.add_argument("--doc-stride", type=int, default=256)
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    args = parser.parse_args(argv)

    from verbatim_rag_tpu_torch.models.highlighter import ModelSpanExtractor

    extractor = ModelSpanExtractor(
        model_path=args.model_path,
        threshold=args.threshold,
        min_span_chars=args.min_span_chars,
        merge_gap_chars=args.merge_gap_chars,
        max_length=args.max_length,
        doc_stride=args.doc_stride,
        device=args.device,
    )

    def extract(question: str, context: str) -> list[str]:
        return [context[s:e] for s, e in extractor.process(question, context)]

    metrics = evaluate_extractor(extract, load_examples(args.data))
    print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
