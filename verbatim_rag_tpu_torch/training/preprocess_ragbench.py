"""RAGBench → QAData preprocessing (copy of
`verbatim_rag_tpu/training/preprocess_ragbench.py`).

Converts the 12 RAGBench HF subsets to sentence-relevance training data,
labelling sentences by `all_relevant_sentence_keys`. Needs the ``datasets``
package and a local copy of RAGBench (imported and read in
`convert_subsets`); `convert_example` works on one row alone.
"""

from __future__ import annotations

import argparse
import logging

from .dataset import QAData, QADocument, QASample, Sentence

logger = logging.getLogger(__name__)

RAGBENCH_SUBSETS = [
    "covidqa",
    "cuad",
    "delucionqa",
    "emanual",
    "expertqa",
    "finqa",
    "hagrid",
    "hotpotqa",
    "msmarco",
    "pubmedqa",
    "tatqa",
    "techqa",
]


def convert_example(example: dict) -> QASample | None:
    """One RAGBench row → QASample (sentence labels from relevant keys)."""
    relevant_keys = set(example.get("all_relevant_sentence_keys") or [])
    documents = []
    for doc_sentences in example.get("documents_sentences") or []:
        sentences = []
        for item in doc_sentences:
            # Each item is [sentence_key, sentence_text].
            if not isinstance(item, (list, tuple)) or len(item) != 2:
                continue
            key, text = item
            if text and text.strip():
                sentences.append(Sentence(text=text, relevant=key in relevant_keys))
        if sentences:
            documents.append(QADocument(sentences=sentences))
    if not documents:
        return None
    return QASample(question=example.get("question", ""), documents=documents)


def convert_subsets(
    subsets: list[str], split: str = "train", dataset_path: str = "rungalileo/ragbench"
) -> QAData:
    from datasets import load_dataset

    data = QAData()
    for subset in subsets:
        logger.info("Converting %s/%s", subset, split)
        ds = load_dataset(dataset_path, subset, split=split)
        for example in ds:
            sample = convert_example(example)
            if sample is not None:
                sample.split = {"validation": "dev"}.get(split, split)
                data.samples.append(sample)
    return data


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", required=True)
    parser.add_argument("--subsets", nargs="*", default=RAGBENCH_SUBSETS)
    parser.add_argument("--splits", nargs="*", default=["train", "validation", "test"])
    parser.add_argument("--dataset-path", default="rungalileo/ragbench")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    merged = QAData()
    for split in args.splits:
        part = convert_subsets(args.subsets, split, args.dataset_path)
        merged.samples.extend(part.samples)
    merged.to_json(args.output)
    print(f"Wrote {len(merged.samples)} samples to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
