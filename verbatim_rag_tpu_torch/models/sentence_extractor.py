"""Sentence-level neural extractor, the qa_model-v1 path (port of
`verbatim_rag_tpu/models/sentence_extractor.py`).

Regex sentence splitting, pack ``[CLS] question [SEP] s1 [SEP] s2 …``
(`training.dataset.QADatasetEncoder`), classify each sentence
(`training.model.predict_sentence_relevance`: encoder, prefix-sum mean pool,
linear head), and return the sentences whose relevance probability reaches
the threshold as verbatim spans. Serves the sentence-head checkpoints the
trainer of either package writes (`hf_convert.load_span_extractor` picks
this class for them).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from verbatim_rag_tpu_torch.core.extractors import SpanExtractor
from verbatim_rag_tpu_torch.device import resolve_device

from .config import EncoderConfig, demo_highlighter_config
from .tokenizer import HashTokenizer, Tokenizer

_SENT_RE = re.compile(r"[^.!?\n]+[.!?]?")


def split_sentences(text: str) -> list[tuple[int, int]]:
    """Regex sentence spans (start, end) over the original text."""
    spans = []
    for m in _SENT_RE.finditer(text):
        s, e = m.start(), m.end()
        while s < e and text[s].isspace():
            s += 1
        if e > s:
            spans.append((s, e))
    return spans


class SentenceModelExtractor(SpanExtractor):
    """Classify whole sentences for relevance to the question.

    ``params`` is a state_dict for `training.model.QAModel` (for example
    from `hf_convert.load_highlighter_checkpoint` on a sentence-head
    checkpoint); without it the model is random-initialised from ``seed``
    (`training.model.init_qa_model_params`) and ``checkpoint_dir``, a
    trainer checkpoint, overwrites those weights. The model lives on
    ``device`` (``None`` → ``cuda``).
    """

    def __init__(
        self,
        params: Mapping[str, torch.Tensor] | None = None,
        config: EncoderConfig | None = None,
        tokenizer: Tokenizer | None = None,
        checkpoint_dir: str | None = None,
        threshold: float = 0.5,
        max_length: int = 4096,
        max_sentences: int = 64,
        seed: int = 0,
        device=None,
    ):
        from verbatim_rag_tpu_torch.training.model import QAModel, init_qa_model_params

        self.config = config or demo_highlighter_config()
        self.tokenizer = tokenizer or HashTokenizer(vocab_size=self.config.vocab_size)
        self.threshold = threshold
        self.max_length = max_length
        self.max_sentences = max_sentences
        self.device = resolve_device(device)
        if params is not None:
            if "sentence_classifier.kernel" not in params:
                raise ValueError(
                    "these weights hold no sentence_classifier head: the sentence "
                    "extractor serves sentence-head trainer checkpoints"
                )
            self.model = QAModel(self.config)
            self.model.load_state_dict(dict(params))
            self.model.to(self.device)
        else:
            self.model = init_qa_model_params(self.config, seed, self.device)
            if checkpoint_dir:
                from verbatim_rag_tpu_torch.training.trainer import Trainer

                Trainer.load_checkpoint(checkpoint_dir, self.model)
        self.model.eval()

    def extract_spans(self, question: str, search_results: list[Any]) -> dict[str, list[str]]:
        texts = [getattr(r, "text", "") for r in search_results]
        out: dict[str, list[str]] = {t: [] for t in texts}
        if not texts:
            return out
        sentence_spans, sentence_mask, probs = self.sentence_probs(question, texts)
        for i, (text, spans) in enumerate(zip(texts, sentence_spans)):
            kept = []
            for j, (s, e) in enumerate(spans[: self.max_sentences]):
                if sentence_mask[i, j] and probs[i, j] >= self.threshold:
                    kept.append(text[s:e])
            out[text] = kept
        return out

    def sentence_probs(
        self, question: str, texts: list[str]
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray, np.ndarray]:
        """Each text's sentence spans, the batch's sentence mask [B, M] and
        the relevance probabilities [B, M] (float32) of one forward."""
        from verbatim_rag_tpu_torch.training.dataset import QADatasetEncoder, QADocument, Sentence
        from verbatim_rag_tpu_torch.training.model import predict_sentence_relevance

        # Keep only sentences that tokenize to ≥1 token: QADatasetEncoder
        # skips empty-token sentences, which would shift every later
        # boundary and probability off by one against `sentence_spans` (a
        # '---' separator line would absorb the next sentence's score).
        sentence_spans = [
            [
                (s, e)
                for s, e in split_sentences(t)
                if self.tokenizer.tokenize_with_offsets(t[s:e])[0]
            ]
            for t in texts
        ]
        pairs = [
            (question, QADocument(sentences=[Sentence(text=text[s:e]) for s, e in spans]))
            for text, spans in zip(texts, sentence_spans)
        ]
        encoder = QADatasetEncoder(
            self.tokenizer, max_length=self.max_length, max_sentences=self.max_sentences
        )
        batch = encoder.encode_pairs(pairs)

        def put(array):
            return torch.from_numpy(array).to(self.device)

        probs = predict_sentence_relevance(
            self.model,
            put(batch.input_ids),
            put(batch.attention_mask),
            put(batch.boundaries),
            put(batch.sentence_mask),
        )
        return sentence_spans, batch.sentence_mask, probs.cpu().numpy()
