"""Rerankers: reorder retrieved results by cross-encoder relevance (copy of
`verbatim_rag_tpu/rag/rerankers.py`).

The `Reranker` ABC with a to-thread async default, the `BaseReranker`
contract of reranking only the top ``rerank_k`` results and keeping the tail
order, and the adapters: `JaxReranker` over the port's cross-encoder
(`models.reranker.JaxCrossEncoder`, on the card), the local Jina V3 model
through transformers, and the Cohere and Jina HTTP APIs over httpx (imported
where a request is made).
"""

from __future__ import annotations

import asyncio
import logging
from abc import ABC, abstractmethod
from typing import Any, Sequence

logger = logging.getLogger(__name__)


def _texts_for(results: list[Any], text_field: str) -> list[str]:
    """The scored attribute per result, falling back to ``.text``."""
    return [getattr(r, text_field, None) or getattr(r, "text", "") for r in results]


class Reranker(ABC):
    @abstractmethod
    def rerank(self, question: str, results: list[Any]) -> list[Any]:
        """Return results reordered by relevance to the question."""

    async def rerank_async(self, question: str, results: list[Any]) -> list[Any]:
        return await asyncio.to_thread(self.rerank, question, results)


class BaseReranker(Reranker):
    """Rerank only the head of the list; the tail keeps retrieval order.

    ``text_field`` selects which result attribute is scored (parity:
    ref `rerankers.py:25-41` — "text" or "enhanced_text").
    """

    def __init__(self, rerank_k: int = 50, text_field: str = "text"):
        self.rerank_k = rerank_k
        self.text_field = text_field

    @abstractmethod
    def score(self, question: str, texts: Sequence[str]) -> list[float]:
        """Relevance score per text (higher = more relevant)."""

    def _get_texts(self, results: list[Any]) -> list[str]:
        return _texts_for(results, self.text_field)

    def rerank(self, question: str, results: list[Any]) -> list[Any]:
        if not results:
            return results
        head = results[: self.rerank_k]
        tail = results[self.rerank_k :]
        scores = self.score(question, self._get_texts(head))
        order = sorted(range(len(head)), key=lambda i: -scores[i])
        return [head[i] for i in order] + tail


class JaxReranker(BaseReranker):
    """Cross-encoder reranker on the port's encoder (replaces the reference's
    SentenceTransformersReranker)."""

    def __init__(self, cross_encoder=None, rerank_k: int = 50, **ce_kwargs):
        super().__init__(rerank_k=rerank_k)
        if cross_encoder is None:
            from verbatim_rag_tpu_torch.models.reranker import JaxCrossEncoder

            cross_encoder = JaxCrossEncoder(**ce_kwargs)
        self.cross_encoder = cross_encoder

    def score(self, question: str, texts: Sequence[str]) -> list[float]:
        return [float(s) for s in self.cross_encoder.score(question, list(texts))]


class JinaV3Reranker(Reranker):
    """Local Jina V3 reranker via transformers remote-code ``.rerank()``.

    Parity: ref `rerankers.py:137-164` — loads
    ``jinaai/jina-reranker-v3`` with ``AutoModel.from_pretrained(...,
    trust_remote_code=True)`` and delegates ordering to the model's own
    ``rerank(query, texts, top_n)`` API (listwise; returns index order, not
    per-text scores — hence a direct `Reranker`, not a `BaseReranker`).
    """

    def __init__(
        self,
        model: str = "jinaai/jina-reranker-v3",
        rerank_k: int = 50,
        text_field: str = "text",
        _model_obj=None,
    ):
        self.rerank_k = rerank_k
        self.text_field = text_field
        if _model_obj is not None:  # injection seam for offline tests
            self.model = _model_obj
            return
        try:
            from transformers import AutoModel
        except ImportError as exc:  # pragma: no cover
            raise ImportError("JinaV3Reranker requires transformers") from exc
        self.model = AutoModel.from_pretrained(model, dtype="auto", trust_remote_code=True)
        self.model.eval()

    def rerank(self, question: str, results: list[Any]) -> list[Any]:
        if not results:
            return results
        head = results[: self.rerank_k]
        tail = results[self.rerank_k :]
        ranked = self.model.rerank(
            question, _texts_for(head, self.text_field), top_n=self.rerank_k
        )
        order = [item["index"] for item in ranked]
        # The model may return fewer than len(head) items (top_n cut);
        # preserve every result — unranked head entries keep retrieval order.
        seen = set(order)
        rest = [i for i in range(len(head)) if i not in seen]
        return [head[i] for i in order + rest] + tail


class _HttpReranker(BaseReranker):
    """Shared adapter for bearer-token /rerank HTTP APIs (Cohere, Jina):
    identical wire shape, response parsing, and score assembly — one
    implementation so fixes (timeouts, out-of-range indices) apply to both."""

    def __init__(self, api_key: str, model: str, rerank_k: int, api_base: str):
        super().__init__(rerank_k=rerank_k)
        self.api_key = api_key
        self.model = model
        self.api_base = api_base.rstrip("/")

    def score(self, question: str, texts: Sequence[str]) -> list[float]:
        import httpx

        resp = httpx.post(
            f"{self.api_base}/rerank",
            headers={"Authorization": f"Bearer {self.api_key}"},
            json={"model": self.model, "query": question, "documents": list(texts)},
            timeout=30.0,
        )
        resp.raise_for_status()
        scores = [0.0] * len(texts)
        for item in resp.json().get("results", []):
            idx = int(item.get("index", -1))
            if 0 <= idx < len(texts):
                scores[idx] = float(item["relevance_score"])
        return scores


class CohereReranker(_HttpReranker):
    """Cohere rerank API adapter."""

    def __init__(
        self,
        api_key: str,
        model: str = "rerank-english-v3.0",
        rerank_k: int = 50,
        api_base: str = "https://api.cohere.ai/v1",
    ):
        super().__init__(api_key, model, rerank_k, api_base)


class JinaReranker(_HttpReranker):
    """Jina rerank API adapter."""

    def __init__(
        self,
        api_key: str,
        model: str = "jina-reranker-v2-base-multilingual",
        rerank_k: int = 50,
        api_base: str = "https://api.jina.ai/v1",
    ):
        super().__init__(api_key, model, rerank_k, api_base)
