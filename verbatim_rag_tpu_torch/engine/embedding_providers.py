"""Embedding providers: text → dense vectors / sparse term-weight dicts.

Copy of `verbatim_rag_tpu/engine/embedding_providers.py`: the two provider
contracts, the deterministic, model-free providers (hashed bag-of-words
dense; hashed tf sparse) that the offline path uses, and the remote
`OpenAIEmbeddingProvider` (an OpenAI-compatible ``/embeddings`` endpoint over
httpx). Outputs are identical to the original (pinned by
`tests/test_torch_copies.py` and `tests/test_torch_remote_embeddings.py`).
The neural providers live in `models/providers.py`;
:func:`provider_from_config` rebuilds any of them from its persisted
identity.
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod
from typing import Sequence

import numpy as np

from .filters import stable_hash64

_WORD_RE = re.compile(r"[a-z0-9]+")


class DenseEmbeddingProvider(ABC):
    @abstractmethod
    def embed_text(self, text: str) -> np.ndarray:
        """Embed one text → [d] float32."""

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Embed many texts → [n, d]; override for true batching."""
        return np.stack([self.embed_text(t) for t in texts])

    @abstractmethod
    def get_dimension(self) -> int: ...

    def describe(self) -> dict:
        """JSON-safe identity of the vector space this provider builds."""
        return {"class": type(self).__name__}


class SparseEmbeddingProvider(ABC):
    @abstractmethod
    def embed_text(self, text: str) -> dict[int, float]:
        """Embed one text → {token_id: weight}."""

    def embed_batch(self, texts: Sequence[str]) -> list[dict[int, float]]:
        return [self.embed_text(t) for t in texts]

    @abstractmethod
    def get_dimension(self) -> int: ...

    def describe(self) -> dict:
        """JSON-safe identity of the vector space this provider builds."""
        return {"class": type(self).__name__}


class HashedBowDenseProvider(DenseEmbeddingProvider):
    """Deterministic dense embeddings: L2-normalized hashed bag of words."""

    def __init__(self, dim: int = 384):
        self.dim = dim

    def embed_text(self, text: str) -> np.ndarray:
        vec = np.zeros(self.dim, np.float32)
        for tok in _WORD_RE.findall(text.lower()):
            h = int(stable_hash64(tok))
            vec[h % self.dim] += 1.0 if (h >> 32) % 2 else -1.0
        norm = np.linalg.norm(vec)
        return vec / norm if norm > 0 else vec

    def get_dimension(self) -> int:
        return self.dim

    def describe(self) -> dict:
        return {"class": "HashedBowDenseProvider", "dim": self.dim}


class HashedSparseProvider(SparseEmbeddingProvider):
    """Deterministic sparse embeddings: log-scaled hashed term frequencies."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size

    def embed_text(self, text: str) -> dict[int, float]:
        counts: dict[int, int] = {}
        for tok in _WORD_RE.findall(text.lower()):
            slot = (int(stable_hash64(tok)) % (self.vocab_size - 1)) + 1
            counts[slot] = counts.get(slot, 0) + 1
        return {t: float(np.log1p(c)) for t, c in counts.items()}

    def get_dimension(self) -> int:
        return self.vocab_size

    def describe(self) -> dict:
        return {"class": "HashedSparseProvider", "vocab_size": self.vocab_size}


class OpenAIEmbeddingProvider(DenseEmbeddingProvider):
    """Dense embeddings from an OpenAI-compatible /embeddings endpoint.

    Parity: reference `embedding_providers.py:83-114` (`OpenAIProvider`,
    text-embedding-ada-002, 1536-d) — implemented over httpx like the chat
    client, so it also works against vLLM/TEI-style servers.
    """

    _DIMS = {
        "text-embedding-ada-002": 1536,
        "text-embedding-3-small": 1536,
        "text-embedding-3-large": 3072,
    }

    def __init__(
        self,
        model: str = "text-embedding-ada-002",
        api_base: str = "https://api.openai.com/v1",
        api_key: str | None = None,
        dimension: int | None = None,
        batch_size: int = 256,
    ):
        import os

        self.model = model
        self.api_base = api_base.rstrip("/")
        self.api_key = api_key or os.getenv("OPENAI_API_KEY") or "EMPTY"
        self.dimension = dimension or self._DIMS.get(model, 1536)
        self.batch_size = batch_size

    def embed_text(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        import httpx

        out = []
        for start in range(0, len(texts), self.batch_size):
            chunk = list(texts[start : start + self.batch_size])
            resp = httpx.post(
                f"{self.api_base}/embeddings",
                headers={"Authorization": f"Bearer {self.api_key}"},
                json={"model": self.model, "input": chunk},
                timeout=60.0,
            )
            resp.raise_for_status()
            data = sorted(resp.json()["data"], key=lambda d: d["index"])
            out.extend(np.asarray(d["embedding"], np.float32) for d in data)
        return np.stack(out)

    def get_dimension(self) -> int:
        return self.dimension

    def describe(self) -> dict:
        # Never persist the api key.
        return {
            "class": "OpenAIEmbeddingProvider",
            "model": self.model,
            "api_base": self.api_base,
            "dimension": self.dimension,
        }


def provider_from_config(config: dict | None, device=None):
    """Rebuild a provider from its persisted `describe()` identity; neural
    providers are placed on ``device`` (``None`` → ``cuda``).

    :raises ValueError: for an identity this package cannot rebuild — an
        index must load into the vector space that built it, or fail.
    """
    if not config:
        return None
    name = config.get("class")
    if name == "HashedBowDenseProvider":
        return HashedBowDenseProvider(dim=int(config.get("dim", 384)))
    if name == "HashedSparseProvider":
        return HashedSparseProvider(vocab_size=int(config.get("vocab_size", 30522)))
    if name == "OpenAIEmbeddingProvider":
        return OpenAIEmbeddingProvider(
            model=config.get("model", "text-embedding-ada-002"),
            api_base=config.get("api_base", "https://api.openai.com/v1"),
            dimension=config.get("dimension"),
        )
    if name in ("JaxDenseProvider", "JaxSpladeProvider"):
        from verbatim_rag_tpu_torch.models import providers as neural

        return neural.provider_from_config(config, device=device)
    raise ValueError(f"Cannot reconstruct embedding provider from identity {config!r}")
