"""Neural embedding providers for the engine (port of
`verbatim_rag_tpu/models/providers.py`).

The dense provider (encoder → masked mean → L2 norm) and the SPLADE
provider (top-``max_nnz`` terms selected on the device), batched in
length-sorted chunks padded to the full batch. The class names stay
``JaxDenseProvider`` and ``JaxSpladeProvider``: that name, with the rest of
:meth:`describe`, is the identity persisted with an index and read by
:func:`provider_from_config` in both packages, so an index saved by one
package names the same providers in the other.

The models live on ``device`` (``None`` → ``cuda``; without a GPU the
constructor raises unless given ``device="cpu"``). Random weights are the
JAX package's: ``init_*_params(jax.random.PRNGKey(seed))`` reproduced in
numpy by `models.jax_prng`, so a seed-only identity names the same weights
in both packages. Forwards run under ``torch.inference_mode()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from verbatim_rag_tpu_torch.device import resolve_device
from verbatim_rag_tpu_torch.engine.embedding_providers import (
    DenseEmbeddingProvider,
    SparseEmbeddingProvider,
)
from verbatim_rag_tpu_torch.utils import profiling

from .config import EncoderConfig, minilm_config
from .encoder import Encoder, embed_texts
from .splade import SpladeModel, splade_topk_terms
from .tokenizer import HashTokenizer, HFTokenizer, Tokenizer


def _length_sorted_chunks(texts: Sequence[str], batch_size: int):
    """Yield ``(original_indices, chunk_texts)`` in approximate-token-length
    order (whitespace word count), so each chunk pads to its own length
    bucket; callers restore the order from the yielded indices."""
    order = sorted(range(len(texts)), key=lambda i: len(texts[i].split()))
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        yield idx, [texts[i] for i in idx]


def _dispatch_chunks(texts, batch_size, tokenizer, max_length, forward, device):
    """Length-sorted, pad-to-full-batch dispatch of ``forward`` per chunk.

    The shared core of every provider encode path: chunk in length order,
    pad a partial chunk to the full batch with ``""``, tokenize, upload and
    run the forward, without reading anything back. Returns ``(pending,
    idx_groups, perm)``:

    - ``pending``: per-chunk device outputs, in device (length-sorted) order;
    - ``idx_groups``: the caller's indices per chunk, for a host-side order
      restore after one readback;
    - ``perm``: ``perm[original_row] = device_row``, for a device-side order
      restore (one gather).

    While a profiler records, each chunk's tokenization is the span
    ``encode.tokenize`` and its upload and forward ``encode.forward``.
    """
    pending, idx_groups = [], []
    perm = np.empty(len(texts), np.int64)
    for g, (idx, chunk) in enumerate(_length_sorted_chunks(texts, batch_size)):
        idx_groups.append(idx)
        perm[idx] = g * batch_size + np.arange(len(idx), dtype=np.int64)
        if len(chunk) < batch_size:
            chunk += [""] * (batch_size - len(chunk))
        with profiling.span("encode.tokenize"):
            enc = tokenizer.encode_batch(chunk, max_length=max_length)
        with profiling.span("encode.forward"):
            ids = torch.from_numpy(enc.input_ids).to(device)
            mask = torch.from_numpy(enc.attention_mask).to(device)
            with torch.inference_mode():
                pending.append(forward(ids, mask))
    return pending, idx_groups, perm


def _build_model(cls, config, params, checkpoint, seed, device):
    """The provider's model on ``device``: ``params`` (a state_dict) when
    given, else the JAX package's random weights from ``seed``
    (`jax_prng.init_encoder_params` / `init_splade_params`), overwritten by
    a checkpoint's weights when one is named."""
    model = cls(config)
    if params is not None:
        model.load_state_dict(dict(params))
        return model.to(device).eval()
    from .highlighter import params_from_jax
    from .jax_prng import init_encoder_params, init_splade_params, prng_key

    init = init_splade_params if cls is SpladeModel else init_encoder_params
    model.load_state_dict(params_from_jax(init(prng_key(seed), config)))
    if checkpoint:
        _load_params_npz(checkpoint, model)
    return model.to(device).eval()


class JaxDenseProvider(DenseEmbeddingProvider):
    """Dense sentence embeddings: encoder → masked mean-pool → L2 norm."""

    def __init__(
        self,
        params: Mapping[str, torch.Tensor] | None = None,
        config: EncoderConfig | None = None,
        tokenizer: Tokenizer | None = None,
        max_length: int = 512,
        batch_size: int = 64,
        seed: int = 0,
        checkpoint: str | None = None,
        device=None,
    ):
        self.config = config or minilm_config()
        self.device = resolve_device(device)
        self._custom_params = params is not None and checkpoint is None
        self.model = _build_model(Encoder, self.config, params, checkpoint, seed, self.device)
        self.tokenizer = tokenizer or HashTokenizer(vocab_size=self.config.vocab_size)
        self.max_length = max_length
        self.batch_size = batch_size
        self.seed = seed
        self.checkpoint = checkpoint

    def embed_text(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        """[n, hidden] float32 in caller order: every chunk's forward is
        dispatched first, then the chunks are joined on the device and read
        back once."""
        if not texts:
            return np.zeros((0, self.get_dimension()), np.float32)
        pending, idx_groups, _ = _dispatch_chunks(
            texts, self.batch_size, self.tokenizer, self.max_length, self._forward, self.device
        )
        full = torch.cat(pending, dim=0).cpu().numpy()  # one readback
        out = np.empty((len(texts), full.shape[1]), full.dtype)
        for i, idx in enumerate(idx_groups):
            out[idx] = full[i * self.batch_size : i * self.batch_size + len(idx)]
        return out

    def embed_batch_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Like :meth:`embed_batch`, but the embeddings stay on the device
        ([n, hidden] float32): the query path hands them straight to
        `DeviceVectorStore.query_batch`. Caller order is restored on the
        device with one gather."""
        if not texts:
            return torch.zeros((0, self.get_dimension()), dtype=torch.float32, device=self.device)
        pending, _, perm = _dispatch_chunks(
            texts, self.batch_size, self.tokenizer, self.max_length, self._forward, self.device
        )
        full = torch.cat(pending, dim=0)
        return full.index_select(0, torch.from_numpy(perm).to(self.device))

    def _forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        return embed_texts(self.model, input_ids, attention_mask)

    def get_dimension(self) -> int:
        return self.config.hidden_size

    def describe(self) -> dict:
        return _describe_jax_provider(self, "JaxDenseProvider")


class JaxSpladeProvider(SparseEmbeddingProvider):
    """SPLADE sparse embeddings with on-device top-k term selection."""

    def __init__(
        self,
        params: Mapping[str, torch.Tensor] | None = None,
        config: EncoderConfig | None = None,
        tokenizer: Tokenizer | None = None,
        max_length: int = 512,
        batch_size: int = 32,
        max_nnz: int = 128,
        seed: int = 0,
        checkpoint: str | None = None,
        device=None,
    ):
        self.config = config or minilm_config()
        self.device = resolve_device(device)
        self._custom_params = params is not None and checkpoint is None
        self.model = _build_model(SpladeModel, self.config, params, checkpoint, seed, self.device)
        self.tokenizer = tokenizer or HashTokenizer(vocab_size=self.config.vocab_size)
        self.max_length = max_length
        self.batch_size = batch_size
        self.max_nnz = max_nnz
        self.seed = seed
        self.checkpoint = checkpoint

    def embed_text(self, text: str) -> dict[int, float]:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str]) -> list[dict[int, float]]:
        ids_np, w_np = self.embed_batch_arrays(texts)
        return [
            {int(t): float(w) for t, w in zip(ids_np[i], w_np[i]) if w > 0.0}
            for i in range(len(texts))
        ]

    def embed_batch_arrays(self, texts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """Array form of :meth:`embed_batch`: ``(ids int32 [n, max_nnz],
        weights float32 [n, max_nnz])`` in caller order, zero-weight slots
        id 0. The ingest fast path: the store takes these rows as they are
        (no per-chunk dicts)."""
        if not texts:
            z = np.zeros((0, self.max_nnz))
            return z.astype(np.int32), z.astype(np.float32)
        pending, _, perm = _dispatch_chunks(
            texts, self.batch_size, self.tokenizer, self.max_length, self._forward, self.device
        )
        ids_np = torch.cat([p[0] for p in pending], dim=0).cpu().numpy()
        w_np = torch.cat([p[1] for p in pending], dim=0).cpu().numpy()
        ids_np, w_np = ids_np[perm], w_np[perm].astype(np.float32)
        live = w_np > 0.0
        return np.where(live, ids_np, 0).astype(np.int32), np.where(live, w_np, 0.0).astype(np.float32)

    def embed_query_arrays_device(self, texts: Sequence[str]) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-resident query encode: ``(ids int32 [B, max_nnz], weights
        float32 [B, max_nnz])`` on the device in caller order, pad slots id 0
        and weight 0; the store takes them into its hybrid search with no
        host round trip."""
        if not texts:
            z = torch.zeros((0, self.max_nnz), device=self.device)
            return z.to(torch.int32), z.float()
        pending, _, perm = _dispatch_chunks(
            texts, self.batch_size, self.tokenizer, self.max_length, self._forward, self.device
        )
        p = torch.from_numpy(perm).to(self.device)
        ids = torch.cat([x[0] for x in pending], dim=0).index_select(0, p)
        w = torch.cat([x[1] for x in pending], dim=0).index_select(0, p)
        live = w > 0.0
        return torch.where(live, ids, 0).to(torch.int32), torch.where(live, w, 0.0).float()

    def _forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        return splade_topk_terms(self.model, input_ids, attention_mask, max_nnz=self.max_nnz)

    def get_dimension(self) -> int:
        return self.config.vocab_size

    def describe(self) -> dict:
        ident = _describe_jax_provider(self, "JaxSpladeProvider")
        ident["max_nnz"] = self.max_nnz
        return ident


def _describe_jax_provider(provider, class_name: str) -> dict:
    """Persisted identity of a neural provider: an index must be reloadable
    into the same vector space, or fail loudly."""
    return {
        "class": class_name,
        "config": dataclasses.asdict(provider.config),
        "seed": provider.seed,
        "checkpoint": provider.checkpoint,
        "max_length": provider.max_length,
        "batch_size": provider.batch_size,
        # With ad-hoc params and no checkpoint path the exact weights are
        # unrecoverable: reconstruction must refuse rather than guess.
        "reconstructible": not provider._custom_params,
        "tokenizer": provider.tokenizer.describe()
        if hasattr(provider.tokenizer, "describe")
        else {"class": type(provider.tokenizer).__name__},
    }


def _load_params_npz(checkpoint: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a trainer-format ``<dir>/params.npz`` checkpoint (of either
    package) into the provider's model in place."""
    from verbatim_rag_tpu_torch.training.trainer import Trainer

    return Trainer.load_checkpoint(checkpoint, model)


def provider_from_config(config: dict, device=None) -> Any:
    """Reconstruct a neural provider from its `describe()` identity, on
    ``device`` (``None`` → ``cuda``)."""
    if not config.get("reconstructible", True):
        raise ValueError(
            f"{config.get('class')} was built with ad-hoc parameters and no "
            "checkpoint path; its weights cannot be reconstructed. Re-save "
            "the index with a checkpoint-backed provider."
        )
    enc = EncoderConfig(**config["config"]) if config.get("config") else None
    tok_cfg = config.get("tokenizer") or {}
    tokenizer = None
    if tok_cfg.get("class") == "HashTokenizer":
        tokenizer = HashTokenizer(vocab_size=int(tok_cfg.get("vocab_size", 30522)))
    elif tok_cfg.get("class") == "HFTokenizer":
        path = tok_cfg.get("path")
        if not path:
            raise ValueError("HFTokenizer identity has no path; cannot reconstruct")
        tokenizer = HFTokenizer(path)
    common = dict(
        config=enc,
        tokenizer=tokenizer,
        max_length=int(config.get("max_length", 512)),
        seed=int(config.get("seed", 0)),
        checkpoint=config.get("checkpoint"),
        device=device,
    )
    name = config.get("class")
    if name == "JaxDenseProvider":
        return JaxDenseProvider(batch_size=int(config.get("batch_size", 64)), **common)
    if name == "JaxSpladeProvider":
        return JaxSpladeProvider(
            batch_size=int(config.get("batch_size", 32)),
            max_nnz=int(config.get("max_nnz", 128)),
            **common,
        )
    raise ValueError(f"Unknown JAX provider class {name!r}")
