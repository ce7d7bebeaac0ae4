"""Lazy process-wide singletons for the API service (port of
`verbatim_rag_tpu/api/dependencies.py`).

The LLM client, index, RAG, template manager and micro-batcher are built
once on first use; `check_system_ready` guards them. The index, the RAG's
default extractor and the transform's offline extractor live on the
server's device (:func:`get_device`): ``VERBATIM_FORCE_PLATFORM=cpu`` means
the CPU, unset or ``cuda`` the card (which raises without a GPU); any other
value raises. An injected RAG (:func:`set_rag`) brings its index's device.
"""

from __future__ import annotations

import logging
import os
import threading

from verbatim_rag_tpu_torch.device import resolve_device

from .config import APIConfig

PLATFORM_ENV = "VERBATIM_FORCE_PLATFORM"

logger = logging.getLogger(__name__)

# Reentrant: get_rag() composes the other getters while holding the lock.
_lock = threading.RLock()
_state: dict = {}


def get_config() -> APIConfig:
    with _lock:
        if "config" not in _state:
            _state["config"] = APIConfig.from_env()
        return _state["config"]


def device_from_env():
    """The device ``VERBATIM_FORCE_PLATFORM`` names: ``cpu``, or ``cuda``
    when unset."""
    platform = os.environ.get(PLATFORM_ENV, "").strip().lower() or "cuda"
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"{PLATFORM_ENV}={platform!r}: expected 'cpu' or 'cuda'")
    return resolve_device(platform)


def get_device():
    with _lock:
        if "device" not in _state:
            _state["device"] = device_from_env()
        return _state["device"]


def get_llm_client():
    config = get_config()
    if not config.llm_model:
        return None
    with _lock:
        if "llm" not in _state:
            from verbatim_rag_tpu_torch.core.llm_client import LLMClient

            _state["llm"] = LLMClient(model=config.llm_model, api_base=config.llm_api_base)
        return _state["llm"]


def get_index():
    config = get_config()
    with _lock:
        if "index" not in _state:
            from verbatim_rag_tpu_torch.engine.embedding_providers import HashedBowDenseProvider
            from verbatim_rag_tpu_torch.engine.index import VerbatimIndex

            path = config.index_path
            if path and os.path.exists(path + ".json"):
                # Reconstruct the providers that built the index from the
                # persisted identity — never guess the vector space.
                index = VerbatimIndex.load(path, device=get_device())
            else:
                index = VerbatimIndex(dense_provider=HashedBowDenseProvider(), device=get_device())
            _state["index"] = index
        return _state["index"]


def get_template_manager():
    with _lock:
        if "templates" not in _state:
            from verbatim_rag_tpu_torch.core.templates import TemplateManager

            config = get_config()
            tm = TemplateManager(llm_client=get_llm_client(), default_mode="static")
            if config.templates_path and os.path.exists(config.templates_path):
                tm.load(config.templates_path)
            _state["templates"] = tm
        return _state["templates"]


def get_rag():
    with _lock:
        if "rag" not in _state:
            from verbatim_rag_tpu_torch.rag.core import VerbatimRAG

            _state["rag"] = VerbatimRAG(
                get_index(),
                llm_client=get_llm_client(),
                template_manager=get_template_manager(),
            )
        return _state["rag"]


def get_batcher():
    """Micro-batcher over `VerbatimRAG.query_batch` (None when disabled)."""
    config = get_config()
    if not config.micro_batch:
        return None
    with _lock:
        if "batcher" not in _state:
            from .batching import MicroBatcher

            rag = get_rag()

            def run_batch(questions, params):
                return rag.query_batch(
                    questions,
                    k=params.get("k"),
                    filter=params.get("filter"),
                    hybrid_weights=params.get("hybrid_weights"),
                    rrf_k=params.get("rrf_k", 60),
                    search_params=params.get("search_params"),
                    search_type=params.get("search_type"),
                    template_mode=params.get("template_mode"),
                )

            _state["batcher"] = MicroBatcher(
                run_batch,
                max_batch=config.micro_batch_max,
                max_wait_ms=config.micro_batch_wait_ms,
            )
        return _state["batcher"]


def set_rag(rag) -> None:
    """Inject a prebuilt RAG (tests / embedding the API in another app)."""
    with _lock:
        _state["rag"] = rag
        _state["index"] = rag.index
        _state["device"] = rag.index.device
        _state["templates"] = rag.template_manager
        # A cached batcher's run_batch closes over the OLD rag — rebuild.
        _state.pop("batcher", None)


def reset() -> None:
    with _lock:
        _state.clear()


def check_system_ready() -> tuple[bool, str]:
    try:
        rag = get_rag()
    except Exception as exc:
        return False, f"initialization failed: {exc}"
    if rag.index.inspect()["num_chunks"] == 0:
        return True, "ready (empty index)"
    return True, "ready"
