"""The port's package exports against the JAX package's.

For every package of `verbatim_rag_tpu`, the port's ``__all__`` holds each
of JAX's names except those listed in `LEFT_OUT`, each with its reason; the
names only the port exports are listed in `PORT_ONLY`. Every exported name
resolves, and resolves to an object of the port.
"""

from __future__ import annotations

import importlib

import pytest

PACKAGES = ("core", "engine", "ingestion", "models", "ops", "parallel", "rag", "training", "api", "utils")

#: JAX's exports the port leaves out, each with its reason.
LEFT_OUT = {
    "ops": {
        "flash_attention": "the name is the module (its launch counters live there); "
        "the function is ops.flash_attention.flash_attention",
        "flash_attention_tpu": "the TPU's Pallas entry has no CUDA meaning",
    },
    "models": {
        "encoder_forward": "the port's forward is Encoder.forward (an nn.Module)",
    },
}

#: Names only the port exports: the torch modules, the remote provider (JAX
#: keeps it out of its `engine` exports), and the entries of the port's own
#: layout.
PORT_ONLY = {
    "engine": {"JaxDenseProvider", "JaxSpladeProvider", "OpenAIEmbeddingProvider"},
    "models": {
        "CrossEncoderModel", "Encoder", "HighlighterModel", "SpladeModel", "cls_pool",
        "cross_encoder_pooled", "demo_highlighter_config", "encoder_forward_sp", "params_from_jax",
        "params_to_jax", "provider_from_config", "token_relevance_probs_sp",
    },
    "ops": {"flash_attention_partial", "halo_attention"},
    "parallel": {"Mesh", "RowSharded", "ShardedModel", "distributed"},
    "training": {"batch_to_device", "batch_to_mesh", "masked_loss", "token_loss"},
}


def _all(package: str, root: str) -> set[str]:
    module = importlib.import_module(f"{root}.{package}")
    return set(getattr(module, "__all__", ()))


@pytest.mark.parametrize("package", PACKAGES)
def test_port_exports_what_jax_exports(package):
    ours, theirs = _all(package, "verbatim_rag_tpu_torch"), _all(package, "verbatim_rag_tpu")
    left_out = LEFT_OUT.get(package, {})
    assert theirs - ours == set(left_out), f"{package}: missing {sorted(theirs - ours - set(left_out))}"
    assert set(left_out) <= theirs and not (set(left_out) & ours)
    assert ours - theirs == PORT_ONLY.get(package, set())


@pytest.mark.parametrize("package", PACKAGES)
def test_every_port_export_resolves_to_the_port(package):
    module = importlib.import_module(f"verbatim_rag_tpu_torch.{package}")
    for name in getattr(module, "__all__", ()):
        obj = getattr(module, name)
        if getattr(obj, "__module__", None) == "typing":  # a type alias (FilterSpec)
            continue
        origin = getattr(obj, "__module__", None) or getattr(obj, "__name__", "")
        assert origin.startswith("verbatim_rag_tpu_torch"), (package, name, origin)


def test_the_orchestration_exports_come_from_the_port():
    from verbatim_rag_tpu_torch.core import verbatim_enhance
    from verbatim_rag_tpu_torch.engine import OpenAIEmbeddingProvider
    from verbatim_rag_tpu_torch.rag import IndexProvider, VerbatimDOC, VerbatimRAGProvider

    assert verbatim_enhance.__module__ == "verbatim_rag_tpu_torch.core.enhance"
    assert VerbatimDOC.__module__ == "verbatim_rag_tpu_torch.rag.verbatim_doc"
    assert {IndexProvider.__module__, VerbatimRAGProvider.__module__} == {"verbatim_rag_tpu_torch.rag.providers"}
    assert OpenAIEmbeddingProvider.__module__ == "verbatim_rag_tpu_torch.engine.embedding_providers"
    assert all(reason for reasons in LEFT_OUT.values() for reason in reasons.values())
