"""Checkpoint loading for the extractors (port of
`verbatim_rag_tpu/models/hf_convert.py`, the native part).

A native checkpoint is the directory `training.Trainer.save_checkpoint`
writes in either package: ``params.npz`` holding the JAX parameter tree
(keys like ``layers/attn/q/kernel``, layers stacked on axis 0, kernels
``[in, out]``) and ``verbatim_config.json`` (head kind, encoder config,
tokenizer). The port reads and writes the same layout, so the two packages
load each other's checkpoints.

HuggingFace-format directories (``config.json`` + ``model.safetensors``)
raise ``NotImplementedError``: their converters come with the
HF-conversion slice of the port.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from .config import EncoderConfig
from .highlighter import ModelSpanExtractor, params_from_jax, params_to_jax
from .tokenizer import HashTokenizer

_HF_NOT_PORTED = (
    "{path}: HuggingFace-format checkpoints are not ported yet (the HF-conversion "
    "slice ports hf_convert's converters); native checkpoints carry verbatim_config.json"
)


def _flatten(tree: dict[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested parameter tree → ``{"a/b/c": array}``, the ``params.npz`` keys."""
    out: dict[str, np.ndarray] = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{name}/"))
        else:
            out[f"{prefix}{name}"] = np.asarray(value)
    return out


def save_params_npz(state: dict[str, torch.Tensor], model_dir: str) -> None:
    """Write a state_dict as ``params.npz`` in the JAX layout (uncompressed:
    ``np.load`` reads it as it reads the JAX package's compressed files)."""
    np.savez(os.path.join(model_dir, "params.npz"), **_flatten(params_to_jax(state)))


def load_params_npz(model_dir: str) -> dict[str, torch.Tensor]:
    """``params.npz`` of a native checkpoint → the port's state_dict."""
    tree: dict[str, Any] = {}
    with np.load(os.path.join(model_dir, "params.npz")) as data:
        for key in data.files:
            node = tree
            *path, leaf = key.split("/")
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return params_from_jax(tree)


def _native_meta(model_dir: str) -> dict | None:
    """Metadata of a native trainer checkpoint, if this is one."""
    path = os.path.join(model_dir, "verbatim_config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_native_checkpoint(model_dir: str, meta: dict):
    """Load a `Trainer.save_checkpoint` directory.

    :return: (state_dict, config, tokenizer), so `ModelSpanExtractor(model_path=...)`
        serves trained checkpoints directly (the train → save → serve loop).
    """
    config = EncoderConfig(**meta["encoder_config"])
    state = load_params_npz(model_dir)
    tok_meta = meta.get("tokenizer") or {}
    if tok_meta.get("class") == "HFTokenizer":
        raise NotImplementedError(
            f"{model_dir}: its HFTokenizer is not ported yet (the HF-conversion slice)"
        )
    tokenizer = HashTokenizer(vocab_size=int(tok_meta.get("vocab_size", config.vocab_size)))
    return state, config, tokenizer


def load_highlighter_checkpoint(model_dir: str):
    """Load a highlighter checkpoint directory: (state_dict, config, tokenizer)."""
    meta = _native_meta(model_dir)
    if meta is None:
        raise NotImplementedError(_HF_NOT_PORTED.format(path=model_dir))
    return load_native_checkpoint(model_dir, meta)


def detect_checkpoint_format(model_dir: str) -> str:
    """'highlighter_v2' (token classifier) vs 'qa_model_v1' (sentence level),
    as a native checkpoint declares its head in verbatim_config.json."""
    meta = _native_meta(model_dir)
    if meta is None:
        raise NotImplementedError(_HF_NOT_PORTED.format(path=model_dir))
    return "qa_model_v1" if meta.get("head") == "sentence" else "highlighter_v2"


def load_span_extractor(model_dir: str, **kwargs):
    """Factory: open a checkpoint dir and build the right extractor class."""
    if detect_checkpoint_format(model_dir) == "highlighter_v2":
        return ModelSpanExtractor(model_path=model_dir, **kwargs)
    raise NotImplementedError(
        f"{model_dir}: sentence-classifier checkpoints are served by "
        "SentenceModelExtractor, which is not ported yet"
    )
