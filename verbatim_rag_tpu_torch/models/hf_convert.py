"""Checkpoints in and out for the extractors (port of
`verbatim_rag_tpu/models/hf_convert.py`).

Two directory formats load:

- a native checkpoint, the directory `training.Trainer.save_checkpoint`
  writes in either package: ``params.npz`` holding the JAX parameter tree
  (keys like ``layers/attn/q/kernel``, layers stacked on axis 0, kernels
  ``[in, out]``) and ``verbatim_config.json`` (head kind, encoder config,
  tokenizer);
- a HuggingFace directory: ``config.json``, ``model.safetensors`` (or
  ``pytorch_model.bin``) and ``tokenizer.json``, as a published BERT or
  ModernBERT token classifier ships. torch Linear weights are ``[out, in]``
  and transpose to ``[in, out]`` kernels; ModernBERT's fused ``Wqkv`` splits
  into q/k/v.

The converters are numpy copies of the JAX package's and return its
parameter tree; the loaders carry that tree into the port's modules through
`models.highlighter.params_from_jax`, so :func:`load_highlighter_checkpoint`
returns ``(state_dict, config, tokenizer)``. `modernbert_params_to_hf_state_dict`
and `hf_config_from_encoder` go the other way, for `utils.upload_to_hub`.
``safetensors`` and ``tokenizers`` are imported where a file is read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from .config import EncoderConfig, modernbert_base_config
from .highlighter import params_from_jax, params_to_jax
from .tokenizer import HashTokenizer

Params = dict[str, Any]


def _t(x) -> np.ndarray:
    """torch tensor / ndarray → float32 ndarray."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _linear(sd: Mapping[str, Any], prefix: str, use_bias: bool = True) -> Params:
    p = {"kernel": _t(sd[f"{prefix}.weight"]).T}
    if use_bias and f"{prefix}.bias" in sd:
        p["bias"] = _t(sd[f"{prefix}.bias"])
    return p


def _norm(sd: Mapping[str, Any], prefix: str) -> Params:
    p = {"scale": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = _t(sd[f"{prefix}.bias"])
    return p


def _stack_layers(layers: list[Params]) -> Params:
    """Per-layer trees → one tree with every leaf stacked on axis 0."""
    first = layers[0]
    return {
        name: _stack_layers([layer[name] for layer in layers])
        if isinstance(first[name], dict)
        else np.stack([layer[name] for layer in layers])
        for name in first
    }


# -- BERT family ---------------------------------------------------------------------


def convert_bert_state_dict(
    sd: Mapping[str, Any], config: EncoderConfig, prefix: str = ""
) -> Params:
    """Map a `BertModel` state dict onto the encoder tree."""

    def key(name: str) -> str:
        return f"{prefix}{name}"

    embeddings: Params = {
        "word": _t(sd[key("embeddings.word_embeddings.weight")]),
        "position": _t(sd[key("embeddings.position_embeddings.weight")]),
        "ln": _norm(sd, key("embeddings.LayerNorm")),
    }
    tt_key = key("embeddings.token_type_embeddings.weight")
    if tt_key in sd:
        embeddings["token_type"] = _t(sd[tt_key])

    layers = []
    for i in range(config.num_layers):
        base = key(f"encoder.layer.{i}")
        layers.append(
            {
                "attn": {
                    "q": _linear(sd, f"{base}.attention.self.query"),
                    "k": _linear(sd, f"{base}.attention.self.key"),
                    "v": _linear(sd, f"{base}.attention.self.value"),
                    "o": _linear(sd, f"{base}.attention.output.dense"),
                },
                "attn_ln": _norm(sd, f"{base}.attention.output.LayerNorm"),
                "mlp": {
                    "wi": _linear(sd, f"{base}.intermediate.dense"),
                    "wo": _linear(sd, f"{base}.output.dense"),
                },
                "mlp_ln": _norm(sd, f"{base}.output.LayerNorm"),
            }
        )
    return {"embeddings": embeddings, "layers": _stack_layers(layers)}


def convert_bert_mlm_head(sd: Mapping[str, Any], params: Params) -> Params:
    """Attach a `BertForMaskedLM` cls head (for SPLADE)."""
    params["mlm_head"] = {
        "transform": _linear(sd, "cls.predictions.transform.dense"),
        "ln": _norm(sd, "cls.predictions.transform.LayerNorm"),
        "output_bias": _t(sd["cls.predictions.bias"]),
    }
    return params


# -- ModernBERT family ------------------------------------------------------------------


def convert_modernbert_state_dict(
    sd: Mapping[str, Any], config: EncoderConfig, prefix: str = ""
) -> Params:
    """Map a `ModernBertModel` state dict onto the encoder tree."""

    def key(name: str) -> str:
        return f"{prefix}{name}"

    h = config.hidden_size
    embeddings: Params = {
        "word": _t(sd[key("embeddings.tok_embeddings.weight")]),
        "ln": _norm(sd, key("embeddings.norm")),
    }

    layers = []
    for i in range(config.num_layers):
        base = key(f"layers.{i}")
        wqkv = _t(sd[f"{base}.attn.Wqkv.weight"]).T  # [h, 3h]
        q_k, k_k, v_k = wqkv[:, :h], wqkv[:, h : 2 * h], wqkv[:, 2 * h :]
        attn = {
            "q": {"kernel": q_k},
            "k": {"kernel": k_k},
            "v": {"kernel": v_k},
            "o": _linear(sd, f"{base}.attn.Wo", use_bias=config.use_bias),
        }
        if f"{base}.attn.Wqkv.bias" in sd:
            bqkv = _t(sd[f"{base}.attn.Wqkv.bias"])
            attn["q"]["bias"], attn["k"]["bias"], attn["v"]["bias"] = (
                bqkv[:h],
                bqkv[h : 2 * h],
                bqkv[2 * h :],
            )
        # Layer 0's attn_norm is Identity in ModernBERT: a unit LN keeps the
        # stacked tree rectangular; the forward skips it
        # (`first_layer_no_attn_norm`).
        if f"{base}.attn_norm.weight" in sd:
            attn_ln = _norm(sd, f"{base}.attn_norm")
        else:
            attn_ln = {"scale": np.ones(h, np.float32)}
        layers.append(
            {
                "attn": attn,
                "attn_ln": attn_ln,
                "mlp": {
                    "wi": _linear(sd, f"{base}.mlp.Wi", use_bias=config.use_bias),
                    "wo": _linear(sd, f"{base}.mlp.Wo", use_bias=config.use_bias),
                },
                "mlp_ln": _norm(sd, f"{base}.mlp_norm"),
            }
        )

    return {
        "embeddings": embeddings,
        "layers": _stack_layers(layers),
        "final_ln": _norm(sd, key("final_norm")),
    }


def modernbert_params_to_hf_state_dict(
    params: Params, config: EncoderConfig
) -> dict[str, np.ndarray]:
    """Inverse of `convert_modernbert_state_dict` (+ head/classifier): the
    parameter tree → an HF `ModernBertForTokenClassification` state dict,
    with HF key names and ``[out, in]`` kernels."""
    sd: dict[str, np.ndarray] = {}

    def put(name: str, arr) -> None:
        # ascontiguousarray, not asarray: most kernels here are .T views, and
        # safetensors.numpy.save_file serializes a non-contiguous array's
        # BASE buffer bytes, a transposed corruption of the real tensor.
        sd[name] = np.ascontiguousarray(np.asarray(arr, np.float32))

    def put_norm(prefix: str, norm: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", norm["scale"])
        if "bias" in norm:
            put(f"{prefix}.bias", norm["bias"])

    emb = params["embeddings"]
    put("model.embeddings.tok_embeddings.weight", emb["word"])
    put_norm("model.embeddings.norm", emb["ln"])

    layers = params["layers"]
    for i in range(config.num_layers):
        base = f"model.layers.{i}"
        attn = layers["attn"]
        qkv = np.concatenate(
            [np.asarray(attn[n]["kernel"][i], np.float32) for n in ("q", "k", "v")],
            axis=1,
        )  # [h, 3h]
        put(f"{base}.attn.Wqkv.weight", qkv.T)
        if "bias" in attn["q"]:
            put(
                f"{base}.attn.Wqkv.bias",
                np.concatenate(
                    [np.asarray(attn[n]["bias"][i], np.float32) for n in ("q", "k", "v")]
                ),
            )
        put(f"{base}.attn.Wo.weight", np.asarray(attn["o"]["kernel"][i], np.float32).T)
        if "bias" in attn["o"]:
            put(f"{base}.attn.Wo.bias", attn["o"]["bias"][i])
        if not (config.first_layer_no_attn_norm and i == 0):
            # Layer 0's attn_norm is Identity: HF checkpoints omit the key.
            put_norm(f"{base}.attn_norm", {k: v[i] for k, v in layers["attn_ln"].items()})
        put(f"{base}.mlp.Wi.weight", np.asarray(layers["mlp"]["wi"]["kernel"][i], np.float32).T)
        if "bias" in layers["mlp"]["wi"]:
            put(f"{base}.mlp.Wi.bias", layers["mlp"]["wi"]["bias"][i])
        put(f"{base}.mlp.Wo.weight", np.asarray(layers["mlp"]["wo"]["kernel"][i], np.float32).T)
        if "bias" in layers["mlp"]["wo"]:
            put(f"{base}.mlp.Wo.bias", layers["mlp"]["wo"]["bias"][i])
        put_norm(f"{base}.mlp_norm", {k: v[i] for k, v in layers["mlp_ln"].items()})

    put_norm("model.final_norm", params["final_ln"])

    head = params.get("cls_head")
    if head is not None:
        put("head.dense.weight", np.asarray(head["dense"]["kernel"], np.float32).T)
        if "bias" in head["dense"]:
            put("head.dense.bias", head["dense"]["bias"])
        put_norm("head.norm", head["norm"])
    classifier = params.get("classifier")
    if classifier is not None:
        put("classifier.weight", np.asarray(classifier["kernel"], np.float32).T)
        if "bias" in classifier:
            put("classifier.bias", classifier["bias"])
    return sd


def hf_config_from_encoder(config: EncoderConfig, num_labels: int = 2) -> dict:
    """Inverse of `config_from_hf` for the ModernBERT family: the config.json
    of a published token-classification checkpoint."""
    return {
        "model_type": "modernbert",
        "architectures": ["ModernBertForTokenClassification"],
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "intermediate_size": config.intermediate_size,
        "max_position_embeddings": config.max_position_embeddings,
        "norm_eps": config.layer_norm_eps,
        "global_rope_theta": config.global_rope_theta,
        "local_rope_theta": config.local_rope_theta,
        "local_attention": config.local_attention_window,
        "global_attn_every_n_layers": config.global_attn_every_n_layers,
        "num_labels": num_labels,
    }


def config_from_hf(hf_config: Mapping[str, Any]) -> EncoderConfig:
    """Build an EncoderConfig from an HF config dict (BERT or ModernBERT)."""
    model_type = hf_config.get("model_type", "bert")
    if model_type == "modernbert":
        return modernbert_base_config(
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["hidden_size"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            intermediate_size=hf_config["intermediate_size"],
            max_position_embeddings=hf_config.get("max_position_embeddings", 8192),
            layer_norm_eps=hf_config.get("norm_eps", 1e-5),
            global_rope_theta=hf_config.get("global_rope_theta", 160_000.0),
            local_rope_theta=hf_config.get("local_rope_theta", 10_000.0),
            local_attention_window=hf_config.get("local_attention", 128),
            global_attn_every_n_layers=hf_config.get("global_attn_every_n_layers", 3),
        )
    return EncoderConfig(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        intermediate_size=hf_config["intermediate_size"],
        max_position_embeddings=hf_config.get("max_position_embeddings", 512),
        type_vocab_size=hf_config.get("type_vocab_size", 2),
        layer_norm_eps=hf_config.get("layer_norm_eps", 1e-12),
    )


# -- native checkpoints -------------------------------------------------------------------


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


def load_params_tree(model_dir: str) -> Params:
    """``params.npz`` of a native checkpoint → the JAX parameter tree (numpy)."""
    tree: Params = {}
    with np.load(os.path.join(model_dir, "params.npz")) as data:
        for key in data.files:
            node = tree
            *path, leaf = key.split("/")
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return tree


def load_params_npz(model_dir: str) -> dict[str, torch.Tensor]:
    """``params.npz`` of a native checkpoint → the port's state_dict."""
    return params_from_jax(load_params_tree(model_dir))


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
    if tok_meta.get("class") == "HFTokenizer" and tok_meta.get("path"):
        from .tokenizer import HFTokenizer

        tokenizer = HFTokenizer(tok_meta["path"])
    else:
        tokenizer = HashTokenizer(vocab_size=int(tok_meta.get("vocab_size", config.vocab_size)))
    return state, config, tokenizer


# -- HuggingFace checkpoints ---------------------------------------------------------------


def _state_dict_keys(model_dir: str) -> set[str]:
    """Key names only: the safetensors header carries them without decoding
    any tensor data."""
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        from safetensors import safe_open

        with safe_open(st_path, framework="numpy") as f:
            return set(f.keys())
    return set(_read_state_dict(model_dir))


def _read_state_dict(model_dir: str) -> dict[str, np.ndarray]:
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        from safetensors.numpy import load_file

        return {k: np.asarray(v, np.float32) for k, v in load_file(st_path).items()}
    if os.path.exists(bin_path):
        return {k: _t(v) for k, v in torch.load(bin_path, map_location="cpu").items()}
    raise FileNotFoundError(f"No weights found in {model_dir}")


def load_hf_params(model_dir: str) -> tuple[Params, EncoderConfig]:
    """The weights of an HF directory (``config.json`` + ``model.safetensors``
    or ``pytorch_model.bin``) as the JAX parameter tree, with its config: the
    backbone, the ModernBERT prediction head (``cls_head``) and the token
    ``classifier``. A sentence checkpoint's ``sentence_classifier`` is not
    read, as in the JAX package."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_config = json.load(f)
    config = config_from_hf(hf_config)
    sd = _read_state_dict(model_dir)

    # Strip common wrappers.
    prefix = ""
    if any(k.startswith("model.") for k in sd):
        prefix = "model."
    elif any(k.startswith("bert.") for k in sd):
        prefix = "bert."

    if hf_config.get("model_type") == "modernbert":
        params = convert_modernbert_state_dict(sd, config, prefix=prefix)
    else:
        params = convert_bert_state_dict(sd, config, prefix=prefix)

    if "head.dense.weight" in sd and "head.norm.weight" in sd:
        # `ModernBertForTokenClassification` puts a prediction head (dense →
        # GELU → LayerNorm) between the backbone and the classifier.
        params["cls_head"] = {
            "dense": _linear(sd, "head.dense", use_bias="head.dense.bias" in sd),
            "norm": _norm(sd, "head.norm"),
        }
    cls_key = next(
        (k for k in ("classifier.weight", "token_classifier.weight") if k in sd), None
    )
    if cls_key:
        params["classifier"] = {
            "kernel": _t(sd[cls_key]).T,
            "bias": _t(sd[cls_key.replace("weight", "bias")])
            if cls_key.replace("weight", "bias") in sd
            else np.zeros(_t(sd[cls_key]).shape[0], np.float32),
        }
    return params, config


def load_highlighter_checkpoint(model_dir: str):
    """Load a highlighter checkpoint directory, native or HuggingFace.

    :return: (state_dict, config, tokenizer); an HF directory's tokenizer is
        its ``tokenizer.json``.
    """
    meta = _native_meta(model_dir)
    if meta is not None:
        return load_native_checkpoint(model_dir, meta)
    from .tokenizer import HFTokenizer

    params, config = load_hf_params(model_dir)
    tokenizer = HFTokenizer(os.path.join(model_dir, "tokenizer.json"))
    return params_from_jax(params), config, tokenizer


def detect_checkpoint_format(model_dir: str) -> str:
    """'highlighter_v2' (token classifier) vs 'qa_model_v1' (sentence level).

    A native checkpoint declares its head in verbatim_config.json; an HF one
    is v2 when its ``auto_map`` names a Highlighter or its architecture is a
    token classifier, v1 when its weights hold a sentence-classifier head.
    """
    meta = _native_meta(model_dir)
    if meta is not None:
        return "qa_model_v1" if meta.get("head") == "sentence" else "highlighter_v2"
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_config = json.load(f)
    auto_map = hf_config.get("auto_map") or {}
    if any("Highlighter" in str(v) for v in auto_map.values()):
        return "highlighter_v2"
    if hf_config.get("architectures") and any(
        "TokenClassification" in a for a in hf_config["architectures"]
    ):
        return "highlighter_v2"
    sd_keys = _state_dict_keys(model_dir)
    if "sentence_classifier.weight" in sd_keys or "qa_outputs.weight" in sd_keys:
        return "qa_model_v1"
    return "highlighter_v2"


def load_span_extractor(model_dir: str, **kwargs):
    """Factory: open a checkpoint dir and build the right extractor class."""
    if detect_checkpoint_format(model_dir) == "highlighter_v2":
        from .highlighter import ModelSpanExtractor

        return ModelSpanExtractor(model_path=model_dir, **kwargs)
    from .sentence_extractor import SentenceModelExtractor

    params, config, tokenizer = load_highlighter_checkpoint(model_dir)
    return SentenceModelExtractor(params=params, config=config, tokenizer=tokenizer, **kwargs)
