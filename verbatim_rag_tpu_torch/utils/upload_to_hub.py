"""Stage a trained extractor checkpoint for the HuggingFace Hub (port of
`verbatim_rag_tpu/utils/upload_to_hub.py`, the staging; the push itself
needs the network and is not ported).

The staged directory is loadable by both stacks:

- the native files (``params.npz`` + ``verbatim_config.json``) are copied
  verbatim, so `models.hf_convert.load_span_extractor(staged_dir)` serves the
  checkpoint directly (a directory holding ``verbatim_config.json`` takes the
  native branch of the loaders);
- for ModernBERT-family token heads, the parameter tree is inverted to an HF
  `ModernBertForTokenClassification` state dict
  (`modernbert_params_to_hf_state_dict`) and written as
  ``model.safetensors`` + ``config.json``, so transformers and the HF branch
  of this repo's loaders read it;
- a checkpoint trained with an `HFTokenizer` gets its ``tokenizer.json``.
"""

from __future__ import annotations

import json
import os
import shutil


def jax_checkpoint_to_hf_dir(
    checkpoint_dir: str, out_dir: str, config: dict | None = None
) -> None:
    """Materialize an upload-ready model dir from a trainer checkpoint of
    either package. ``config`` updates (or, for a non-ModernBERT checkpoint,
    is) the written ``config.json``."""
    os.makedirs(out_dir, exist_ok=True)

    # 1. Native files verbatim: the train → save → publish → serve loop must
    #    not depend on the HF inversion below.
    for name in ("params.npz", "verbatim_config.json", "metrics.json"):
        src = os.path.join(checkpoint_dir, name)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(out_dir, name))

    meta_path = os.path.join(checkpoint_dir, "verbatim_config.json")
    meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}

    # 2. HF-format export (ModernBERT token head): HF key names and [out, in]
    #    layout; raw tree-path keys would be loadable by neither stack.
    hf_config: dict | None = None
    state_dict = None
    enc_cfg = meta.get("encoder_config")
    if enc_cfg and meta.get("head") == "token":
        from verbatim_rag_tpu_torch.models.config import EncoderConfig
        from verbatim_rag_tpu_torch.models.hf_convert import (
            hf_config_from_encoder,
            load_params_tree,
            modernbert_params_to_hf_state_dict,
        )

        config_obj = EncoderConfig(**enc_cfg)
        if config_obj.position_embedding_type == "rope":
            params = load_params_tree(checkpoint_dir)
            state_dict = modernbert_params_to_hf_state_dict(params, config_obj)
            hf_config = hf_config_from_encoder(config_obj)

    if hf_config is not None:
        hf_config.update(config or {})
    elif config:
        hf_config = config
    if hf_config:
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(hf_config, f, indent=2)

    if state_dict is not None:
        from safetensors.numpy import save_file

        save_file(state_dict, os.path.join(out_dir, "model.safetensors"))

    # 3. Tokenizer file, when the checkpoint used a real one.
    tok = meta.get("tokenizer") or {}
    tok_path = tok.get("path")
    if tok_path and os.path.exists(tok_path):
        shutil.copy2(tok_path, os.path.join(out_dir, "tokenizer.json"))
