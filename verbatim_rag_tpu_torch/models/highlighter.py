"""Neural span extraction: query-conditioned token classification (port of
`verbatim_rag_tpu/models/highlighter.py`).

A token-classification head on the encoder scores every context token for
relevance to the question; char spans are cut where the token probability
crosses a threshold, merged across small gaps, and length-filtered. Long
contexts use sliding windows with stride overlap; overlapping probabilities
are max-aggregated. Windows of every document are padded into one array
(row counts bucketed to powers of two, bursts scored in slices of at most
512 rows and `SLICE_TOKENS` tokens); on one device each slice's forward
runs on its live tokens alone (:func:`token_relevance_probs_packed`).

The host-side planning, batching and decode are the JAX package's, unchanged;
:meth:`ModelSpanExtractor._forward_probs` is the one model seam. With
``sp_mesh`` every context is one window, scored in a single
sequence-sharded pass over the mesh (:func:`token_relevance_probs_sp`).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from verbatim_rag_tpu_torch.core.extractors import SpanExtractor
from verbatim_rag_tpu_torch.device import resolve_device
from verbatim_rag_tpu_torch.ops.ring_attention import shard_sequence
from verbatim_rag_tpu_torch.parallel import exchange
from verbatim_rag_tpu_torch.utils import profiling

from .config import EncoderConfig, demo_highlighter_config

#: Most tokens (rows × padded length) one forward of a burst takes. The JAX
#: package slices bursts by 512 rows alone; with windows of 4096 tokens such
#: a slice is 2.1M tokens, and ModernBERT-base's float32 MLP product for it
#: alone takes 18 GiB, more than an 80 GB card had left in a served burst.
#: The packed forward holds live tokens alone in its token-wise tensors, but
#: its attention views still take rows × length slots. Each row's
#: probabilities depend on that row only, so the slicing changes no result.
SLICE_TOKENS = 512 * 2048
from .encoder import (
    Dense,
    Encoder,
    LayerNorm,
    PackedRows,
    compute_dtype,
    dense,
    encoder_forward_packed,
    encoder_forward_sp,
    layer_norm,
    pack_rows,
    shard_replicas,
)
from .tokenizer import HashTokenizer, Tokenizer, bucket_length


class HighlighterModel(Encoder):
    """Encoder + 2-label token classifier, with the optional ModernBERT
    prediction head (dense → GELU → LayerNorm) before it."""

    def __init__(
        self,
        config: EncoderConfig,
        generator: torch.Generator | None = None,
        cls_head_biases: tuple[bool, bool] | None = None,
    ):
        """``cls_head_biases``: ``None`` for no prediction head, else whether
        its dense layer and its LayerNorm carry biases."""
        super().__init__(config, generator)
        h = config.hidden_size
        self.classifier = Dense(h, 2, True, generator)
        self.cls_head = None
        if cls_head_biases is not None:
            dense_bias, norm_bias = cls_head_biases
            self.cls_head = nn.ModuleDict(
                {"dense": Dense(h, h, dense_bias, generator), "norm": LayerNorm(h, norm_bias)}
            )

    def classifier_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return classifier_logits(dict(self.named_parameters()), self.config, hidden)


def classifier_logits(p, config: EncoderConfig, hidden: torch.Tensor) -> torch.Tensor:
    """The token head over a parameter mapping: the optional prediction head
    (dense → GELU → LayerNorm), then the classifier — [B, S, 2] float32."""
    dtype = compute_dtype(config)
    if "cls_head.dense.kernel" in p:
        hidden = dense(hidden, p["cls_head.dense.kernel"], p.get("cls_head.dense.bias"), dtype)
        hidden = F.gelu(hidden.float(), approximate="none")
        hidden = layer_norm(hidden, p["cls_head.norm.scale"], p.get("cls_head.norm.bias"), config.layer_norm_eps)
    return dense(hidden, p["classifier.kernel"], p.get("classifier.bias"), dtype)


def init_highlighter_params(
    config: EncoderConfig, seed: int = 0, device=None
) -> HighlighterModel:
    """Random-init the highlighter from an explicit ``torch.Generator`` seed
    (normal·0.02 kernels and embeddings, zero biases, unit LayerNorms)."""
    generator = torch.Generator().manual_seed(seed)
    return HighlighterModel(config, generator).to(resolve_device(device))


def token_relevance_probs(model: HighlighterModel, input_ids, attention_mask) -> torch.Tensor:
    """P(token is part of an answer span) per token — [B, S] float32."""
    hidden = model(input_ids, attention_mask)
    logits = model.classifier_logits(hidden)
    probs = torch.softmax(logits.float(), dim=-1)[..., 1]
    return probs * attention_mask.float()


def token_relevance_probs_packed(model: HighlighterModel, input_ids: np.ndarray, rows: PackedRows) -> torch.Tensor:
    """:func:`token_relevance_probs` over the live tokens alone — [T]
    float32; the arguments are `models.encoder.encoder_forward_packed`'s."""
    p = dict(model.named_parameters())
    hidden = encoder_forward_packed(p, model.config, input_ids, rows)
    return torch.softmax(classifier_logits(p, model.config, hidden).float(), dim=-1)[..., 1]


def token_relevance_probs_sp(
    model: HighlighterModel, ids_shards, mask_shards, mesh, axis: str = "tp"
) -> list[torch.Tensor]:
    """Sequence-parallel token scoring, the single-pass long-context path (no
    sliding windows): lists of [B, S/n] id and mask shards → the list of
    [B, S/n] float32 probability shards (`models.encoder.encoder_forward_sp`:
    ring attention for global layers, halo exchange for local layers)."""
    params = shard_replicas(model, [ids.device for ids in ids_shards])
    hidden = encoder_forward_sp(model, ids_shards, mask_shards, mesh, axis, params)
    out = []
    for p, x, mask in zip(params, hidden, mask_shards):
        probs = torch.softmax(classifier_logits(p, model.config, x).float(), dim=-1)[..., 1]
        out.append(probs * mask.float())
    return out


def params_from_jax(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX encoder, highlighter, sentence-classifier or SPLADE parameter
    tree (numpy leaves) → the port's state_dict.

    JAX stacks layers on a leading axis (``params["layers"]`` leaves are
    ``[L, ...]``); kernels are ``[in, out]`` on both sides; ``cls_head``,
    ``classifier``, ``sentence_classifier``, SPLADE's ``mlm_head``
    (`models.splade.SpladeModel`) and the cross-encoder's ``pooler`` and
    ``score`` (`models.reranker.CrossEncoderModel`) are optional.
    """
    out: dict[str, torch.Tensor] = {}

    def put(key, value):
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    for name, value in params_np["embeddings"].items():
        if name == "ln":
            for leaf, arr in value.items():
                put(f"embeddings_ln.{leaf}", arr)
        else:
            put(f"embeddings.{name}", value)

    def walk(prefix, tree, index):
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(f"{prefix}{name}.", value, index)
            else:
                put(f"{prefix}{name}", np.asarray(value)[index])

    n_layers = int(np.asarray(params_np["layers"]["attn"]["q"]["kernel"]).shape[0])
    for i in range(n_layers):
        walk(f"layers.{i}.", params_np["layers"], i)

    heads = ("final_ln", "classifier", "cls_head", "sentence_classifier", "mlm_head", "pooler", "score")
    for top in heads:
        if top in params_np:
            walk(f"{top}.", params_np[top], slice(None))
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The port's state_dict → the JAX parameter tree (float32 numpy
    leaves, layers stacked on a leading axis): the inverse of
    :func:`params_from_jax`."""
    tree: dict[str, Any] = {}
    layers: dict[int, dict[str, Any]] = {}

    def put(node, path, value):
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = value

    for key, value in state.items():
        arr = value.detach().cpu().float().numpy()
        parts = key.split(".")
        if parts[0] == "layers":
            put(layers.setdefault(int(parts[1]), {}), parts[2:], arr)
        elif parts[0] == "embeddings_ln":
            put(tree, ["embeddings", "ln", *parts[1:]], arr)
        else:
            put(tree, parts, arr)

    def stack(nodes):
        return {
            name: stack([n[name] for n in nodes])
            if isinstance(nodes[0][name], dict)
            else np.stack([n[name] for n in nodes])
            for name in nodes[0]
        }

    if layers:
        tree["layers"] = stack([layers[i] for i in sorted(layers)])
    return tree


def select_spans_from_token_probs(
    probs: np.ndarray,  # [T] per-context-token probabilities
    offsets: list[tuple[int, int]],  # [T] char offsets into the document
    threshold: float = 0.2,
    min_span_chars: int = 30,
    merge_gap_chars: int = 20,
) -> list[tuple[int, int]]:
    """Token probabilities → merged, filtered char spans: contiguous
    above-threshold tokens become a region; regions whose char gap ≤
    ``merge_gap_chars`` merge; regions shorter than ``min_span_chars`` drop."""
    regions: list[list[int]] = []  # [start_char, end_char]
    current: list[int] | None = None
    for p, (start, end) in zip(probs, offsets):
        if end <= start:  # special / empty token
            continue
        if p >= threshold:
            if current is None:
                current = [start, end]
            elif start - current[1] > merge_gap_chars:
                regions.append(current)
                current = [start, end]
            else:
                current[1] = max(current[1], end)
        else:
            if current is not None:
                regions.append(current)
                current = None
    if current is not None:
        regions.append(current)

    merged: list[list[int]] = []
    for region in regions:
        if merged and region[0] - merged[-1][1] <= merge_gap_chars:
            merged[-1][1] = max(merged[-1][1], region[1])
        else:
            merged.append(region)

    return [(s, e) for s, e in merged if e - s >= min_span_chars]


class ModelSpanExtractor(SpanExtractor):
    """Neural extractor backed by the PyTorch token classifier.

    ``params`` is a state_dict for :class:`HighlighterModel` (for example
    from :func:`params_from_jax`); without it the model is random-initialized
    from ``seed``. ``model_path`` names a checkpoint directory written by
    `training.Trainer.save_checkpoint` (of either package) or a HuggingFace
    token classifier (``config.json``, ``model.safetensors``,
    ``tokenizer.json``); its weights, config and tokenizer replace
    ``params``, ``config`` and ``tokenizer``.
    The model lives on ``device`` (``None`` → ``cuda``).

    ``sp_mesh`` (a `parallel.Mesh`) scores each context in ONE
    sequence-sharded pass over the devices of its ``sp_axis`` (no sliding
    windows, no ``max_length`` cap): global layers run ring attention, local
    layers halo attention. The JAX program computes the same result on every
    dp row of the mesh; the port computes it once, on the first dp row. On
    a mesh that spans processes (`parallel.distributed.global_mesh`) every
    rank plans the same row, scores its own run of shards and gathers the
    probability shards of the line in axis order, so every rank decodes the
    same spans.
    """

    def __init__(
        self,
        params: Mapping[str, torch.Tensor] | None = None,
        config: EncoderConfig | None = None,
        tokenizer: Tokenizer | None = None,
        model_path: str | None = None,
        threshold: float = 0.2,
        min_span_chars: int = 30,
        merge_gap_chars: int = 20,
        max_length: int = 8192,
        doc_stride: int = 256,
        seed: int = 0,
        sp_mesh=None,
        sp_axis: str = "tp",
        device=None,
    ):
        self.threshold = threshold
        self.min_span_chars = min_span_chars
        self.merge_gap_chars = merge_gap_chars
        self.max_length = max_length
        self.doc_stride = doc_stride
        self.sp_mesh = sp_mesh
        self.sp_axis = sp_axis
        self.device = resolve_device(device)
        if model_path is not None:
            from .hf_convert import load_highlighter_checkpoint

            params, config, tokenizer = load_highlighter_checkpoint(model_path)
            if "classifier.kernel" not in params:
                raise ValueError(
                    f"{model_path} holds no token-classification head (a sentence-classifier "
                    "checkpoint is served by SentenceModelExtractor: "
                    "hf_convert.load_span_extractor picks it)"
                )
        self.config = config or demo_highlighter_config()
        if params is None:
            self.model = init_highlighter_params(self.config, seed, self.device)
        else:
            head = (
                ("cls_head.dense.bias" in params, "cls_head.norm.bias" in params)
                if any(key.startswith("cls_head.") for key in params)
                else None
            )
            self.model = HighlighterModel(self.config, cls_head_biases=head)
            self.model.load_state_dict(params)
            self.model.to(self.device)
        self.model.eval()
        self.tokenizer = tokenizer or HashTokenizer(vocab_size=self.config.vocab_size)

    # -- SpanExtractor interface ------------------------------------------------

    def extract_spans(self, question: str, search_results: list[Any]) -> dict[str, list[str]]:
        """All documents' windows run in one padded forward."""
        texts = [getattr(r, "text", "") for r in search_results]
        span_lists = self.process_batch(question, texts)
        return {
            text: [text[s:e] for s, e in spans]
            for text, spans in zip(texts, span_lists)
        }

    # -- core ---------------------------------------------------------------------

    def process(self, question: str, context: str) -> list[tuple[int, int]]:
        """Score a (question, context) pair → char spans in ``context``."""
        return self.process_batch(question, [context])[0]

    def extract_spans_multi(
        self, pairs: list[tuple[str, list[Any]]]
    ) -> list[dict[str, list[str]]]:
        """Many (question, results) jobs in one padded forward."""
        flat_pairs: list[tuple[str, str]] = []
        shapes: list[list[str]] = []
        for question, results in pairs:
            texts = [getattr(r, "text", "") for r in results]
            shapes.append(texts)
            flat_pairs.extend((question, t) for t in texts)
        span_lists = self._process_pairs(flat_pairs)
        out: list[dict[str, list[str]]] = []
        cursor = 0
        for texts in shapes:
            spans_for_q: dict[str, list[str]] = {}
            for text in texts:
                spans = span_lists[cursor]
                cursor += 1
                spans_for_q[text] = [text[s:e] for s, e in spans]
            out.append(spans_for_q)
        return out

    def process_batch(
        self, question: str, contexts: list[str]
    ) -> list[list[tuple[int, int]]]:
        """Batched scoring: one padded forward over every context's windows."""
        return self._process_pairs([(question, c) for c in contexts])

    def _process_pairs(
        self, pairs: list[tuple[str, str]]
    ) -> list[list[tuple[int, int]]]:
        """Spans of each (question, context) pair: plan every pair's windows,
        pad them into one array, score it in slices, decode each pair.

        While a profiler records, the stages are the spans ``extract.plan``,
        ``extract.pad``, ``extract.forward`` (one a slice) and
        ``extract.decode``, and the call counts ``extract.rows`` (real
        rows), ``extract.padded_rows``, ``extract.slots`` (padded rows ×
        length), ``extract.live_slots`` (tokens), ``extract.row_pad_slots``
        (the slots of the rows added to reach the row bucket) and
        ``extract.slices``; :meth:`_forward_probs` adds its own two."""
        with profiling.span("extract.plan"):
            plans = [self._plan(q, c) for q, c in pairs]
            rows: list[list[int]] = []
            for plan in plans:
                if plan is not None:
                    rows.extend(plan["rows"])
        if not rows:
            return [[] for _ in pairs]

        with profiling.span("extract.pad"):
            longest = bucket_length(max(len(r) for r in rows))
            seq = longest if self.sp_mesh is not None else min(longest, self.max_length)
            # Row counts are bucketed to powers of two (then multiples of 512),
            # as in the JAX package; pad rows are all-pad and sliced off.
            n_real = len(rows)
            n_padded = next(
                (b for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512) if b >= n_real),
                -(-n_real // 512) * 512,
            )
            ids = np.full((n_padded, seq), self.tokenizer.pad_id, np.int32)
            mask = np.zeros((n_padded, seq), np.int32)
            for i, row in enumerate(rows):
                row = row[:seq]
                ids[i, : len(row)] = row
                mask[i, : len(row)] = 1

        # Bursts are scored in slices to bound the activation memory.
        step = max(1, min(512, SLICE_TOKENS // seq))
        if profiling.tracing():
            profiling.count("extract.rows", n_real)
            profiling.count("extract.padded_rows", n_padded)
            profiling.count("extract.slots", n_padded * seq)
            profiling.count("extract.live_slots", sum(min(len(r), seq) for r in rows))
            profiling.count("extract.row_pad_slots", (n_padded - n_real) * seq)
            profiling.count("extract.slices", -(-n_padded // step))
        scored = []
        for i in range(0, n_padded, step):
            with profiling.span("extract.forward"):
                scored.append(self._forward_probs(ids[i : i + step], mask[i : i + step]))

        with profiling.span("extract.decode"):
            probs = np.concatenate(scored, axis=0)
            out: list[list[tuple[int, int]]] = []
            cursor = 0
            for plan in plans:
                if plan is None:
                    out.append([])
                    continue
                n_windows = len(plan["rows"])
                doc_probs = probs[cursor : cursor + n_windows]
                cursor += n_windows
                # Max-aggregate across overlapping windows.
                agg = np.zeros(plan["n_tokens"], np.float32)
                for w, (ctx_start, ctx_len, tok_offset) in enumerate(plan["layout"]):
                    window = doc_probs[w, tok_offset : tok_offset + ctx_len]
                    agg[ctx_start : ctx_start + ctx_len] = np.maximum(
                        agg[ctx_start : ctx_start + ctx_len], window
                    )
                spans = select_spans_from_token_probs(
                    agg,
                    plan["offsets"],
                    threshold=self.threshold,
                    min_span_chars=self.min_span_chars,
                    merge_gap_chars=self.merge_gap_chars,
                )
                out.append(self._postprocess_spans(pairs[len(out)][1], spans))
            return out

    def _postprocess_spans(
        self, context: str, spans: list[tuple[int, int]]
    ) -> list[tuple[int, int]]:
        """Subclass decode hook; the base extractor returns spans unchanged."""
        return spans

    def _forward_probs(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """[B, S] padded token ids/mask → [B, S] relevance probabilities, 0
        on pad slots. On one device only the live tokens run (while a
        profiler records, counted as ``extract.packed_tokens``, and the
        attention views' rows × length as ``extract.attn_slots``)."""
        if self.sp_mesh is not None:
            with torch.no_grad():
                shards = token_relevance_probs_sp(
                    self.model,
                    shard_sequence(torch.from_numpy(ids), self.sp_mesh, self.sp_axis),
                    shard_sequence(torch.from_numpy(mask), self.sp_mesh, self.sp_axis),
                    self.sp_mesh,
                    self.sp_axis,
                )
            probs = torch.cat([p.cpu() for p in shards], dim=1)
            group = self.sp_mesh.line(self.sp_axis).group
            return (probs if group is None else exchange.gather_sequence(probs, group)).numpy()
        # One device: the live tokens alone (token_relevance_probs_packed).
        probs = np.zeros(mask.shape, np.float32)
        rows = pack_rows(mask)
        if rows.flat.size == 0:
            return probs
        if profiling.tracing():
            profiling.count("extract.packed_tokens", rows.flat.size)
            profiling.count("extract.attn_slots", len(rows.lengths) * rows.view_len)
        with torch.no_grad():
            probs.reshape(-1)[rows.flat] = token_relevance_probs_packed(self.model, ids, rows).cpu().numpy()
        return probs

    def _plan(self, question: str, context: str) -> dict | None:
        """Tokenize one document and lay out its windows (host-only work)."""
        if not context.strip():
            return None
        enc = self.tokenizer.encode_batch([context], max_length=10**9, with_offsets=True)
        ctx_ids = [t for t, m in zip(enc.input_ids[0], enc.attention_mask[0]) if m]
        ctx_offsets = enc.offsets[0][: len(ctx_ids)]
        # Strip specials added by encode_batch (offset (0,0) + cls/sep ids at ends).
        ctx = [(int(t), off) for t, off in zip(ctx_ids, ctx_offsets) if off[1] > off[0]]
        if not ctx:
            return None
        ctx_token_ids = [t for t, _ in ctx]
        ctx_token_offsets = [off for _, off in ctx]

        q_enc = self.tokenizer.encode_batch([question], max_length=512)
        q_tokens = [int(t) for t, m in zip(q_enc.input_ids[0], q_enc.attention_mask[0]) if m]
        # Question tokens keep their cls/sep framing; context appended after.
        if self.sp_mesh is not None:
            budget = max(len(ctx_token_ids), 16)  # one window: the SP pass
        else:
            budget = max(self.max_length - len(q_tokens) - 1, 16)  # -1: trailing sep

        windows = self._make_windows(len(ctx_token_ids), budget, self.doc_stride)
        sep = self.tokenizer.sep_id
        rows, layout = [], []
        for start, length in windows:
            rows.append(list(q_tokens) + ctx_token_ids[start : start + length] + [sep])
            layout.append((start, length, len(q_tokens)))
        return {
            "rows": rows,
            "layout": layout,
            "n_tokens": len(ctx_token_ids),
            "offsets": ctx_token_offsets,
        }

    @staticmethod
    def _make_windows(n_tokens: int, budget: int, stride: int) -> list[tuple[int, int]]:
        """(start, length) context windows with `stride` overlap."""
        if n_tokens <= budget:
            return [(0, n_tokens)]
        windows = []
        # A budget ≤ stride cannot honor the overlap; clamp the step so the
        # loop advances.
        step = max(budget - stride, 1)
        start = 0
        while start < n_tokens:
            length = min(budget, n_tokens - start)
            windows.append((start, length))
            if start + length >= n_tokens:
                break
            start += step
        return windows


class SemanticHighlightExtractor(ModelSpanExtractor):
    """Sentence/span-mode adapter over the token extractor.

    mode="spans" is the token path unchanged; mode="sentences" snaps each
    span out to the regex sentence boundaries around it and merges the
    sentences that overlap.
    """

    def __init__(self, *args, mode: str = "spans", **kwargs):
        if mode not in ("spans", "sentences"):
            raise ValueError(f"mode must be 'spans' or 'sentences', got {mode!r}")
        super().__init__(*args, **kwargs)
        self.mode = mode

    def _postprocess_spans(
        self, context: str, spans: list[tuple[int, int]]
    ) -> list[tuple[int, int]]:
        """Snap spans to sentence boundaries (mode='sentences'). Runs inside
        `_process_pairs`, so every entry point applies the mode."""
        if self.mode == "spans" or not spans:
            return spans
        boundaries = [0]
        for m in re.finditer(r"[.!?]\s+|\n+", context):
            boundaries.append(m.end())
        boundaries.append(len(context))

        snapped = []
        for s, e in spans:
            lo = max(b for b in boundaries if b <= s)
            hi = min(b for b in boundaries if b >= e)
            snapped.append((lo, hi))
        # Merge overlapping sentences.
        merged: list[list[int]] = []
        for s, e in sorted(snapped):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]
