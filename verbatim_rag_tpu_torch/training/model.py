"""The trainable extractor models and their losses (port of
`verbatim_rag_tpu/training/model.py`).

- v1, sentence relevance: the encoder, per-sentence mean-pooled hidden
  states and a linear 2-class head (:class:`QAModel`). Pooling is a prefix
  sum gather, ``mean(h[s:e]) = (cumsum[e] − cumsum[s]) / (e − s)``, one
  vectorized op for all sentences of all rows.
- v2, token relevance: `models.highlighter.HighlighterModel`, trained with
  :func:`token_loss` on its ``classifier`` head, so trained weights drop into
  `ModelSpanExtractor`.

A model carries its config; a batch is a dict of tensors on the model's
device (`trainer.batch_to_device`), or on a mesh the list of its data rows'
dicts (`trainer.batch_to_mesh`), each loss then taking JAX's global masked
mean over the rows (:func:`masked_loss`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from verbatim_rag_tpu_torch.device import resolve_device
from verbatim_rag_tpu_torch.models.config import EncoderConfig
from verbatim_rag_tpu_torch.models.encoder import Dense, Encoder, compute_dtype
from verbatim_rag_tpu_torch.parallel import distributed
from verbatim_rag_tpu_torch.parallel.mesh import ShardedModel


class QAModel(Encoder):
    """Encoder + per-sentence 2-class head (``sentence_classifier``)."""

    def __init__(self, config: EncoderConfig, generator: torch.Generator | None = None):
        super().__init__(config, generator)
        self.sentence_classifier = Dense(config.hidden_size, 2, True, generator)


def init_qa_model_params(config: EncoderConfig, seed: int = 0, device=None) -> QAModel:
    """Random-init the sentence classifier from an explicit ``torch.Generator``
    seed (normal·0.02 kernels and embeddings, zero biases, unit LayerNorms)."""
    generator = torch.Generator().manual_seed(seed)
    return QAModel(config, generator).to(resolve_device(device))


def sentence_logits(
    model: QAModel,
    input_ids: torch.Tensor,  # [B, S]
    attention_mask: torch.Tensor,  # [B, S]
    boundaries: torch.Tensor,  # [B, M, 2] token (start, end); end exclusive
    sentence_mask: torch.Tensor,  # [B, M]
) -> torch.Tensor:
    """Per-sentence 2-class logits — [B, M, 2] float32."""
    hidden = model(input_ids, attention_mask)  # [B, S, H]
    csum = F.pad(torch.cumsum(hidden, dim=1), (0, 0, 1, 0))  # prefix[0] = 0
    starts = boundaries[..., 0].long()
    ends = boundaries[..., 1].long()
    width = hidden.shape[-1]
    sums = torch.gather(csum, 1, ends[..., None].expand(-1, -1, width)) - torch.gather(
        csum, 1, starts[..., None].expand(-1, -1, width)
    )  # [B, M, H]
    lengths = torch.clamp((ends - starts)[..., None], min=1).float()
    logits = model.sentence_classifier(sums / lengths, compute_dtype(model.config))
    return torch.where(sentence_mask[..., None] > 0, logits, 0.0)


def masked_sums(logits, labels, mask) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The masked cross-entropy's sum and the counts the metrics are made
    from (``n_sentences`` is the mask's sum: the loss's denominator)."""
    labels = labels.long()
    mask = mask.float()
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(log_probs, -1, labels[..., None])[..., 0]
    preds = torch.argmax(logits, dim=-1)
    counts = {
        "n_sentences": mask.sum(),
        "n_correct": ((preds == labels).float() * mask).sum(),
        "tp": (((preds == 1) & (labels == 1)).float() * mask).sum(),
        "fp": (((preds == 1) & (labels == 0)).float() * mask).sum(),
        "fn": (((preds == 0) & (labels == 1)).float() * mask).sum(),
    }
    return (nll * mask).sum(), counts


def masked_loss(model, batch, logits_fn, mask_key: str):
    """The masked mean cross-entropy of ``logits_fn(model, batch)`` and its
    metric counts.

    ``batch`` is a dict of tensors, or on a mesh (`parallel.mesh.ShardedModel`)
    the list of its data rows' dicts (`trainer.batch_to_mesh`). The loss is
    JAX's global masked mean: the shards' nll sums, added in row order on the
    first row's device, over the global mask count (never a mean of the
    shards' means: rows carry different numbers of live labels). Counts sum
    over the rows; under a process group of more than one process they and
    the denominator also sum over :func:`loss_group` (`parallel.distributed`),
    so each process's loss is its share of the global mean. On a mesh that
    spans processes every rank of a tp row holds the row's logits
    (`DPShard.logits`) and the sum runs over the rank's dp column, which
    holds each dp row once.
    """
    if isinstance(batch, dict):
        parts = [(logits_fn(model, batch), batch)]
    else:
        parts = [(shard.logits(logits_fn, b), b) for shard, b in zip(model.dp_shards(), batch)]
    sums = [masked_sums(logits, b["labels"], b[mask_key]) for logits, b in parts]
    nll, counts = sums[0]
    for part, part_counts in sums[1:]:
        nll = nll + part.to(nll.device)
        counts = {k: v + part_counts[k].to(nll.device) for k, v in counts.items()}
    counts = {k: v.to(nll.device) for k, v in distributed.all_reduce_sum(counts, loss_group(model)).items()}
    return nll / torch.clamp(counts["n_sentences"], min=1.0), counts


def loss_group(model):
    """The process group a loss's counts and value sum over: a mesh model's
    `ShardedModel.dp_group`, else the whole group (None: no sum)."""
    return model.dp_group() if isinstance(model, ShardedModel) else distributed.world()


def _sentence_logits(model, batch):
    return sentence_logits(
        model, batch["input_ids"], batch["attention_mask"], batch["boundaries"], batch["sentence_mask"]
    )


def sentence_loss(model: QAModel, batch):
    """Masked mean cross-entropy over real sentences + metrics aux."""
    return masked_loss(model, batch, _sentence_logits, "sentence_mask")


def _token_logits(model, batch):
    hidden = model(batch["input_ids"], batch["attention_mask"])
    return model.classifier(hidden, compute_dtype(model.config))  # [B, S, 2]


def token_loss(model, batch):
    """Token-classification loss for the v2 highlighter.

    batch: input_ids/attention_mask [B, S], labels [B, S], label_mask [B, S]
    (1 only on context tokens). Uses the ``classifier`` head directly (as the
    JAX package does), so trained weights drop into `ModelSpanExtractor`.
    """
    return masked_loss(model, batch, _token_logits, "label_mask")


def predict_sentence_relevance(
    model: QAModel,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    boundaries: torch.Tensor,
    sentence_mask: torch.Tensor,
) -> torch.Tensor:
    """P(sentence relevant) — [B, M] float32."""
    with torch.no_grad():
        logits = sentence_logits(model, input_ids, attention_mask, boundaries, sentence_mask)
    return torch.softmax(logits.float(), dim=-1)[..., 1]
