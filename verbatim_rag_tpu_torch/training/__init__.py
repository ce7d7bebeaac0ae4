"""Extractor-model training: dataset, model, trainer, CLI."""

from .dataset import (
    EncodedBatch,
    QAData,
    QADatasetEncoder,
    QADocument,
    QASample,
    Sentence,
    make_synthetic_qadata,
)
from .model import (
    init_qa_model_params,
    masked_loss,
    predict_sentence_relevance,
    sentence_logits,
    sentence_loss,
    token_loss,
)
from .trainer import (
    Trainer,
    batch_to_device,
    batch_to_mesh,
    eval_step,
    make_optimizer,
    metrics_from_counts,
    train_step,
)

__all__ = [
    "EncodedBatch",
    "QAData",
    "QADatasetEncoder",
    "QADocument",
    "QASample",
    "Sentence",
    "Trainer",
    "batch_to_device",
    "batch_to_mesh",
    "eval_step",
    "init_qa_model_params",
    "make_optimizer",
    "make_synthetic_qadata",
    "masked_loss",
    "metrics_from_counts",
    "predict_sentence_relevance",
    "sentence_logits",
    "sentence_loss",
    "token_loss",
    "train_step",
]
