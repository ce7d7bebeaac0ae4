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
from .model import init_qa_model_params, predict_sentence_relevance, sentence_logits, sentence_loss
from .trainer import Trainer, eval_step, make_optimizer, metrics_from_counts, train_step

__all__ = [
    "EncodedBatch",
    "QAData",
    "QADatasetEncoder",
    "QADocument",
    "QASample",
    "Sentence",
    "Trainer",
    "eval_step",
    "init_qa_model_params",
    "make_optimizer",
    "make_synthetic_qadata",
    "metrics_from_counts",
    "predict_sentence_relevance",
    "sentence_logits",
    "sentence_loss",
    "train_step",
]
