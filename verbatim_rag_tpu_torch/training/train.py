"""Training CLI for the extractor models (port of
`verbatim_rag_tpu/training/train.py`).

Run: ``python -m verbatim_rag_tpu_torch.training.train --data-path data.json``
(``--mode token`` trains the v2 highlighter that `ModelSpanExtractor`
serves; ``--device cpu`` runs the plain versions of the kernels). The flags
and defaults are the JAX CLI's. ``--dp/--tp`` train on a ``[dp, tp]`` mesh
(:func:`train_mesh`): on CUDA over every visible card (``dp·tp`` must be
their count), with ``--device cpu`` over the CPU repeated ``dp·tp`` times.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from verbatim_rag_tpu_torch.device import resolve_device
from verbatim_rag_tpu_torch.models.config import (
    TrainingConfig,
    modernbert_base_config,
    tiny_test_config,
)
from verbatim_rag_tpu_torch.models.highlighter import init_highlighter_params
from verbatim_rag_tpu_torch.models.tokenizer import HashTokenizer
from verbatim_rag_tpu_torch.parallel.mesh import make_mesh

from .dataset import QAData, QADatasetEncoder
from .model import init_qa_model_params, sentence_loss, token_loss
from .token_dataset import TokenDatasetEncoder, load_token_examples
from .trainer import Trainer


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-path", required=True, help="QAData JSON file")
    parser.add_argument("--output-dir", default="./qa_model_out")
    parser.add_argument("--max-seq-length", type=int, default=4096)
    parser.add_argument("--max-sentences", type=int, default=64)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--learning-rate", type=float, default=2e-5)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--dp", type=int, default=None, help="data-parallel mesh size")
    parser.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh size")
    parser.add_argument("--tiny", action="store_true", help="tiny config (smoke test)")
    parser.add_argument("--init-from", help="checkpoint dir to warm-start from")
    parser.add_argument(
        "--mode",
        default="sentence",
        choices=["sentence", "token"],
        help="sentence = legacy v1 classifier over QAData; "
        "token = v2 highlighter over {question, context, answers} records",
    )
    parser.add_argument("--doc-stride", type=int, default=128, help="token mode windows")
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    args = parser.parse_args(argv)
    mesh = train_mesh(args.dp, args.tp, args.device)

    logging.basicConfig(level=logging.INFO)
    config = tiny_test_config() if args.tiny else modernbert_base_config()
    tc = TrainingConfig(
        learning_rate=args.learning_rate,
        batch_size=args.batch_size,
        num_epochs=args.epochs,
        max_seq_length=args.max_seq_length,
        seed=args.seed,
    )
    tokenizer = HashTokenizer(vocab_size=config.vocab_size)
    if args.mode == "token":
        return _train_token(args, config, tc, tokenizer, mesh)

    data = QAData.from_json(args.data_path)
    train_samples = data.filter_split("train")
    dev_samples = data.filter_split("dev") or train_samples[: max(1, len(train_samples) // 10)]
    test_samples = data.filter_split("test")
    encoder = QADatasetEncoder(
        tokenizer, max_length=args.max_seq_length, max_sentences=args.max_sentences
    )

    model = init_qa_model_params(config, args.seed, args.device)
    trainer = Trainer(model, config, tc, output_dir=args.output_dir, mesh=mesh, loss_fn=sentence_loss)
    if args.init_from:
        Trainer.load_checkpoint(args.init_from, trainer.model)

    dev_batches = list(encoder.iter_batches(dev_samples, args.batch_size))
    result = trainer.train(
        [],
        dev_batches=dev_batches,
        make_train_iter=lambda epoch: encoder.iter_batches(
            train_samples, args.batch_size, shuffle=True, seed=args.seed + epoch
        ),
    )
    print(f"best dev F1: {result['best_f1']:.4f}")

    if test_samples:
        test_metrics = trainer.evaluate(list(encoder.iter_batches(test_samples, args.batch_size)))
        with open(os.path.join(args.output_dir, "test_metrics.json"), "w") as f:
            json.dump(test_metrics, f, indent=2)
        print(f"test: {test_metrics}")
    return 0


def train_mesh(dp: int | None, tp: int, device=None):
    """The mesh of ``--dp/--tp`` (None when neither is given, as JAX's CLI):
    on CUDA every visible card (`make_mesh` raises when ``dp·tp`` differs
    from their count), on the CPU the one device repeated ``dp·tp`` times."""
    if not dp and tp <= 1:
        return None
    device = resolve_device(device)
    if device.type == "cuda":
        return make_mesh(dp=dp, tp=tp)
    return make_mesh(dp=dp or 1, tp=tp, devices=[device] * ((dp or 1) * tp))


def _train_token(args, config, tc, tokenizer, mesh) -> int:
    """Token-classification training: produces checkpoints that
    `ModelSpanExtractor(model_path=...)` serves (the v2 highlighter path)."""
    examples = load_token_examples(args.data_path)
    train = [e for e in examples if e.split == "train"]
    dev = [e for e in examples if e.split == "dev"] or train[: max(1, len(train) // 10)]
    encoder = TokenDatasetEncoder(
        tokenizer, max_length=args.max_seq_length, doc_stride=args.doc_stride
    )
    model = init_highlighter_params(config, args.seed, args.device)
    trainer = Trainer(model, config, tc, output_dir=args.output_dir, mesh=mesh, loss_fn=token_loss)
    if args.init_from:
        Trainer.load_checkpoint(args.init_from, trainer.model)

    result = trainer.train(
        [],
        dev_batches=list(encoder.iter_batches(dev, args.batch_size)),
        make_train_iter=lambda epoch: encoder.iter_batches(
            train, args.batch_size, shuffle=True, seed=args.seed + epoch
        ),
    )
    print(f"best dev token-F1: {result['best_f1']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
