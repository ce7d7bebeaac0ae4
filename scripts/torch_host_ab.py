"""Time the PyTorch port's host tokenization, BM25 analyzer and long pass of one source tree.

    python3 scripts/torch_host_ab.py [--tree DIR] [--label NAME] [--seed 0] [--texts 1000000]

Imports `verbatim_rag_tpu_torch` from DIR (default: the checkout holding this
script), builds its flash kernels into DIR/build/kernels (and, where the
tree has one, its C++ host runtime there too), and measures what the host
scanner changes (`engine/native.py`):

- the extractor's tokenization of `chip_smoke.long_document` (≈ 22.8k
  tokens, ASCII): `HashTokenizer.encode_batch([doc], max_length=10**9,
  with_offsets=True)`, as `ModelSpanExtractor._plan` calls it, host ms
  (median of 5);
- the long pass: `ModelSpanExtractor(config=modernbert_base_config(),
  seed=seed).process` on that document (3 windows at S=8192), host ms
  synchronized (median of 3 after one untimed call), then one call under
  `torch.profiler`: wall ms, kernel ms, idle share;
- the BM25 analyzer over ``--texts`` of `chip_smoke.text_corpus` (the
  full_text phase's 1M texts): `analyzer.analyze_texts(texts, 2**17)`, one
  call, host seconds (what the full_text ingest spends in it).

Prints one JSON line; needs one GPU. An A/B of two trees in one call, on one
card: unpack the parent commit into a git-ignored directory and run the
script in turns,

    git archive <parent> | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 scripts/torch_host_ab.py --tree $t; done
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _smoke():
    """`chip_smoke.py` of this checkout, for its corpus and timing helpers."""
    spec = importlib.util.spec_from_file_location("_chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(HERE))
    parser.add_argument("--label", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--texts", type=int, default=1_000_000)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("torch_host_ab: no CUDA device\n")
        raise SystemExit(2)
    tree = Path(args.tree).resolve()
    os.environ["VERBATIM_TORCH_BUILD_DIR"] = str(tree / "build" / "kernels")
    sys.path.insert(0, str(tree))
    from verbatim_rag_tpu_torch.engine import analyzer
    from verbatim_rag_tpu_torch.models import ModelSpanExtractor, modernbert_base_config
    from verbatim_rag_tpu_torch.ops import cuda_build

    assert Path(analyzer.__file__).resolve().is_relative_to(tree), analyzer.__file__
    smoke = _smoke()
    cuda_build.build_all(("flash_attention",))
    result = dict(tree=args.label or str(tree), card=smoke.gpu_name_and_limit())

    doc = smoke.long_document(args.seed)
    extractor = ModelSpanExtractor(config=modernbert_base_config(), seed=args.seed)
    tokenizer = extractor.tokenizer
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        enc = tokenizer.encode_batch([doc], max_length=10**9, with_offsets=True)
        times.append((time.perf_counter() - t0) * 1e3)
    result["tokenize"] = dict(tokens=int(enc.attention_mask.sum()) - 2, ms=times, ms_median=float(np.median(times)))

    question = smoke.LONG_QUESTION
    extractor.process(question, doc)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extractor.process(question, doc)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    profile = smoke.device_profile(lambda: extractor.process(question, doc))
    result["long"] = dict(
        ms=times, ms_median=float(np.median(times)), profile_wall_ms=profile["wall_ms"],
        kernel_ms=profile["kernel_ms"], idle_share=profile["idle_share"],
    )
    del extractor
    torch.cuda.empty_cache()

    texts = smoke.text_corpus(args.seed, args.texts)
    t0 = time.perf_counter()
    slots, _, offsets, _ = analyzer.analyze_texts(texts, 1 << 17)
    result["analyzer"] = dict(
        texts=len(texts), seconds=time.perf_counter() - t0, slots=int(slots.size), last_offset=int(offsets[-1]),
    )
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
