"""`verbatim-enhance` — batch-transform JSON/JSONL records to verbatim answers.

Copy of `verbatim_rag_tpu/core/cli.py`: read records with
{question, context|sources}, run the transform, write QueryResponse JSONL.

    python -m verbatim_rag_tpu_torch.core.cli records.jsonl -o answers.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys

from .transform import VerbatimTransform


def _iter_records(path: str):
    # utf-8-sig: a BOM must not hide the leading '[' of a JSON array; skip
    # whitespace for pretty-printed arrays that start with a newline.
    with open(path, encoding="utf-8-sig") as f:
        head = ""
        while True:
            ch = f.read(1)
            if not ch or not ch.isspace():
                head = ch
                break
        f.seek(0)
        if head == "[":
            yield from json.load(f)
        else:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="verbatim-enhance",
        description="Transform RAG records (JSON/JSONL) into verbatim cited answers.",
    )
    parser.add_argument("input", help="Input JSON array or JSONL file")
    parser.add_argument("-o", "--output", help="Output JSONL file (default: stdout)")
    parser.add_argument("--model", default="gpt-4o-mini", help="LLM model for extraction")
    parser.add_argument("--api-base", default="https://api.openai.com/v1")
    parser.add_argument("--template-mode", default="static", choices=["static", "contextual"])
    parser.add_argument("--max-display-spans", type=int, default=5)
    parser.add_argument("--span-match-mode", default="exact", choices=["exact", "fuzzy"])
    args = parser.parse_args(argv)

    from .llm_client import LLMClient

    vt = VerbatimTransform(
        llm_client=LLMClient(model=args.model, api_base=args.api_base),
        max_display_spans=args.max_display_spans,
        template_mode=args.template_mode,
        span_match_mode=args.span_match_mode,
    )

    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for record in _iter_records(args.input):
            question = record.get("question", "")
            context = record.get("context") or record.get("sources") or []
            response = vt.transform(question=question, context=context)
            out.write(response.model_dump_json() + "\n")
    finally:
        if args.output:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
