"""Command line of the PyTorch port: index / query / template (port of
`verbatim_rag_tpu/rag/cli.py`).

    python -m verbatim_rag_tpu_torch.rag.cli index docs/ --db ./idx [--sparse] [--neural]
    python -m verbatim_rag_tpu_torch.rag.cli query "question" --db ./idx [--json out.json]
    python -m verbatim_rag_tpu_torch.rag.cli template --show

``index`` builds an index from files and directories (``.md`` / ``.txt``)
with the hashed providers, or with ``--neural`` the MiniLM-shaped dense and
SPLADE providers, and saves it; ``query`` loads it (rebuilding the providers
that built it), answers with the default extractor and static templates and
prints the answer with its citations (with ``--llm``, the prompted LLM
extractor and contextual templates through an OpenAI-compatible endpoint:
``--model``, ``--api-base``, the key from ``OPENAI_API_KEY``); ``template``
shows or sets the template state. ``index`` and ``query`` take ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _build_index(args):
    from verbatim_rag_tpu_torch.engine.embedding_providers import (
        HashedBowDenseProvider,
        HashedSparseProvider,
    )
    from verbatim_rag_tpu_torch.engine.index import VerbatimIndex
    from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema

    if args.neural:
        from verbatim_rag_tpu_torch.models.providers import JaxDenseProvider, JaxSpladeProvider

        dense = JaxDenseProvider(device=args.device)
        sparse = JaxSpladeProvider(device=args.device) if args.sparse else None
    else:
        dense = HashedBowDenseProvider()
        sparse = HashedSparseProvider() if args.sparse else None

    index = VerbatimIndex(
        dense_provider=dense, sparse_provider=sparse, db_path=args.db, device=args.device
    )

    docs = []
    for path in args.files:
        if os.path.isdir(path):
            for root, _dirs, files in os.walk(path):
                for fname in sorted(files):
                    if fname.endswith((".md", ".txt")):
                        docs.append(DocumentSchema.from_file(os.path.join(root, fname)))
        else:
            docs.append(DocumentSchema.from_file(path))

    index.add_documents_bulk(docs)
    index.save(args.db)
    stats = index.inspect()
    print(f"Indexed {stats['num_documents']} documents / {stats['num_chunks']} chunks → {args.db}")
    return 0


def _query(args):
    from verbatim_rag_tpu_torch.core.templates import TemplateManager
    from verbatim_rag_tpu_torch.engine.index import VerbatimIndex
    from verbatim_rag_tpu_torch.rag.core import VerbatimRAG

    # The providers that built the index are rebuilt from its persisted
    # identity: query vectors must live in the indexed space.
    index = VerbatimIndex.load(args.db, device=args.device)

    llm_client = None
    if args.llm:
        from verbatim_rag_tpu_torch.core.llm_client import LLMClient

        llm_client = LLMClient(model=args.model, api_base=args.api_base)

    tm = TemplateManager(llm_client=llm_client, default_mode="static")
    if args.templates and os.path.exists(args.templates):
        tm.load(args.templates)

    rag = VerbatimRAG(index, llm_client=llm_client, template_manager=tm, k=args.k)
    response = rag.query(args.question)

    print(response.answer)
    print()
    citations = response.structured_answer.citations
    if citations:
        print(f"--- {len(citations)} citations ---")
        for c in citations:
            preview = c.text[:80].replace("\n", " ")
            print(f"[{c.number}] ({c.type}) doc {c.doc_index}: {preview}")
    if args.json:
        with open(args.json, "w") as f:
            f.write(response.model_dump_json(indent=2))
        print(f"\nFull response written to {args.json}")
    return 0


def _template(args):
    from verbatim_rag_tpu_torch.core.templates import TemplateManager

    tm = TemplateManager(llm_client=None)
    if args.show:
        if os.path.exists(args.templates):
            tm.load(args.templates)
        print(json.dumps(tm.info(), indent=2))
        return 0
    if args.set_static:
        tm.use_static_mode(template=args.set_static)
        tm.save(args.templates)
        print(f"Static template saved to {args.templates}")
        return 0
    print("Nothing to do (use --show or --set-static)", file=sys.stderr)
    return 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="verbatim-rag-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def device_option(p):
        p.add_argument("--device", default="cuda", help="torch device (cpu runs the plain path)")

    p_index = sub.add_parser("index", help="Build an index from files/directories")
    p_index.add_argument("files", nargs="+")
    p_index.add_argument("--db", default="./verbatim_index", help="Index path prefix")
    p_index.add_argument("--sparse", action="store_true", help="Also build sparse index")
    p_index.add_argument("--neural", action="store_true", help="Use the neural encoders")
    device_option(p_index)
    p_index.set_defaults(fn=_build_index)

    p_query = sub.add_parser("query", help="Query an index")
    p_query.add_argument("question")
    p_query.add_argument("--db", default="./verbatim_index")
    p_query.add_argument("-k", type=int, default=5)
    p_query.add_argument("--llm", action="store_true", help="Use LLM extraction/templating")
    p_query.add_argument("--model", default="gpt-4o-mini")
    p_query.add_argument("--api-base", default="https://api.openai.com/v1")
    p_query.add_argument("--templates", default="")
    p_query.add_argument("--json", help="Dump full QueryResponse JSON to this path")
    device_option(p_query)
    p_query.set_defaults(fn=_query)

    p_tmpl = sub.add_parser("template", help="Manage template state")
    p_tmpl.add_argument("--templates", default="./templates.json")
    p_tmpl.add_argument("--show", action="store_true")
    p_tmpl.add_argument("--set-static", help="Set a custom static template")
    p_tmpl.set_defaults(fn=_template)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
