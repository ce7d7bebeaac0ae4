"""Driver of the served RAG: ``VerbatimRAG.query_batch`` over a corpus made
from the seed, ingested through the MiniLM-width dense and SPLADE providers
into the bf16 store, answered by the ModernBERT span extractor.

One call is one ``query_batch`` of a traffic batch of questions. The check
compares, against the float32 reference:

- ``retrieval_miss``: the share of the reference search's top-k chunks
  missing from each question's retrieved documents, over every call of the
  window;
- ``order_miss``: the share of the reference search's (question, position)
  hits that the store did not return at that position with that fused
  score (within 1e-6), over every call of the window. The reference search
  runs on the providers' own ingest and query vectors (``dense_gap`` and
  ``splade_gap`` judge those against the reference encoders);
- ``token_mismatch``: rows of the sampled call whose token ids differ from
  the reference's plan of (question, retrieved chunk);
- ``prob_gap``: the widest gap between the extractor's token probabilities
  and the reference's, over the live tokens of those rows;
- ``span_mismatch``: documents whose highlights differ from the spans the
  reference decodes from the extractor's own probabilities;
- ``unanswered``: questions without k documents.
"""

from __future__ import annotations

import gc
import sys

import numpy as np
import torch

from portbench.harness import common, gen
from portbench.reference import encoder as ref_encoder
from portbench.reference import extract as ref_extract
from portbench.reference import tokenizer as ref_tok
from portbench.reference.search import HybridReference


def encoder_configs(cfg: dict):
    """The program's encoder configs from the configuration file."""
    from verbatim_rag_tpu_torch.models.config import minilm_config, modernbert_base_config

    e, p = cfg["extractor"], cfg["providers"]
    extractor = modernbert_base_config(
        vocab_size=e["vocab_size"], hidden_size=e["hidden_size"],
        num_layers=e["num_hidden_layers"], num_heads=e["num_attention_heads"],
        intermediate_size=e["intermediate_size"], max_position_embeddings=e["max_position_embeddings"],
        layer_norm_eps=e["norm_eps"], global_rope_theta=e["global_rope_theta"],
        local_rope_theta=e["local_rope_theta"], local_attention_window=e["local_attention"],
        global_attn_every_n_layers=e["global_attn_every_n_layers"],
    )
    providers = minilm_config(
        vocab_size=p["vocab_size"], hidden_size=p["hidden_size"], num_layers=p["num_hidden_layers"],
        num_heads=p["num_attention_heads"], intermediate_size=p["intermediate_size"],
        max_position_embeddings=p["max_position_embeddings"], type_vocab_size=p["type_vocab_size"],
        layer_norm_eps=p["layer_norm_eps"], use_flash_attention=True,
    )
    return extractor, providers


class Driver:
    """The RAG cells: set-up, one ``query_batch`` a call, the check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans: common.Spans, content_seed=None):
        self.cfg, self.traffic, self.seed, self.device, self.spans = cfg, traffic, seed, device, spans
        #: The deployment's seed (corpus and weights): the traffic's
        #: ``content_seed`` where it names one, else the run's seed. The
        #: questions always come from the run's seed.
        self.content_seed = content_seed if content_seed is not None else traffic.get("content_seed", seed)
        self.k = traffic["k"]
        self.responses: list = []
        self.hits: list = []
        self.rows: dict[int, list] = {}
        self.ingest_dense: list = []
        self.ingest_sparse: list = []
        self.query_dense: list = []
        self.query_sparse: list = []
        self.extractor_rows: list = []
        self.call_index = -1

    # -- set-up -------------------------------------------------------------------

    def specs(self):
        e = ref_encoder.arch_of(self.cfg["extractor"])
        p = ref_encoder.arch_of(self.cfg["providers"])
        return {
            "extractor": (e, ref_encoder.param_spec(e, "classifier")),
            "dense": (p, ref_encoder.param_spec(p, "none")),
            "splade": (p, ref_encoder.param_spec(p, "splade")),
        }

    def setup(self) -> None:
        from verbatim_rag_tpu_torch.engine.index import VerbatimIndex
        from verbatim_rag_tpu_torch.ingestion.chunkers import MarkdownChunkerProvider
        from verbatim_rag_tpu_torch.ingestion.document import Document
        from verbatim_rag_tpu_torch.models.highlighter import ModelSpanExtractor
        from verbatim_rag_tpu_torch.models.providers import JaxDenseProvider, JaxSpladeProvider
        from verbatim_rag_tpu_torch.rag.core import VerbatimRAG

        cfg, e, p, s = self.cfg, self.cfg["extractor"], self.cfg["providers"], self.cfg["store"]
        self.make_inputs()
        ext_cfg, prov_cfg = encoder_configs(cfg)
        weights = {
            n: common.make_weights(spec, self.content_seed, n, self.device) for n, (_, spec) in self.specs().items()
        }
        dense = JaxDenseProvider(
            params=weights["dense"], config=prov_cfg, max_length=p["max_length"],
            batch_size=p["dense_batch"], device=self.device,
        )
        splade = JaxSpladeProvider(
            params=weights["splade"], config=prov_cfg, max_length=p["max_length"],
            batch_size=p["splade_batch"], max_nnz=p["splade_max_nnz"], device=self.device,
        )
        self.index = VerbatimIndex(
            dense_provider=dense, sparse_provider=splade,
            chunker=MarkdownChunkerProvider(split_level=s["chunker_split_level"]),
            dense_dtype=s["dense_dtype"], device=self.device,
            candidate_impl=s["candidate_impl"], projection_dim=s["projection_dim"],
            rescore_depth=s["rescore_depth"],
        )
        self.spans.wrap(dense, "embed_batch", None, lambda a, k, out: self.ingest_dense.append(out))
        self.spans.wrap(splade, "embed_batch_arrays", None, lambda a, k, out: self.ingest_sparse.append(out))
        self.index.add_documents_bulk(
            [Document(content=doc, id=f"doc-{i}") for i, doc in enumerate(self.corpus["docs"])]
        )
        self.extractor = ModelSpanExtractor(
            params=weights["extractor"], config=ext_cfg, max_length=e["max_length"],
            doc_stride=e["doc_stride"], threshold=e["threshold"], min_span_chars=e["min_span_chars"],
            merge_gap_chars=e["merge_gap_chars"], device=self.device,
        )
        del weights
        self.rag = VerbatimRAG(self.index, extractor=self.extractor, k=self.k)
        self._instrument()

    def make_inputs(self) -> None:
        """The corpus from the content seed, the question batches from the
        run's seed."""
        self.corpus = gen.rag_corpus(self.content_seed, self.traffic["corpus"])
        self.calls = gen.rag_questions(self.seed, self.corpus, self.traffic["questions"])
        self.section_of = {text: i for i, text in enumerate(self.corpus["sections"])}

    def _instrument(self) -> None:
        sp, idx = self.spans, self.index
        keep = self.traffic["check_from"]

        def on_rows(args, kwargs, out):
            ids, mask = args
            sp.count("pad_slots", float((mask == 0).sum()))
            sp.count("slots", float(mask.size))
            if 0 <= self.call_index:
                self.extractor_rows.append(mask.sum(axis=1))
            if 0 <= self.call_index < keep:
                self.rows.setdefault(self.call_index, []).append((ids.copy(), mask.copy(), out.copy()))

        def on_dense(args, kwargs, out):
            if self.call_index >= 0:
                self.query_dense.append(out)

        def on_sparse(args, kwargs, out):
            if self.call_index >= 0:
                self.query_sparse.append(out)

        def on_hits(args, kwargs, out):
            if self.call_index >= 0:
                self.hits.append([[(self.section_of.get(h.text, -1), h.score) for h in r] for r in out])

        sp.wrap(idx.dense_provider, "embed_batch_device", "encode", on_dense)
        sp.wrap(idx.sparse_provider, "embed_query_arrays_device", "encode", on_sparse)
        sp.wrap(idx.store, "query_batch", "retrieve", on_hits)
        sp.wrap(self.extractor, "extract_spans_multi", "extract")
        sp.wrap(self.extractor, "_forward_probs", None, on_rows)

    def warm(self) -> None:
        """Kernel builds, library set-up and every extractor shape the window
        uses, outside the window: the window's batches are chosen
        (:meth:`select_calls`) and one call of each shape among them is
        made."""
        self.calls, shapes = self.select_calls()
        first = {}
        for batch, shape in zip(self.calls, shapes):
            first.setdefault(shape, batch)
        for batch in first.values():
            self.rag.query_batch(batch, k=self.k)
        self.extractor_rows.clear()
        self.spans.ms.clear()
        self.spans.counts.clear()

    def select_calls(self) -> tuple[list, list]:
        """The window's ``batches`` question batches and their extractor
        shapes. Each candidate batch from the run's seed is retrieved and
        the shape of its extractor rows worked out from the retrieved
        sections' token counts; where the traffic names a
        ``padded_length``, only batches whose rows pad to that length are
        kept (every seed then has the same work in another order), from at
        most ``candidates`` batches, and if none does the first batches are
        taken as they come."""
        spec, e = self.traffic["questions"], self.cfg["extractor"]
        want = spec.get("padded_length")
        kept, seen = [], []
        for n, batch in enumerate(gen.question_batches(self.seed, self.corpus, spec)):
            if len(kept) == spec["batches"] or n == spec.get("candidates", spec["batches"]):
                break
            hits = self.index.query_batch(batch, k=self.k)
            rows = [
                (ref_tok.count_tokens(q) + 3 + ref_tok.count_tokens(h.text), ref_tok.count_tokens(h.text))
                for q, hs in zip(batch, hits) for h in hs
            ]
            shape = extractor_shape(rows, e["max_length"], e["doc_stride"])
            seen.append((batch, shape))
            if want is None or shape[1] == want:
                kept.append((batch, shape))
        print(f"portbench: {len(kept)} of {len(seen)} candidate batches kept (padded length {want})",
              file=sys.stderr)
        kept = kept or seen[: spec["batches"]]
        return [b for b, _ in kept], [shape for _, shape in kept]

    # -- the window ---------------------------------------------------------------

    def call(self, i: int) -> tuple[int, int]:
        """Call i of the window: (answers attempted, answers failed)."""
        self.call_index = i
        questions = self.calls[i % len(self.calls)]
        out = self.rag.query_batch(questions, k=self.k)
        self.responses.append((questions, out))
        failed = len(questions) - len(out) + sum(1 for r in out if len(r.documents) != self.k)
        return len(questions), failed

    def end_to_end(self, window_s: float, attempted: int) -> dict:
        """Answers a second, under the traffic's name for this cell's metric."""
        return {self.traffic["throughput_metric"]: attempted / window_s}

    # -- per-layer records --------------------------------------------------------

    def layer_record(self) -> dict:
        """Model FLOPs of the window's live tokens: the extractor's rows and
        the providers' question rows."""
        e = ref_encoder.arch_of(self.cfg["extractor"])
        p = ref_encoder.arch_of(self.cfg["providers"])
        flops = sum(row_flops(e, int(n)) for lens in self.extractor_rows for n in lens)
        vocab = p["vocab"]
        for questions, _ in self.responses:
            for q in questions:
                n = len(ref_tok.framed(q, vocab, self.cfg["providers"]["max_length"]))
                flops += 2 * row_flops(p, n) + 2 * n * (p["hidden"] ** 2 + p["hidden"] * vocab)
        return {"model_flops": flops}

    # -- the check ----------------------------------------------------------------

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.rag = self.index = self.extractor = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def references(self, precision: str = "fp32") -> dict:
        return {
            n: ref_encoder.Reference(arch, common.make_weights(spec, self.content_seed, n, self.device), precision)
            for n, (arch, spec) in self.specs().items()
        }

    def check(self) -> dict:
        refs = self.references()
        store = self.cfg["store"]["dense_dtype"]
        retrieved = [
            [[self.section_of.get(d.content, -1) for d in r.documents] for r in out]
            for _, out in self.responses
        ]
        ingest = (np.concatenate(self.ingest_dense), *(np.concatenate(x) for x in zip(*self.ingest_sparse)))
        queries = [(d, *sp) for d, sp in zip(self.query_dense, self.query_sparse)]
        questions = [q for q, _ in self.responses]
        numbers = self.encoder_gaps(refs, self.sample_sections(), ingest, queries, questions)
        expected = self.search(ingest, queries, store)
        numbers["retrieval_miss"] = retrieval_miss([rows for _, rows in expected], retrieved)
        numbers["order_miss"] = order_miss(expected, self.hits)
        numbers["unanswered"] = float(sum(
            len(q) - len(out) + sum(1 for r in out if len(r.documents) != self.k)
            for q, out in self.responses
        ))
        sample = self.sample_call()
        questions, out = self.responses[sample]
        numbers.update(self.check_extraction(refs["extractor"], questions, out, self.rows[sample]))
        return numbers

    def control(self, calls: int = 2) -> dict:
        """The compared numbers of the control: the reference with fp8
        operands (and fp8 rows in its store) in the program's place, on the
        first ``calls`` calls of a window, judged as the program is."""
        self.make_inputs()
        questions = [self.calls[i % len(self.calls)] for i in range(calls)]
        ref, low = self.references(), self.references("fp8")
        with torch.no_grad():
            ingest = tuple(x.cpu().numpy() for x in self.encode(low, self.corpus["sections"]))
            queries = [self.encode(low, q) for q in questions]
        got = self.search(ingest, queries, "fp8")
        numbers = self.encoder_gaps(ref, self.sample_sections(), ingest, queries, questions)
        expected = self.search(ingest, queries, self.cfg["store"]["dense_dtype"])
        numbers["retrieval_miss"] = retrieval_miss([r for _, r in expected], [r for _, r in got])
        numbers["order_miss"] = order_miss(expected, [
            [list(zip(rows, scores)) for scores, rows in zip(*call)] for call in got
        ])
        e = self.cfg["extractor"]
        sample = int(np.random.default_rng([self.seed, 3]).integers(0, min(calls, self.traffic["check_from"])))
        gap = 0.0
        with torch.no_grad():
            for q, rows in zip(questions[sample], got[sample][1]):
                for r in rows:
                    pl = ref_extract.plan(q, self.corpus["sections"][r], e["vocab_size"], e["max_length"], e["doc_stride"])
                    for row in pl["rows"]:
                        diff = low["extractor"].token_probs(row) - ref["extractor"].token_probs(row)
                        gap = max(gap, float(diff.abs().max()))
        numbers.update(token_mismatch=0.0, prob_gap=gap, span_mismatch=0.0, unanswered=0.0)
        return numbers

    def sample_call(self) -> int:
        """The call whose extractor rows are compared, drawn from the seed
        among the first calls."""
        n = min(len(self.responses), self.traffic["check_from"])
        return int(np.random.default_rng([self.seed, 3]).integers(0, n))

    def sample_sections(self) -> np.ndarray:
        """The sections whose ingest encodings are compared, drawn from the seed."""
        n = len(self.corpus["sections"])
        rng = np.random.default_rng([self.seed, 4])
        return np.sort(rng.choice(n, size=min(n, self.traffic["check_sections"]), replace=False))

    def encode(self, refs: dict, texts) -> tuple:
        """Dense vectors [n, d] and SPLADE terms (ids, weights [n, m]; pads 0)
        of ``texts`` by the reference encoders."""
        p = self.cfg["providers"]
        m = p["splade_max_nnz"]
        dense, ids, w = [], [], []
        for t in texts:
            row = ref_tok.framed(t, p["vocab_size"], p["max_length"])
            dense.append(refs["dense"].dense_embedding(row))
            i, x = refs["splade"].splade(row, m)
            ids.append(torch.nn.functional.pad(i, (0, m - i.numel())))
            w.append(torch.nn.functional.pad(x, (0, m - x.numel())))
        return torch.stack(dense), torch.stack(ids), torch.stack(w)

    def encoder_gaps(self, refs: dict, sections, ingest: tuple, queries: list, questions: list) -> dict:
        """The providers' outputs against the reference encoders: the widest
        L2 distance of a dense vector (both unit length), and the widest
        SPLADE gap (a kept term's weight against the reference's, or a kept or
        dropped term's distance past the reference's 128th weight), as a
        share of the row's largest weight. Over the sampled sections' ingest
        encodings and every question of the window."""
        p = self.cfg["providers"]
        dev = self.device
        texts = [self.corpus["sections"][i] for i in sections]
        vecs = [(ingest[0][i], ingest[1][i], ingest[2][i]) for i in sections]
        for (dense, ids, w), qs in zip(queries, questions):
            texts.extend(qs)
            vecs.extend(zip(*(x.cpu().numpy() for x in (dense, ids, w))))
        dense_gap = splade_gap = 0.0
        with torch.no_grad():
            for text, (dense, ids, w) in zip(texts, vecs):
                row = ref_tok.framed(text, p["vocab_size"], p["max_length"])
                ref_dense = refs["dense"].dense_embedding(row)
                dense_gap = max(dense_gap, float((torch.as_tensor(dense, device=dev).float() - ref_dense).norm()))
                acts = refs["splade"].splade_acts(row)
                splade_gap = max(splade_gap, splade_distance(acts, ids, w, p["splade_max_nnz"]))
        return dict(dense_gap=dense_gap, splade_gap=splade_gap)

    def search(self, ingest: tuple, queries: list, storage: str) -> list:
        """(fused scores, sections) [questions, k] of every call by the
        reference search over the given encodings, with rows stored as
        ``storage``."""
        p, s = self.cfg["providers"], self.cfg["store"]
        dev = self.device
        with torch.no_grad():
            ref = HybridReference(
                *(torch.as_tensor(x).to(dev) for x in ingest), p["vocab_size"], s["projection_dim"],
                storage=storage,
            )
            return [
                tuple(x.tolist() for x in ref.search(*(torch.as_tensor(x).to(dev) for x in q), self.k, s["rescore_depth"]))
                for q in queries
            ]

    def check_extraction(self, ref, questions, responses, rows) -> dict:
        e = self.cfg["extractor"]
        vocab = e["vocab_size"]
        ids = np.concatenate([r[0] for r in rows])
        mask = np.concatenate([r[1] for r in rows])
        probs = np.concatenate([r[2] for r in rows])
        plans, flat = [], []
        for q, resp in zip(questions, responses):
            for d in resp.documents:
                pl = ref_extract.plan(q, d.content, vocab, e["max_length"], e["doc_stride"])
                plans.append((pl, d))
                flat.extend(pl["rows"])
        lengths = mask.sum(axis=1)
        token_mismatch = abs(int((lengths > 0).sum()) - len(flat))
        gap = 0.0
        with torch.no_grad():
            for i, row in enumerate(flat):
                if i >= len(ids) or int(lengths[i]) != len(row) or ids[i, : len(row)].tolist() != row:
                    token_mismatch += 1
                    continue
                p_ref = ref.token_probs(row).cpu().numpy()
                gap = max(gap, float(np.abs(probs[i, : len(row)] - p_ref).max()))
        span_mismatch, at = 0, 0
        for pl, doc in plans:
            n = len(pl["rows"])
            agg = ref_extract.aggregate(pl, [probs[at + j] for j in range(n)])
            at += n
            texts = [doc.content[a:b] for a, b in ref_extract.spans(
                agg, pl["offsets"], e["threshold"], e["min_span_chars"], e["merge_gap_chars"])]
            want = ref_extract.highlights(doc.content, texts)
            got = [(h.start, h.end) for h in doc.highlights]
            span_mismatch += int(want != got)
        return dict(token_mismatch=float(token_mismatch), prob_gap=gap, span_mismatch=float(span_mismatch))


def row_flops(arch: dict, n: int) -> float:
    """Model FLOPs of one row of ``n`` live tokens: twice the matmul
    parameters a token meets, and 4·H·D a (query, key) pair it attends."""
    h, i, layers = arch["hidden"], arch["intermediate"], arch["layers"]
    wi = i if arch["family"] == "bert" else 2 * i
    per_layer = 4 * h * h + h * wi + i * h
    pairs = 0
    for layer in range(layers):
        if arch["family"] == "bert" or layer % arch["global_every"] == 0:
            pairs += n * n
        else:
            q = np.arange(n)
            half = arch["window"] // 2
            pairs += int((np.minimum(n - 1, q + half) - np.maximum(0, q - half) + 1).sum())
    return 2.0 * n * per_layer * layers + 4.0 * h * pairs


def splade_distance(acts: torch.Tensor, ids, w, max_nnz: int) -> float:
    """One row's SPLADE gap: for each term the program kept, its weight's
    distance from the reference activation and how far that activation
    lies below the reference's ``max_nnz``-th; for each term of the
    reference's top ``max_nnz`` the program dropped, how far it lies above
    that weight. As a share of the row's largest activation."""
    ids, w = np.asarray(ids), np.asarray(w)
    keep = w > 0
    ids, w = ids[keep], w[keep]
    ref = acts.cpu().numpy()
    nth = max(float(np.sort(ref)[-max_nnz]), 0.0)
    gap = 0.0
    if ids.size:
        gap = max(float(np.abs(w - ref[ids]).max()), float((nth - ref[ids]).max()))
    dropped = np.setdiff1d(np.flatnonzero(ref > nth), ids)
    if dropped.size:
        gap = max(gap, float((ref[dropped] - nth).max()))
    return gap / max(float(ref.max()), 1e-30)


#: Padded lengths of the extractor's rows (the program's buckets).
LENGTH_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def extractor_shape(rows: list, max_length: int, stride: int) -> tuple[int, int]:
    """(padded rows, padded length) of one call's extractor input, from its
    (question row + section + sep, section) token counts: a section past
    one window makes more rows, rows pad to a power of two (then a multiple
    of 512) and the length to the next bucket."""
    n, longest = 0, 0
    for length, section in rows:
        budget = max(max_length - (length - section - 1) - 1, 16)
        n += len(ref_extract.windows(section, budget, stride))
        longest = max(longest, min(length, max_length))
    padded = next((b for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512) if b >= n), -(-n // 512) * 512)
    return padded, next((b for b in LENGTH_BUCKETS if b >= longest), max_length)


def order_miss(expected: list, got: list) -> float:
    """Share of the expected (question, position) hits not returned at that
    position with that fused score (within 1e-6). ``expected``: per call
    (scores, sections) [questions, k]; ``got``: per call, per question,
    (section, score) pairs in order."""
    want = missed = 0
    for (scores, rows), call in zip(expected, got):
        for b, (s_row, r_row) in enumerate(zip(scores, rows)):
            hits = call[b] if b < len(call) else []
            exp = [(r, s) for r, s in zip(r_row, s_row) if r >= 0]
            want += len(exp)
            missed += len(exp) - sum(
                1 for (r1, s1), (r2, s2) in zip(hits, exp) if r1 == r2 and abs(s1 - s2) <= 1e-6
            )
    return missed / max(want, 1) + (len(got) < len(expected))


def retrieval_miss(expected: list, retrieved: list) -> float:
    want = got = 0
    for exp_call, ret_call in zip(expected, retrieved):
        for exp, ret in zip(exp_call, ret_call):
            exp = [r for r in exp if r >= 0]
            want += len(exp)
            got += len(set(exp) & set(ret))
    return (want - got) / max(want, 1)
