"""The PyTorch port runs its main path without JAX or the JAX package.

A fresh interpreter ingests the example documents, answers a question with
the default extractor on the CPU, ingests them again through the neural
dense and SPLADE providers (`add_documents_batch`) and answers two questions
with one `query_batch`, runs a hybrid query over an int8 index
(the section path) and over a float32 index with an int16 / float16 forward
index (the section path), calls the bucket-max v1 entry points, queries a
mesh index of four ``"cpu"`` devices with int4 sketches, takes one training
step of the token highlighter and
saves and loads its checkpoint, takes one step on a ``dp=2, tp=2`` mesh of
``"cpu"`` devices (`parallel.distributed.initialize` a no-op), scores a document in one sequence-parallel
pass over a ``tp=2`` mesh of ``"cpu"`` devices, and then must hold no ``jax``
module and no ``verbatim_rag_tpu`` module. A second interpreter saves,
loads and queries a full-text index and runs the CLI's ``index`` and
``query``, under the same rule. A third starts the port's HTTP server on
the CPU from a saved index and answers one ``/api/query`` over a socket. A
fourth stages a trainer checkpoint for the Hub, serves its HuggingFace files
(with a ``tokenizer.json`` trained in the process) through the HF branch of
the loaders, serves a sentence-head checkpoint through
`SentenceModelExtractor`, and answers a question with a cross-encoder
reranker. A fifth ingests HTML pages and a fetched URL, indexes them
through a remote embedding provider served on 127.0.0.1, and runs
`VerbatimDOC` and `verbatim_enhance` over the saved index. A sixth builds the
port's C++ host runtime into a directory of its own, tokenizes a long ASCII
document through its scanner and ingests and queries full text through its
analyzer. Two gloo processes search an index whose rows they share (the
group path of `parallel/sharded_search.py`). The same holds for every
module of the port imported on its own.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

FLOW = """
import json, sys
from pathlib import Path
from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.rag import VerbatimRAG

index = VerbatimIndex(
    dense_provider=HashedBowDenseProvider(), sparse_provider=HashedSparseProvider(), device="cpu"
)
index.add_documents([DocumentSchema.from_file(str(p)) for p in sorted(Path("examples/example_docs").glob("*.md"))])
response = VerbatimRAG(index).query("How efficient are solar panels?")
ok = all(d.content[h.start:h.end] == h.text for d in response.documents for h in d.highlights)

from verbatim_rag_tpu_torch.models import JaxDenseProvider, JaxSpladeProvider, minilm_config
ncfg = minilm_config(hidden_size=64, num_heads=2, num_layers=2, intermediate_size=128, vocab_size=1024,
                     max_position_embeddings=128, compute_dtype="float32")
neural = VerbatimIndex(
    dense_provider=JaxDenseProvider(config=ncfg, max_length=128, batch_size=4, device="cpu"),
    sparse_provider=JaxSpladeProvider(config=ncfg, max_length=128, batch_size=4, max_nnz=32, device="cpu"),
    device="cpu",
)
neural_rag = VerbatimRAG(neural)
neural_rag.add_documents_batch([DocumentSchema.from_file(str(p)) for p in sorted(Path("examples/example_docs").glob("*.md"))])
neural_batch = neural_rag.query_batch(["How efficient are solar panels?", "Why is offshore wind steadier?"])
neural_ok = all(d.content[h.start:h.end] == h.text for r in neural_batch for d in r.documents for h in d.highlights)
int8 = VerbatimIndex(
    dense_provider=HashedBowDenseProvider(), sparse_provider=HashedSparseProvider(), device="cpu",
    dense_dtype="int8", sketch_dtype="int8",
)
int8.add_documents([DocumentSchema.from_file(str(p)) for p in sorted(Path("examples/example_docs").glob("*.md"))])
int8_hits = int8.query("How efficient are solar panels?", k=3)
narrow = VerbatimIndex(
    dense_provider=HashedBowDenseProvider(), sparse_provider=HashedSparseProvider(), device="cpu",
    dense_dtype="float32", sparse_ids_dtype="int16", sparse_weight_dtype="float16",
)
narrow.add_documents([DocumentSchema.from_file(str(p)) for p in sorted(Path("examples/example_docs").glob("*.md"))])
narrow.store.candidate_impl = "section"
narrow_hits = narrow.query("How efficient are solar panels?", k=3)

import torch
from verbatim_rag_tpu_torch.ops.fused_topk import fused_candidate_topk, matmul_bucket_max
v1_vals, v1_rows = matmul_bucket_max(torch.randn(2048, 16), torch.randn(3, 16), torch.ones(2048, dtype=torch.bool))
_, v1_top = fused_candidate_topk(torch.randn(2048, 16), torch.randn(3, 16), 5, torch.ones(2048, dtype=torch.bool))

import tempfile
from verbatim_rag_tpu_torch.models import HashTokenizer, ModelSpanExtractor, init_highlighter_params
from verbatim_rag_tpu_torch.models.config import tiny_test_config
from verbatim_rag_tpu_torch.training.model import token_loss
from verbatim_rag_tpu_torch.training.token_dataset import TokenDatasetEncoder, make_synthetic_token_data
from verbatim_rag_tpu_torch.training.trainer import Trainer, batch_to_device, train_step

config = tiny_test_config()
model = init_highlighter_params(config, seed=0, device="cpu")
trainer = Trainer(model, config, loss_fn=token_loss)
batch = TokenDatasetEncoder(HashTokenizer(config.vocab_size), max_length=64).encode(make_synthetic_token_data(2))
loss, _ = train_step(model, trainer.optimizer, batch_to_device(batch, "cpu"), token_loss)
with tempfile.TemporaryDirectory() as ckpt:
    trainer.save_checkpoint(ckpt)
    served = ModelSpanExtractor(model_path=ckpt, device="cpu")
    reloaded = all(
        bool((served.model.state_dict()[k] == v).all()) for k, v in model.state_dict().items()
    )
from verbatim_rag_tpu_torch.parallel import make_mesh
from verbatim_rag_tpu_torch.parallel.distributed import initialize

mesh_trainer = Trainer(
    init_highlighter_params(config, seed=1, device="cpu"), config, loss_fn=token_loss,
    mesh=make_mesh(dp=2, tp=2, devices=["cpu"] * 4),
)
mesh_loss, _ = train_step(mesh_trainer.model, mesh_trainer.optimizer, mesh_trainer.batch_to_device(batch), token_loss)
single_process = initialize() is False
from verbatim_rag_tpu_torch.parallel import make_mesh

mesh_index = VerbatimIndex(
    dense_provider=HashedBowDenseProvider(), sparse_provider=HashedSparseProvider(),
    mesh=make_mesh(dp=2, tp=2, devices=["cpu"] * 4), sketch_dtype="int4",
)
mesh_index.add_documents([DocumentSchema.from_file(str(p)) for p in sorted(Path("examples/example_docs").glob("*.md"))])
mesh_hits = mesh_index.query_batch(["How efficient are solar panels?", "wind"], k=3)
sp = ModelSpanExtractor(sp_mesh=make_mesh(dp=1, tp=2, devices=["cpu"] * 2), device="cpu", threshold=0.0)
sp_text = " ".join(Path("examples/example_docs/solar.md").read_text().split()[:150])
sp_spans = sp.process("How efficient are solar panels?", sp_text)
print(json.dumps({
    "sp_rows": len(sp._plan("How efficient are solar panels?", sp_text)["rows"]),
    "sp_whole": sp_spans == [(0, len(sp_text))],
    "train_loss": float(loss),
    "mesh_train_loss": float(mesh_loss),
    "single_process": single_process,
    "checkpoint_reloaded": reloaded,
    "mesh_hits": [len(r) for r in mesh_hits],
    "mesh_shards": [type(mesh_index.store._sp_proj).__name__, len(mesh_index.store._sp_proj.shards)],
    "int8_impl": int8.store.candidate_impl,
    "int8_hits": len(int8_hits),
    "narrow_hits": len(narrow_hits),
    "narrow_dtypes": [str(narrow.store._sp_ids.dtype), str(narrow.store._sp_w.dtype), str(narrow.store._dense.dtype)],
    "v1_shapes": [list(v1_vals.shape), list(v1_rows.shape), list(v1_top.shape)],
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "reference": sorted(m for m in sys.modules if m == "verbatim_rag_tpu" or m.startswith("verbatim_rag_tpu.")),
    "docs": len(response.documents),
    "verbatim": ok,
    "neural_chunks": neural.inspect()["num_chunks"],
    "neural_batch_docs": [len(r.documents) for r in neural_batch],
    "neural_verbatim": neural_ok,
}))
"""

PERSIST = """
import contextlib, io, json, sys, tempfile
from pathlib import Path
from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.rag import cli

docs = [DocumentSchema.from_file(str(p)) for p in sorted(Path("examples/example_docs").glob("*.md"))]
tmp = tempfile.mkdtemp()
index = VerbatimIndex(
    dense_provider=HashedBowDenseProvider(), sparse_provider=HashedSparseProvider(), device="cpu",
    enable_full_text=True, full_text_vocab=4096,
)
index.add_documents(docs)
index.save(tmp + "/ft")
loaded = VerbatimIndex.load(tmp + "/ft", device="cpu")
weights = {"dense": 1.0, "sparse": 1.0, "full_text": 1.0}
before = [[h.id for h in r] for r in index.query_batch(["solar panels", "wind"], k=3, hybrid_weights=weights)]
after = [[h.id for h in r] for r in loaded.query_batch(["solar panels", "wind"], k=3, hybrid_weights=weights)]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    cli.main(["index", "examples/example_docs", "--db", tmp + "/cli", "--sparse", "--device", "cpu"])
    cli.main(["query", "How efficient are solar panels?", "--db", tmp + "/cli", "--json", tmp + "/r.json",
              "--device", "cpu"])
response = json.load(open(tmp + "/r.json"))
print(json.dumps({
    "same_rows": before == after and all(before),
    "cli_indexed": "Indexed 2 documents" in out.getvalue(),
    "cli_verbatim": bool(response["documents"]) and all(
        d["content"][h["start"]:h["end"]] == h["text"] for d in response["documents"] for h in d["highlights"]
    ),
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "reference": sorted(m for m in sys.modules if m == "verbatim_rag_tpu" or m.startswith("verbatim_rag_tpu.")),
}))
"""

SERVE = """
import asyncio, json, os, sys, tempfile
from pathlib import Path
from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema

tmp = tempfile.mkdtemp()
index = VerbatimIndex(dense_provider=HashedBowDenseProvider(), sparse_provider=HashedSparseProvider(), device="cpu")
index.add_documents([DocumentSchema.from_file(str(p)) for p in sorted(Path("examples/example_docs").glob("*.md"))])
index.save(tmp + "/idx")
os.environ.update(INDEX_PATH=tmp + "/idx", VERBATIM_FORCE_PLATFORM="cpu")

from aiohttp import ClientSession, web
from verbatim_rag_tpu_torch.api import app, dependencies


async def serve():
    runner = web.AppRunner(app.create_app(static_dir="frontend"))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    url = "http://127.0.0.1:%d" % site._server.sockets[0].getsockname()[1]
    try:
        await runner.app["warmup_task"]
        async with ClientSession() as session:
            async with session.post(url + "/api/query", json={"question": "How efficient are solar panels?"}) as r:
                return r.status, await r.json()
    finally:
        await runner.cleanup()


status, body = asyncio.run(serve())
print(json.dumps({
    "status": status,
    "docs": len(body["documents"]),
    "verbatim": all(d["content"][h["start"]:h["end"]] == h["text"] for d in body["documents"] for h in d["highlights"]),
    "device": str(dependencies.get_rag().extractor.device),
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "reference": sorted(m for m in sys.modules if m == "verbatim_rag_tpu" or m.startswith("verbatim_rag_tpu.")),
}))
"""

CHECKPOINTS = """
import asyncio, json, shutil, sys, tempfile
from pathlib import Path
from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.models import HashTokenizer, ModelSpanExtractor, init_highlighter_params
from verbatim_rag_tpu_torch.models.config import minilm_config, tiny_test_config
from verbatim_rag_tpu_torch.models.hf_convert import load_span_extractor
from verbatim_rag_tpu_torch.models.tokenizer import train_wordpiece_tokenizer
from verbatim_rag_tpu_torch.rag import JaxReranker, StreamingRAG, VerbatimRAG
from verbatim_rag_tpu_torch.training.model import init_qa_model_params
from verbatim_rag_tpu_torch.training.trainer import Trainer
from verbatim_rag_tpu_torch.utils.upload_to_hub import jax_checkpoint_to_hf_dir

tmp = Path(tempfile.mkdtemp())
docs = [DocumentSchema.from_file(str(p)) for p in sorted(Path("examples/example_docs").glob("*.md"))]
config = tiny_test_config(position_embedding_type="rope", norm_location="pre", activation="geglu",
                          use_bias=False, final_norm=True, type_vocab_size=0, first_layer_no_attn_norm=True,
                          global_attn_every_n_layers=2, local_attention_window=8, vocab_size=512)
model = init_highlighter_params(config, seed=1, device="cpu")
Trainer(model, config, tokenizer=HashTokenizer(512)).save_checkpoint(str(tmp / "ckpt"))
jax_checkpoint_to_hf_dir(str(tmp / "ckpt"), str(tmp / "staged"))
(tmp / "hf").mkdir()
for name in ("config.json", "model.safetensors"):
    shutil.copy(tmp / "staged" / name, tmp / "hf" / name)
train_wordpiece_tokenizer(tmp / "hf" / "tokenizer.json", [d.content for d in docs], vocab_size=300)
hf = load_span_extractor(str(tmp / "hf"), device="cpu", threshold=0.0, min_span_chars=1, merge_gap_chars=10**4)
text = docs[0].content[:300]
hf_spans = hf.process("solar", text)
same_weights = all(bool((hf.model.state_dict()[k] == v).all()) for k, v in model.state_dict().items())

sentence = init_qa_model_params(config, seed=2, device="cpu")
Trainer(sentence, config, tokenizer=HashTokenizer(512)).save_checkpoint(str(tmp / "sentence"))
sent = load_span_extractor(str(tmp / "sentence"), device="cpu", threshold=0.0)

class R:
    text = text

kept = sent.extract_spans("solar", [R()])[text]

index = VerbatimIndex(dense_provider=HashedBowDenseProvider(), sparse_provider=HashedSparseProvider(), device="cpu")
index.add_documents(docs)
ce = minilm_config(hidden_size=64, num_heads=2, num_layers=2, intermediate_size=128, vocab_size=1024,
                   max_position_embeddings=512, compute_dtype="float32", use_flash_attention=True)
rag = VerbatimRAG(index, extractor=hf, reranker=JaxReranker(config=ce, device="cpu", rerank_k=3), k=4)
question = "How efficient are solar panels?"
response = rag.query(question)
batch = rag.query_batch([question, "wind"])
async_response = asyncio.run(rag.query_async(question))
events = StreamingRAG(rag).stream_query_sync(question)
print(json.dumps({
    "hf_class": type(hf).__name__,
    "hf_tokenizer": type(hf.tokenizer).__name__,
    "hf_whole": hf_spans == [(0, len(text))],
    "hf_same_weights": same_weights,
    "sentence_class": type(sent).__name__,
    "sentence_verbatim": bool(kept) and all(s in text for s in kept),
    "reranked_docs": len(response.documents),
    "batch_equal": batch[0].model_dump() == response.model_dump(),
    "async_equal": async_response.model_dump() == response.model_dump(),
    "stream_stages": [t["stage"] for t in events[-1]["timings"]],
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "reference": sorted(m for m in sys.modules if m == "verbatim_rag_tpu" or m.startswith("verbatim_rag_tpu.")),
}))
"""

DOC = """
import asyncio, http.server, json, os, sys, tempfile, threading
from pathlib import Path
for key in [k for k in os.environ if k.lower().endswith("_proxy")]:
    del os.environ[key]  # the stub below is on 127.0.0.1: nothing may go through a proxy
from verbatim_rag_tpu_torch.core import TemplateManager, VerbatimTransform, verbatim_enhance
from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, OpenAIEmbeddingProvider, VerbatimIndex
from verbatim_rag_tpu_torch.ingestion.document_processor import DocumentProcessor
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.models import ModelSpanExtractor
from verbatim_rag_tpu_torch.models.config import tiny_test_config
from verbatim_rag_tpu_torch.rag import IndexProvider, VerbatimDOC, VerbatimRAG

stub = HashedBowDenseProvider(dim=64)


class Embeddings(http.server.BaseHTTPRequestHandler):
    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        data = [{"index": i, "embedding": stub.embed_text(t).tolist()} for i, t in enumerate(body["input"])]
        out = json.dumps({"data": data}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *args):
        pass


server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Embeddings)
threading.Thread(target=server.serve_forever, daemon=True).start()
api = "http://127.0.0.1:%d/v1" % server.server_address[1]

tmp = Path(tempfile.mkdtemp())
(tmp / "pages").mkdir()
for p in sorted(Path("examples/example_docs").glob("*.md")):
    body = "".join("<h1>%s</h1>" % line[2:] if line.startswith("# ") else "<p>%s</p>" % line
                   for line in p.read_text().splitlines() if line.strip())
    (tmp / "pages" / (p.stem + ".html")).write_text("<html><body>" + body + "</body></html>")
docs = list(DocumentProcessor().process_directory(str(tmp / "pages")))


class Page:
    text = "<h1>Remote</h1><p>Solar panels on a fetched page.</p>"
    headers = {"content-type": "text/html"}


DocumentProcessor.http_get = staticmethod(lambda url: Page())
fetched = DocumentSchema.from_url("https://example.com/page")
index = VerbatimIndex(
    dense_provider=OpenAIEmbeddingProvider(model="m", api_base=api, dimension=64),
    sparse_provider=HashedSparseProvider(), device="cpu", dense_dtype="int8", sketch_dtype="int8",
)
index.add_documents([*docs, fetched])
index.save(str(tmp / "idx"))
loaded = VerbatimIndex.load(str(tmp / "idx"), device="cpu")
extractor = ModelSpanExtractor(config=tiny_test_config(), device="cpu", threshold=0.0)
rag = VerbatimRAG(loaded, extractor=extractor, k=2)
report = chr(10).join(["# Report", "## Solar", "[!query=How efficient are solar panels?]", "## Wind", "[!query=offshore wind|k=1,format=bullet]"])
doc = VerbatimDOC(rag).process(report)


async def events():
    return [e async for e in VerbatimDOC(rag).stream_process(report)]


streamed = asyncio.run(events())
provider = IndexProvider(loaded)
transform = VerbatimTransform(extractor=extractor, template_manager=TemplateManager(default_mode="static"))
enhanced = verbatim_enhance(transform=transform)(lambda question: provider.retrieve(question, k=2))("solar panels")
server.shutdown()
print(json.dumps({
    "pages": len(docs),
    "fetched": "Remote" in fetched.content,
    "provider": loaded.dense_provider.describe()["class"],
    "impl": loaded.store.candidate_impl,
    "spliced": "[!query" not in doc.document and len(doc.queries) == 2,
    "citations": len(doc.citations),
    "stream_done": streamed[-1]["type"] == "done" and streamed[-1]["document"] == doc.document,
    "enhanced_docs": len(enhanced.documents),
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "reference": sorted(m for m in sys.modules if m == "verbatim_rag_tpu" or m.startswith("verbatim_rag_tpu.")),
}))
"""

NATIVE = """
import json, os, sys, tempfile
from pathlib import Path
import numpy as np
build = tempfile.mkdtemp()
os.environ["VERBATIM_TORCH_BUILD_DIR"] = build
from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex, native
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.models import HashTokenizer

words = Path("examples/example_docs/solar.md").read_text().split() + Path("examples/example_docs/wind.md").read_text().split()
doc = " ".join(np.random.default_rng(0).choice(words, size=19000))
tokenizer = HashTokenizer()
batch = tokenizer.encode_batch([doc], max_length=32768, with_offsets=True)
ids, offsets = tokenizer._regex_arrays(doc, None)
n = int(batch.attention_mask.sum()) - 2
index = VerbatimIndex(
    dense_provider=HashedBowDenseProvider(), sparse_provider=HashedSparseProvider(), device="cpu",
    enable_full_text=True, full_text_vocab=4096,
)
index.add_documents([DocumentSchema.from_file(str(p)) for p in sorted(Path("examples/example_docs").glob("*.md"))])
hits = index.query_batch(["solar panels", "wind"], k=3, hybrid_weights={"dense": 1.0, "sparse": 1.0, "full_text": 1.0})
maps = Path("/proc/self/maps").read_text()
print(json.dumps({
    "tokens": n,
    "same_ids": bool(np.array_equal(batch.input_ids[0, 1 : n + 1], ids)),
    "same_offsets": batch.offsets[0][1 : n + 1] == [tuple(o) for o in offsets.tolist()],
    "tokenize_calls": native.tokenize_calls,
    "analyze_calls": native.analyze_calls,
    "hits": [len(r) for r in hits],
    "library_in_build": str(native.library_path()).startswith(build) and native.library_path().exists(),
    "native_dir_loaded": "libverbatim_host" in maps,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "reference": sorted(m for m in sys.modules if m == "verbatim_rag_tpu" or m.startswith("verbatim_rag_tpu.")),
}))
"""

GROUP = """
import json, sys
import torch
from verbatim_rag_tpu_torch.parallel import distributed, make_mesh
from verbatim_rag_tpu_torch.parallel import sharded_search as ss

assert distributed.initialize() is True
mesh = make_mesh(dp=1, tp=2, devices=["cpu"] * 2)
g = torch.Generator().manual_seed(0)
n, d, m = 1024, 16, 8
dense = torch.nn.functional.normalize(torch.randn(n, d, generator=g), dim=1)
sketch = torch.randn(n, 32, generator=g)
ids = torch.stack([torch.randperm(300, generator=g)[:m] + 1 for _ in range(n)]).int()
w = torch.rand(n, m, generator=g) + 0.1
mask = torch.ones(n, dtype=torch.bool)
q = torch.nn.functional.normalize(torch.randn(4, d, generator=g), dim=1)
q_ids, q_w, sq = ids[:4, :4].contiguous(), w[:4, :4].contiguous(), sketch[:4] + 0.1
place = lambda x: ss.shard_rows(x, mesh)
scores, rows = ss.sharded_hybrid_topk(
    place(dense), place(sketch), place(ids), place(w), q, sq, q_ids, q_w, k=5, fetch_k=10, depth=64,
    mask=place(mask), mesh=mesh,
)
dense_rows = ss.sharded_dense_topk(place(dense), q, 5, place(mask), mesh)[1]

# The SP group path: one extraction over a global mesh of both ranks' devices.
from verbatim_rag_tpu_torch.models import ModelSpanExtractor
from verbatim_rag_tpu_torch.models.config import tiny_test_config
from verbatim_rag_tpu_torch.parallel import exchange
sp_mesh = distributed.global_mesh(dp=1, tp=4, devices=["cpu"] * 2)
config = tiny_test_config(position_embedding_type="rope", norm_location="pre", activation="geglu", use_bias=False,
                          final_norm=True, type_vocab_size=0, global_attn_every_n_layers=2,
                          local_attention_window=16, max_position_embeddings=1024)
extractor = ModelSpanExtractor(config=config, seed=0, sp_mesh=sp_mesh, threshold=0.0, min_span_chars=1, device="cpu")
context = " ".join(f"word{i} noteworthy item{i}." for i in range(40))
print(json.dumps({
    "rank": distributed.process_index(),
    "rows": rows.tolist(),
    "dense_rows": dense_rows.tolist(),
    "gathers": ss.gathers,
    "spans": extractor.process("what is noteworthy?", context),
    "context": len(context),
    "sp_line": [sp_mesh.line("tp").first, sp_mesh.line("tp").count],
    "handoffs": exchange.handoffs,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "reference": sorted(m for m in sys.modules if m == "verbatim_rag_tpu" or m.startswith("verbatim_rag_tpu.")),
}))
torch.distributed.destroy_process_group()
"""

IMPORT_ALL = """
import importlib, json, pkgutil, sys
import verbatim_rag_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({
    "modules": len(names),
    "jax": [m for m in sys.modules if m == "jax" or m.startswith("jax.")],
    "reference": [m for m in sys.modules if m.startswith("verbatim_rag_tpu.") or m == "verbatim_rag_tpu"],
}))
"""


def _run(code: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_main_path_loads_no_jax():
    result = _run(FLOW)
    assert result["jax"] == [] and result["reference"] == []
    assert result["docs"] > 0 and result["verbatim"]
    assert result["neural_chunks"] > 0 and result["neural_verbatim"]
    assert result["neural_batch_docs"] == [5, 5]
    assert result["int8_impl"] == "section" and result["int8_hits"] > 0
    assert result["narrow_hits"] > 0
    assert result["narrow_dtypes"] == ["torch.int16", "torch.float16", "torch.float32"]
    assert result["v1_shapes"] == [[3, 16], [3, 16], [3, 5]]
    assert result["train_loss"] > 0 and result["checkpoint_reloaded"]
    assert result["mesh_train_loss"] > 0 and result["single_process"]
    assert result["sp_rows"] == 1 and result["sp_whole"]
    assert result["mesh_hits"] == [3, 3] and result["mesh_shards"] == ["RowSharded", 4]


def test_persistence_and_cli_load_no_jax():
    """A full-text index saved, loaded and queried 3-way, then the CLI's
    ``index`` and ``query`` on the CPU, in a fresh interpreter: no ``jax``
    and no ``verbatim_rag_tpu`` module gets loaded."""
    result = _run(PERSIST)
    assert result["jax"] == [] and result["reference"] == []
    assert result["same_rows"] and result["cli_indexed"] and result["cli_verbatim"]


def test_http_server_answers_without_jax():
    """The port's server started from a saved index on the CPU answers one
    ``/api/query`` over a socket; no ``jax`` and no ``verbatim_rag_tpu``
    module gets loaded."""
    result = _run(SERVE)
    assert result["jax"] == [] and result["reference"] == []
    assert result["status"] == 200 and result["docs"] == 5 and result["verbatim"]
    assert result["device"] == "cpu"


def test_checkpoints_extractors_and_rerank_load_no_jax():
    """HF conversion both ways, the sentence extractor and a reranked query
    (query, batch, async, stream) in a fresh interpreter: no ``jax`` and no
    ``verbatim_rag_tpu`` module gets loaded."""
    result = _run(CHECKPOINTS)
    assert result["jax"] == [] and result["reference"] == []
    assert result["hf_class"] == "ModelSpanExtractor" and result["hf_tokenizer"] == "HFTokenizer"
    assert result["hf_whole"] and result["hf_same_weights"]
    assert result["sentence_class"] == "SentenceModelExtractor" and result["sentence_verbatim"]
    assert result["reranked_docs"] == 4 and result["batch_equal"] and result["async_equal"]
    assert result["stream_stages"] == ["retrieve", "rerank", "extract", "highlight", "template"]


def test_group_search_runs_without_jax():
    """Two gloo processes search the rows they share (`sharded_search`'s
    group path: each rank's block, pair ``all_gather``\\ s, RRF on every
    rank) and extract spans over a global SP mesh of both ranks' devices
    (`distributed.global_mesh`: two shards a rank, ring and halo hand-offs
    across them): both return the same rows, from both halves of the index,
    and the same spans, and neither loads a ``jax`` or ``verbatim_rag_tpu``
    module."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-c", GROUP], cwd=REPO, env=dict(env, RANK=str(rank)),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)
    ]
    try:
        outputs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in outputs]
    results = [json.loads(out.strip().splitlines()[-1]) for out, _ in outputs]
    assert [r["rank"] for r in results] == [0, 1]
    for r in results:
        assert r["jax"] == [] and r["reference"] == []
        assert r["gathers"] == 3 and r["rows"] == results[0]["rows"]
        assert r["spans"] == [[0, r["context"]]] and r["handoffs"] > 0
    assert [r["sp_line"] for r in results] == [[0, 2], [2, 2]]
    rows = {x for row in results[0]["rows"] + results[0]["dense_rows"] for x in row if x >= 0}
    assert min(rows) < 512 <= max(rows)


def test_every_port_module_imports_without_jax():
    result = _run(IMPORT_ALL)
    assert result["modules"] >= 40
    assert result["jax"] == [] and result["reference"] == []


def test_doc_path_runs_without_jax():
    """HTML pages through `process_directory`, a page through
    `DocumentSchema.from_url` (its ``http_get`` seam), dense vectors from an
    `OpenAIEmbeddingProvider` served by a stub on 127.0.0.1, an int8 index
    saved and loaded, then `VerbatimDOC.process` and `stream_process` and
    `verbatim_enhance` over it: no ``jax`` and no ``verbatim_rag_tpu`` module
    gets loaded."""
    result = _run(DOC)
    assert result["jax"] == [] and result["reference"] == []
    assert result["pages"] == 2 and result["fetched"]
    assert result["provider"] == "OpenAIEmbeddingProvider" and result["impl"] == "section"
    assert result["spliced"] and result["citations"] > 0 and result["stream_done"]
    assert result["enhanced_docs"] == 2


def test_host_scanner_runs_without_jax():
    """A fresh interpreter builds the port's host library into its own
    directory (never `native/`), tokenizes a ≈ 22.8k-token ASCII document
    through the scanner (ids and offsets equal to the regex loop) and
    ingests and queries full text through the batch analyzer: no ``jax``
    and no ``verbatim_rag_tpu`` module gets loaded, nor the JAX package's
    library."""
    result = _run(NATIVE)
    assert result["jax"] == [] and result["reference"] == []
    assert result["tokens"] > 20000 and result["same_ids"] and result["same_offsets"]
    assert result["tokenize_calls"] >= 1 and result["analyze_calls"] >= 2
    assert result["hits"] == [3, 3]
    assert result["library_in_build"] and not result["native_dir_loaded"]
