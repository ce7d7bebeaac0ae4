"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits nonzero; nothing is caught and passed over):

1. build   — compile every CUDA kernel from `verbatim_rag_tpu_torch/csrc`
             (one nvcc per source, started together); print the card's name
             and power limit, the build seconds, each kernel's registers and
             spilled bytes (`-Xptxas -v`) and the wgmma (HGMMA, IGMMA on
             int8), TMA load (UTMALDG) and mma.sync (HMMA, IMMA) instructions
             in the SASS of the wgmma kernels (`WGMMA_KERNELS`: the bf16 flash
             forward, partial and backward, each at head dims 64 and 32; the table walk's section and
             bucket-max v2 kernels on int8 and bf16 rows and its bucket-max v1
             kernel on bf16 rows; `cuobjdump -sass`): each must hold wgmma and
             UTMALDG, no mma.sync, and spill nothing; no kernel of the
             section library may hold mma.sync; the float32 table walk
             (`FMA_KERNELS`, its three modes) must hold UTMALDG and no
             tensor-core instruction (HGMMA, IGMMA, HMMA, IMMA: never TF32)
             and spill nothing, and the rescore kernel must spill nothing;
             then the port's C++ host runtime (`csrc/host/`, g++ with the JAX
             package's `native/Makefile` flags; `engine/native.py`): the
             compiler's version and the build seconds;
2. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes, with timings, bounds and the library
             yardstick:
             flash attention, ModernBERT-base heads (B=8, H=12, D=64, bf16),
             S ∈ {512, 777, 4099, 8192} (777 and 4099 off the kernels'
             64- and 128-row tiles), global and window=128, ragged lengths with a
             zero-length row; each live attention row (b, q, h) held to its
             own scale: max|out − plain| over D within 2e-2 of max|plain|
             plus half a bf16 ulp of that max (both round probabilities to
             bf16, at different points, and the output is bf16). At S=8192
             global two planted faults (the last key tile dropped, one row's
             length mask dropped) must fail that check; the forward's D=32 arm
             at the providers' shape (B=64, H=12, D=32, bf16, global, S ∈
             {256, 200}, ragged lengths with a zero-length row) held the same
             way, with the same two planted faults at each S;
             exact rescore at B=512, C=256, m=128, qm=32 over a 1M-row
             forward index with missing (−1) candidates, int32/float32 and
             int16/float16 slots; rtol 1e-5, −1e30 exactly where missing;
             three planted faults (every candidate row shifted by one; each
             query's last live term dropped; the int16/float16 index with
             its weights zeroed past slot m/2) must fail that check; the
             same at the BM25 arm's width (m=256 int32/float32 slots over
             2^17 ids, qm=64), with the weights zeroed past m/2 as its third
             fault;
             section tables (both arms, dense 384 + sketch 768) and
             bucket-max v2 (each arm) at B=512 over N=1,007,616 rows (blocks
             of 8192; int8, bf16 and float32 rows) and N=1,048,576 (blocks
             of 16384; int8 and bf16), dead rows in the mask: int8 tables
             bit-equal to the plain version; bf16 and float32 values within
             2⁻¹⁵·|q| and each differing row a winner whose exact score is
             within that of the plain one's; on v2's int8, bf16 and float32
             dense arms at N=1,007,616 two planted faults (the mask ignored;
             the last position of each block dropped) must fail that check,
             and on the section kernel at the same shape three (the mask
             ignored; the last position dropped; arm 1 reading arm 0's
             rows); the 3-way section launch (three int8 arms: dense 384,
             SPLADE sketch 768, BM25 sketch 768) at N=1,007,616, bit-equal,
             with one planted fault (arm 2 reading arm 1's rows) and
             `torch._int_mm` of the three products as its yardstick; section
             calls that mix row kinds (int8 + float32, bf16 + int8, three
             bf16 arms of 64, 384 and 768 columns) at N=32,768, a ragged
             batch of 300, each arm held to the plain version;
             bucket-max v1 (128 consecutive rows a bucket, highest-lane
             argmax) on bf16 and float32 rows at B=512, N=999,424, d ∈ {384,
             768} and at one block (N=16384, a ragged batch of 70), dead rows
             and a dead bucket: values within 2⁻¹⁵·|q| (bf16) / 2⁻¹⁸·|q|
             (float32), rows equal except in buckets whose two best plain
             scores lie within that; on small-integer rows with duplicates
             (exact dots) values and rows bit-equal; two planted faults (the
             mask ignored; ties to the lowest lane) must fail that check;
             the wgmma walk's streamed arms (rows past 2944 bytes: int8
             d ∈ {3072, 4096}, bf16 d = 1536) at B=512, N=1,048,576: section
             tables one arm a width, then two arms of a kind and a call
             mixing a resident 768-byte int8 arm with a streamed 3072-byte one
             at B=32 (two launches), each with the three section faults,
             bucket-max v2 with its two faults and v1 (bf16)
             with the mask-ignored fault, each against its plain version
             (int8 bit-equal), timed beside its bound and the product alone;
3. flow    — the offline quickstart through the user entry points:
             `VerbatimIndex.add_documents` on `examples/example_docs` with the
             hashed providers, then `VerbatimRAG.query` with the full-width
             ModernBERT-base extractor (22 layers, random weights from the
             seed) for 3 questions, over a bf16 index, an int8 index (the
             section path) and a float32 index with an int16 / float16
             forward index (`candidate_impl="section"`, then `"bucket"`: the
             float32 table arms and the narrow rescore must launch); every
             highlight must index its chunk verbatim, every store tensor and
             parameter must be on the card;
3a. serve  — `benchmarks/bench_serving.py`'s path without HTTP: the
             repo's markdown (root, docs/, benchmarks/, examples/) repeated 16
             times, ingested with `VerbatimRAG.add_documents_batch` through
             `JaxDenseProvider(max_length=256, batch_size=64)` and
             `JaxSpladeProvider(max_length=256, batch_size=32, max_nnz=64)`
             (MiniLM width, 12 × 32 heads, `use_flash_attention=True`: the
             flash forward at D=32 — MiniLM's own config leaves it off and
             runs plain attention; random weights from the seed) into a bf16
             hybrid store; `warmup` (it
             must launch the flash forward at both head dims and log no
             failure); 64 questions through `query_batch` (median of 5 after
             one untimed call, its peak device memory printed; the flow
             extractor's width and seed at `SERVE_LAYERS` of its 22 layers,
             8192-token windows), each response's
             retrieved chunks, highlights and answer equal to `query`'s for
             the question; 8 concurrent `query_async` calls, each equal to
             `query`; then the card's provider encodings of 512 chunk
             texts held to the same weights on the CPU (tolerances at
             `SERVE_DENSE_ATOL`), one `query_batch` split into encode,
             retrieve, extract and template by synchronized host timers, and
             one under `torch.profiler`;
3c. http   — the port's server (`verbatim_rag_tpu_torch.api.app.create_app`
             with the static `frontend/` mount, aiohttp on 127.0.0.1, port 0,
             `API_DEBUG_TRACE=1`, micro-batches of up to 64) over the serve
             phase's RAG (`dependencies.set_rag`), its warm-up awaited: status,
             documents and templates; the 64 questions as concurrent
             `/api/query` calls bracketed by `/api/debug/trace` start/stop,
             each answer (chunks, highlights, text) equal to `query`'s, fewer
             micro-batches than requests, requests/s, p50/p99 latency, the
             card's busy ms from the trace and the idle share printed; two
             NDJSON streams (events documents → progress → highlights →
             answer, the answer equal to `query`'s; times to the documents and
             answer events); `/api/query_async`; `/api/transform/verbatim`
             over three retrieved chunks (their highlights equal to `query`'s);
             four probes (400, 400, 400, 404, each with the CORS header); then
             a fresh server that loads the saved index from `INDEX_PATH` and
             warms up: same chunk count, one answer equal to `query`'s. No
             warning may be logged; the flash forward at D=64 and D=32 and the
             rescore must launch. The server's default extractor is the serve
             phase's (see `run_http`);
3d. doc    — the serve corpus written as 368 HTML pages (`markdown_page`),
             364 read by `DocumentProcessor.process_directory` and 4 fetched
             from a server on 127.0.0.1 (`DocumentSchema.from_url`,
             `process_url`; each equal to its file converted); an int8 index
             (dense 3072 and sketch int8, "auto" → section: int8 rows of
             3072 bytes, the wgmma walk's streamed arm) whose dense vectors
             come from `OpenAIEmbeddingProvider("text-embedding-3-large")`
             against a stub `/v1/embeddings` on the same server
             (`HashedBowDenseProvider(3072)`'s vectors), its store tensors
             bit-equal and its `query_batch` answers equal to an index built
             from those vectors directly; `VerbatimDOC.process` of a
             64-directive report (a header a serve topic, two `k` values:
             exactly two `query_batch` calls, timed by CUDA events, with 2
             section launches, both streamed, 2 rescores and flash ones;
             the first section call, as recorded, run again and held
             bit-equal to the plain tables, with two planted faults),
             each directive's spans those of `query("<section>: <question>",
             k)`, the splice and numbering those `Replacer` builds from those
             answers (the `query` calls of one `stream_process`, which must
             end in the same document); `verbatim_enhance` around
             `IndexProvider.retrieve` answering 8 questions as
             `VerbatimTransform.transform` does. The launches reported are
             those of the main path's runs (ingest, process, stream_process,
             enhance), each counted from zero; the stub's seconds and the
             idle share of the report's first batch under `torch.profiler`
             printed. The serve phase's extractor (full width,
             `SERVE_LAYERS` layers) answers;
3b. bucket_ab — the port's counterpart of `benchmarks/bench_fused_bucket.py`:
             candidate top-k (k=256) of 512 unit queries over 999,424 normal
             bf16 rows at d ∈ {384, 768} by exact top-k over the score
             matrix, v1 (`fused_candidate_topk`) and v2
             (`fused_candidate_topk_v2`, both variant names): each arm's
             median ms (CUDA events, 10 calls) and its candidate overlap with
             the exact set; a bucket kernel below 0.95 fails;
4. store   — a 1M-chunk store (dense 384 bf16, sketch 768, forward index
             128 nnz) filled through `add_vectors`, then 512-query hybrid
             batches through `query_batch`; rows checked against the same
             store with the plain rescore on every query (a query may differ
             only where its sparse arm's exact scores tie within 1e-6);
5. store_int8 — the same records in an int8 store (dense and sketch int8,
             `candidate_impl="auto"` → the section kernel), 8 timed batches,
             then `candidate_impl="bucket"` (a first batch and 2 timed
             ones, two bucket launches each); rows checked on
             every query against the same store with the plain table
             versions (int8 tables are bit-equal, so no difference is
             allowed);
5e. ragged — the int8 store at 300 dense columns (GloVe 6B's width:
             300 int8 bytes a row, which TMA cannot take as a row stride),
             the first 300 columns of the store phase's rows, sketch 768,
             "auto" → section, kept at a 16-byte row pitch: one 512-query
             batch (top-10, depth 256) held bit-equal (ids and scores) to a
             twin store of the same rows zero-padded to 304 columns; the
             batch's section launches (above 0), the corpus pointers the
             launch received (the store's own buffers: no corpus copied),
             its ms by CUDA events beside the twin's and store_int8's, the
             state GB of both. Then kernels 3, 6 and 7 at ragged widths at
             B=512, N=1,048,576 (`check_ragged_tables`: int8 300, bf16
             300, float32 301, and the streamed int8 3000 and bf16 1500;
             rows at the store's pitch, the aligned checks' planted faults,
             int8 bit-equal, each timed beside its bound, plain version and
             zero-padded aligned twin), and launches past the grid's 65,535
             rows on y (`check_grid_flash`: the flash forward, backward and
             partial at B=5,462, H=12, D=32, S=128, two launches each,
             timed beside SDPA with the boolean mask, its backward and the
             memory-efficient kernel with its logsumexp;
             `check_grid_rescore`: B=65,600, C=16), each against its plain
             version with two planted faults on the split;
5a. int4   — the same records in an int4 store (dense 384 and sketch 768
             packed two codes a byte, `candidate_impl="auto"` → "xla": the
             rescore kernel, no table kernel), one batch and 8 timed by the
             host clock and CUDA events; rows checked against the same store
             with the plain rescore on every query (ties within 1e-6 as in
             the store phase); the stored codes and scales of 65,536 sampled
             rows bit-equal to a numpy quantization of the very float32 rows
             the flush quantized; the dense and sketch matrices' resident
             bytes beside the int8 store's, `torch.cuda.max_memory_allocated`
             and the top-10 overlap with the int8 store's section rows
             (reported, not gated); one batch over 3,997,696 records when
             four times the 1M fill is under 60 s;
5d. mesh   — `DeviceVectorStore(mesh=make_mesh(dp=2, tp=2, devices=[cuda] * 4),
             dense_dtype="int8", sketch_dtype="int8", block=4 * 8192)` over the
             same records, every array row-sharded in 4 shards on the one
             card (they run one after another: no scaling is measured). (a)
             "auto" → "xla": one batch and 8 timed, exactly one rescore
             launch per shard a batch, rows checked against the plain
             rescore as above, and against the unsharded int8 store with
             `candidate_impl="xla"`: the dense arm equal, and every query
             equal unless its sparse arm differs, where the mesh store's
             (each shard's own top-256 candidates, a superset) must score at
             least as high at each position; (b) "section": 4 section launches
             a batch, (c) "bucket": 2 v2 launches per shard a batch, each
             with one rescore per shard, rows equal to the same store with
             the plain tables, each shard's int8 section and v2 tables
             bit-equal to the plain version, no fallback logged; (d) a 3-way
             batch through the section path of a mesh store over the
             full_text phase's first 65,536 records (text included), at the
             full table depth, equal to the unsharded section store's except
             queries where an arm holds a tie; (e) 5% deleted by id,
             `compact()`, `save` → `load(path, mesh=...)`, and the unsharded
             store saved and loaded onto the mesh: rows and scores equal;
             (f) a `sparse_mode="exact"` mesh store at 196,608 rows, 64
             sparse-only queries equal to the unsharded scan's (ties within
             1e-6). Median batch ms by CUDA events, sharded and unsharded;
5f. processes — the sharded searches across processes
             (`parallel/sharded_search.py`'s group path, JAX's DCN path): 2
             worker processes on the one card joined in a gloo group (NCCL
             refuses two ranks on one device, so the CUDA pairs go through
             host memory), started after the build so that they load the
             built kernels; 1,048,576 rows in the store phases' shapes
             (dense 384 and sketch 768 int8 with row scales, a 128-slot
             forward index), each rank making its own 524,288 on the card
             from the seed and holding them in 2 positions
             (`shard_process_rows`); one 512-query batch, top-10, depth 256,
             through `sharded_hybrid_section_topk` (the section and rescore
             kernels), `sharded_hybrid_topk` on "xla" (the rescore kernel)
             and `sharded_dense_topk`, each once, 3 times by CUDA events and
             once with its pair all_gathers timed: scores and rows on every
             rank bit-equal to one process's 4-position `[cuda] * 4` mesh
             over the same rows (the mesh phase's layout), a planted fault
             (rank 1's global offsets shifted by a shard) failing that;
             launches and gathers per rank and program;
5b. full_text — the store phase's records with synthetic texts (16-64
             words drawn Zipf-like, weight r^-1.1, from a 30,000-word
             vocabulary; all from the seed) in an int8 store with
             `enable_full_text=True` (BM25: 256 terms a chunk over 2^17
             slots), "auto" → section: the ingest's seconds with the
             analyzer's share; 512-query 3-way batches (dense + sparse +
             4-12-word text queries, top-10), one untimed and 8 timed by the
             host clock and CUDA events, one section launch and two rescores
             a batch, every query's rows equal to the same store's with the
             plain table versions, a profiled batch; then 2 batches with
             `candidate_impl="bucket"` (three v2 launches a batch), also
             held to the plain tables. At 65,536 of the records (one
             flush): 5% deleted by id (no deleted id returned; document
             frequencies drop by exactly those rows' terms), `compact()`
             (count; idf unchanged), `save` → `load(device="cuda")` (int8
             codes and a 3-way batch's rows and scores equal). At 196,608:
             a `sparse_mode="exact"` store, sparse-only and text-only
             batches of 64, 8 queries each held to a float64 numpy scoring
             (rows equal except where scores tie within 1e-6);
5c. cli    — `python -m verbatim_rag_tpu_torch.rag.cli index
             examples/example_docs --sparse --neural`, then `query ...
             --json`, each its own process on the card: every highlight
             verbatim, the retrieved chunks those of an in-process
             `VerbatimIndex.load` + `VerbatimRAG.query` (whose launches,
             the extractor's flash forward among them, are counted);
6. long    — one ~20k-token document through the full-width extractor
             (3 windows at S=8192 through all 22 layers); its tokenization
             must take the host scanner;
6b. long_sp — the same document and weights through
             `ModelSpanExtractor(sp_mesh=make_mesh(dp=1, tp=4, devices=[cuda] * 4))`:
             one row at S=24576 in 4 shards of 6144 on the one card, ring
             attention (the partial kernel, 4² launches) on the 8 global
             layers and halo attention (plain torch) on the 14 local ones:
             exactly 128 partial launches, spans on token boundaries, token
             probabilities within 1e-2 of the single-device forward's on the
             same row (one window at S=24576, the flash forward kernel: both
             round P and the attention output to bf16, at different points),
             spans equal unless a probability lies within 1e-2 of the
             threshold;
6c. sp_processes — the same document and weights across processes: 2
             worker processes on the one card joined in a gloo group (as
             phase 5f: NCCL refuses two ranks on one device, so every
             hand-off is staged through host memory), each holding 2
             positions of a `distributed.global_mesh(dp=1, tp=4, devices=[cuda] * 2)`
             (one ring hand-off inside a rank, one across), each building
             the long extractor's weights from the seed and running
             `ModelSpanExtractor(sp_mesh=<global mesh>)` once untimed and
             once timed: its 2 shards of 6144, K/V handed to the other rank
             by `exchange.ring_shift`, halos by `exchange.halo_swap`, the
             probability shards gathered in axis order; exactly 64 partial
             launches a rank (8 global layers × 2 shards × 4 steps), no
             forward launch; probabilities bit-equal to phase 6b's
             one-process pass on the same row (or, failing that, within
             `SP_PROBS_ATOL`, the largest difference printed), spans equal
             on both ranks and to phase 6b's unless a probability lies
             within that of the threshold; each rank's seconds, hand-offs
             and their host ms;
7. train   — the token highlighter at full ModernBERT-base width trained
             through `Trainer` with the CLI defaults (batch 8, max_seq_length
             4096: synthetic examples of 2.2k-4k tokens, so every batch pads
             to 4096 with ragged rows), 4 optimizer steps; every loss and
             gradient norm finite, the parameters changed, no batch skipped
             for OOM, 22 forward (lse), 22 dq and 22 dk/dv launches a step;
             then the saved checkpoint is served by
             `ModelSpanExtractor(model_path=...)` on the card (its token
             probabilities equal the trained model's, every span verbatim);
7a. train_mesh — the same weights and batches through
             `Trainer(mesh=make_mesh(dp=2, tp=2, devices=[cuda] * 4))` (each
             shard 6 heads and a quarter of every batch's rows, 4 shards in
             turn on the one card; each of the 4 positions holds its slices,
             its copies of the replicated parameters, their gradients and
             AdamW state as resident leaves, the unsharded module on the
             host), 3 steps: step 1 on a batch whose rows are
             ordered by live labels (dp shards with different counts) held to
             the single-device step on the same weights and batch: loss within
             `MESH_LOSS_RTOL`, every synced gradient before clipping per tensor
             and the global norm within `MESH_GRAD_RTOL` (`tensor_errors`),
             every updated parameter within `MESH_PARAM_RTOL`; four planted
             faults (wi's GEGLU output cut into contiguous blocks; the loss as
             the mean of the dp shards' means; a gradient sync that skips one
             copy; the global norm over every copy) must fail that check;
             every copy bit-equal to its owner after step 3; GB of leaves,
             gradients and AdamW state per position; 88 (22 × 4)
             forward-with-lse, dq and dk/dv
             launches each step; step seconds (median of steps 2-3),
             tokens/s, peak GB and a profiled step's idle share beside the
             train phase's single-device numbers; kernels 1, 4 and 5 at the
             phase's shapes (forward and backward at B=4, S=4096, H=6; the
             partial at the SP block) against their plain versions with
             times, bounds and library times; then `encoder_forward_sp` under
             grad on one row at S=8192 in 4 shards (128 partial launches in
             the forward; its backward is the plain VJP, as in JAX): every
             parameter's gradient, the input embedding's among them, within
             `SP_GRAD_RTOL` of the single-device flash backward's;
7d. tp_processes — tensor parallelism across processes: 2 worker
             processes on the one card in a gloo group, one position each
             of a `distributed.global_mesh(dp=1, tp=2, devices=[cuda])`, the
             train phase's width and weights from the seed, `token_loss`,
             2 steps at batch 2 × 1024 (synthetic examples of 600-950
             context tokens): rank 0 (the root) runs embeddings, norms and
             the residual stream, each rank its 6 heads (`FlashAttention`:
             kernels 1 and 4 at H=6) and half the MLP, the sublayer inputs
             broadcast and the partials gathered back through host memory
             (`exchange.TPRow`); step 1's loss, global norm and updated
             parameters held to a one-process `make_mesh(dp=1, tp=2,
             devices=[cuda] * 2)` step and to the single-device step with
             train_mesh's limits, loss and norm equal on both ranks, 22
             forward, 22 dq and 22 dk/dv launches a rank a step, step
             seconds and hand-offs a rank;
7c. train_d32 — the token highlighter at full MiniLM width with flash on
             (`minilm_config(use_flash_attention=True)`: hidden 384, 6
             layers, 12 heads of 32, absolute positions, post-LN, bf16; every
             layer global; random weights from the seed) through `Trainer`,
             4 steps at batch 8, S=512 on examples of 300-480 context tokens
             (ragged rows): step 1's loss and gradients held to the same step
             with the plain FA2 backward (`D32_LOSS_RTOL`, `D32_GRAD_RTOL`
             per tensor), with a planted fault (delta replaced by 0) that
             must fail; 6 forward (lse), 6 dq and 6 dk/dv launches a step,
             all at D=32; step seconds, peak GB and a profiled step's idle
             share; then its checkpoint served by
             `ModelSpanExtractor(model_path=..., sp_mesh=make_mesh(dp=1,
             tp=4, devices=[cuda] * 4))`: 4 contexts in one pass at S=512 in
             4 shards of 128 (every layer ring attention: 96 partial
             launches at D=32, no forward launch), probabilities within
             `SP_PROBS_ATOL` of the single-device extractor's on the same
             rows, spans on token boundaries and equal to its spans unless a
             probability lies within that of the threshold; then
             `run_sp_backward` at S=512 (500 live): every gradient within
             `SP_GRAD_RTOL` of the single-device flash backward's (which runs
             kernels 1 and 4 at D=32), 96 partial launches;
7b. checkpoints — checkpoints in and out, the other extractors and the
             rerank stage: the train phase's checkpoint staged by
             `utils.upload_to_hub.jax_checkpoint_to_hf_dir`, its config.json
             and model.safetensors alone with a WordPiece tokenizer.json
             trained here on the corpus's distinct chunks, served through the
             HF branch (`hf_convert.load_span_extractor`): weights and token
             probabilities equal the native checkpoint's exactly, 16 chunks'
             spans verbatim, the flash forward launched 22 times for each
             forward the windows predict; a sentence-head checkpoint at the
             same width (the seeded `init_qa_model_params`, saved by
             `Trainer`) served by `SentenceModelExtractor` over 64 distinct
             chunks: probabilities within 2e-2 (the flash checks' bf16 limit)
             of the same model through plain attention, kept sentences equal
             wherever no probability lies within that of the threshold, 22
             launches; then `VerbatimRAG(reranker=JaxReranker(JaxCrossEncoder(
             minilm_config(use_flash_attention=True)), rerank_k=50), k=50)`
             with the HF-loaded extractor over an index of the corpus's
             distinct chunks (one copy, through the serve phase's providers):
             `query_batch` of the 64 questions, one `query_async`, one stream
             (stages retrieve, rerank, ...), no warning logged (the
             reranker's catch never fired), each call given its question's
             50 distinct retrieved passages and each response in the order of
             the call's scores; against the same cross-encoder through plain
             attention: the flash forward on one call's own q/k/v ([50, 512,
             12, 32], every layer) row by row, with the kernels phase's
             planted faults failing it; the pooled state each score is read
             from within 2e-2 of each row's largest |value|; at most
             `CKPT_DISCORDANT_MAX` of a call's passage pairs ordered otherwise
             than by the plain scores; and a planted fault that hides the
             passages from the kernel failing both; 6 D=32 flash launches per
             scoring call; the rerank stage's wall time and, under
             `torch.profiler`, the card's busy time.

The kernels phase also holds the ring step's partial kernel (the
`flash_attention_partial` entry of `csrc/flash_attention.cu`) against its
plain version at the SP phase's block shape, B=2, Sq=Sk=6144, H=12, D=64,
bf16, lengths {22830, 7000}, k_offset ∈ {0, 6144, 12288, 18432} (blocks
fully live, partly live and, for row 1, dead): m within 1e-5·|m| + 1e-6 of
the plain version's, l within 1e-4 relative (both sum the unrounded P), the
numerator per live row as the forward's rows (the kernel rounds P to bf16
for P·V, the plain version keeps it float32), dead rows exactly (-1e30, 0,
0). Two planted faults (k_offset ignored; the last key tile dropped) must
fail that check. Its times are taken at the main path's shape (B=1), beside
SDPA and the memory-efficient attention kernel with its logsumexp (the
library yardstick: (o, lse) carries what (numer, m, l) carries). Its D=32
arm is held the same way at the train_d32 phase's SP block (B=1,
Sq=Sk=128) and at 2048, one row of 3.5 blocks less 3 tokens, every
k_offset of a 4-shard ring, the same two planted faults on each block, and
timed at 128². Each timed case also reports the exps' own bound
(`exp_bound_ms`: one exp a live pair and head at 16 a clock per SM).

The kernels phase also holds the flash backward (`csrc/flash_attention_bwd.cu`)
and the forward's logsumexp output against their plain versions at
B=8, H=12, D=64, bf16, S ∈ {512, 777, 4096, 4099, 8192}, global and
window=128, with the forward's ragged lengths: lse within 1e-4 + 1e-5·|lse| of the plain
version's; dq, dk and dv each live row (b, row, h) within 2e-2 of
max(max|plain| over D, 1e-3 of the tensor's largest row) plus half a bf16
ulp of the row's max (P and dS are rounded to bf16 for the second products;
the floor covers rows where one key takes all the weight, dP − delta
cancels and the true gradient is 0). At S=8192 global two planted faults
(the dk/dv kernel run without each row's last key tile; delta replaced by 0)
must fail that check. A second backward call must give bit-equal gradients
(no atomics). Each case reports the least work (10·D FLOP a live pair and
head, the bound's count), the work of the dq + dk/dv split (14·D) and the
exps' own bound (`exp_bound_ms`). The D=32 arm is held the same way at
S ∈ {512, 4096} (the train_d32 phase's S=512 its headline), global and
window=128, the planted faults at S=4096 global.

The host scanner (`engine/native.py`, the C++ host runtime under the hash
tokenizer and the BM25 analyzer; no device code): phases long, serve and
full_text count its calls on their main path (the tokenizer's scans; in
full_text every one of the 1M texts at ingest and one analyzer call a text
batch) and must find them above 0. Each then holds it, on the phase's own
texts (the long document, the serve corpus's chunk texts, the first 65,536
full_text texts), against the Python paths it replaces, each called
directly: the scan's ids and offsets bit-equal to the regex loop's on every
ASCII text, the batch analyzer's slots, counts, offsets and lengths equal to
its plain numpy version's, with host ms of both beside the phase's wall,
kernel ms and idle share (one JSON line `host_runtime` before the card's
name).

Each main-path phase (3-7, 3a-3d, 5a-5f, 6b-6c, 7a-7d) sets the kernels' launch counts to 0 just
before it and reads them just after; a kernel of the path launched no time fails.
Phases 4-7 and 6b then run one more call under `torch.profiler` (store_int8 one
batch of each candidate path) and print the
kernels that took the most device time and the device's idle share.
The last lines are the card's name and power limit, one JSON object with a
row per kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM published peaks (dense): bf16 and int8 tensor cores, FP32 CUDA
#: cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

#: The store phase's serving point (`bench.py`'s): 1M chunks, 8 timed batches.
STORE_ROWS = 1_000_000
STORE_BATCHES = 8
#: Timed batches the int8 store runs with candidate_impl="bucket" (after a
#: first, checked one).
BUCKET_BATCHES = 2

#: bf16 flash checks: per-row relative limit (see `row_check`).
FLASH_RTOL = 2e-2
#: Sequence lengths of the forward and backward checks: the main path's
#: shapes (encoder windows up to 8192, the train phase's 4096) and two that
#: are not a multiple of the kernels' 64- and 128-row tiles (the TMA edge).
FLASH_SEQS = (512, 777, 4099, 8192)
FLASH_BWD_SEQS = (512, 777, 4096, 4099, 8192)
#: The forward's checks per head dim: 64 at ModernBERT-base's heads (B=8,
#: H=12) and the extractor's windows, global and window=128, the planted
#: faults and the headline at S=8192 global; 32 at the providers' shape
#: (MiniLM's 12 × 32 heads, `max_length=256`, a dense batch of 64: 256 the
#: providers' padded length, 200 off the 128-row tiles), global, the planted
#: faults at both lengths. ``reps``: timed calls of the kernel, the plain
#: version and SDPA.
FLASH_CASES = {
    64: dict(batch=8, heads=12, seqs=FLASH_SEQS, windows=(None, 128), faults=(8192,),
             headline=8192, reps=(5, 2, 3)),
    32: dict(batch=64, heads=12, seqs=(256, 200), windows=(None,), faults=(256, 200),
             headline=256, reps=(50, 5, 20)),
}
#: Kernels that must run on wgmma fed by TMA (the bf16 forward, partial and
#: backward; the table walk's section and bucket-max v2 kernels on int8
#: (ILb1E) and bf16 (ILb0E) rows, and its bucket-max v1 kernel on bf16 rows):
#: the build phase counts their HGMMA / IGMMA and UTMALDG instructions.
WGMMA_KERNELS = {
    "flash_attention": (
        "flash_fwd_wgmma_kernelILi64E", "flash_fwd_wgmma_kernelILi32E",
        "flash_partial_wgmma_kernelILi64E", "flash_partial_wgmma_kernelILi32E",
    ),
    "flash_attention_bwd": (
        "flash_bwd_dq_wgmma_kernelILi64E", "flash_bwd_dkv_wgmma_kernelILi64E",
        "flash_bwd_dq_wgmma_kernelILi32E", "flash_bwd_dkv_wgmma_kernelILi32E",
    ),
    "section": (
        "bucket_v2_wgmma_kernelILb1E", "bucket_v2_wgmma_kernelILb0E",
        "section_wgmma_kernelILb1E", "section_wgmma_kernelILb0E", "bucket_v1_wgmma_kernel",
        "bucket_v2_streamed_kernelILb1E", "bucket_v2_streamed_kernelILb0E",
        "section_streamed_kernelILb1E", "section_streamed_kernelILb0E", "bucket_v1_streamed_kernel",
    ),
}
#: Libraries none of whose kernels may hold mma.sync (HMMA, IMMA): the table
#: kernels run on wgmma (int8, bf16) or on the CUDA cores (float32).
NO_MMA_SYNC = ("section",)
#: Kernels that must run on the CUDA cores fed by TMA: the float32 table walk
#: in its three modes (section, v2, v1). The build phase requires UTMALDG and
#: no tensor-core instruction (HGMMA, IGMMA, HMMA, IMMA: float32 dots are
#: never TF32) in their SASS, and no spill.
FMA_KERNELS = {
    "section": ("fma_walk_kernelILi0E", "fma_walk_kernelILi1E", "fma_walk_kernelILi2E"),
}
#: Kernels that must not spill, whatever they run on (every instance of a
#: template counts: the rescore has one per slot type).
NO_SPILL = ("rescore_kernel",)
#: The backward's checks per head dim (B=8, H=12, the forward's ragged
#: lengths, global and window=128): 64 at `FLASH_BWD_SEQS`, the planted
#: faults at S=8192 and the headline at the train phase's S=4096; 32 at the
#: train_d32 phase's S=512 (the headline) and at 4096 (many tiles), the
#: planted faults at 4096.
FLASH_BWD_CASES = {
    64: dict(seqs=FLASH_BWD_SEQS, faults=8192, headline=4096),
    32: dict(seqs=(512, 4096), faults=4096, headline=512),
}
#: Partial-kernel check: l's relative limit (float32 sums of the same P).
PARTIAL_L_RTOL = 1e-4
#: The partial's checks per head dim, each block at every k_offset of a
#: 4-shard ring: 64 at the long_sp block (B=2, Sq=Sk=6144, rows of 22,830
#: and 7,000 tokens: blocks live, partly live and dead); 32 at the train_d32
#: phase's SP block (B=1, Sq=Sk=128) and at 2048 (many tiles), one row of
#: 3.5 blocks less 3 (the last block partly live). ``headline``: the block
#: timed beside its bound (one row, every key live).
FLASH_PARTIAL_CASES = {
    64: dict(blocks=(6144,), lengths=lambda s: [22830, 7000], headline=6144),
    32: dict(blocks=(128, 2048), lengths=lambda s: [4 * s - s // 2 - 3], headline=128),
}
#: Exps the multi-function units of one SM return a clock (`ex2.approx`:
#: CUDA's throughput table for compute capability 9.0).
EXP_PER_SM_CLOCK = 16
#: The long_sp phase: shards on the one card, and the largest difference
#: allowed between its token probabilities and the single-device forward's.
SP_SHARDS = 4
SP_PROBS_ATOL = 1e-2


def log(*parts) -> None:
    print(*parts, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms (CUDA events around ``reps`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int, kernel: str) -> tuple[float | None, int]:
    """(mean device time in ms, records) of the kernels whose name holds
    ``kernel``, from ``torch.profiler`` around ``reps`` calls of ``fn``
    (after one warm-up call): the kernel's own time, where `cuda_ms` of a
    kernel shorter than its wrapper's host time measures the host. The
    profiler may miss launches in its window, so a window with fewer than
    ``reps`` records is taken again, up to four windows, and the fullest
    kept. A mean over fewer than ``reps // 2`` records is not reported: the
    time is then None ("not measured") and the records stand beside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = (0.0, 0)
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [
            e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and kernel in e.key
        ]
        count = sum(e.count for e in rows)
        require(count <= reps, f"{kernel}: {count} device records for {reps} calls")
        if count > best[1]:
            best = (sum(e.self_device_time_total for e in rows), count)
        if count == reps:
            break
    total_us, count = best
    if count < reps // 2:
        log(f"{kernel}: the profiler saw {count} of {reps} launches in four windows; device time not measured")
        return None, count
    return total_us / 1e3 / count, count


def device_profile(fn, top: int = 8) -> dict:
    """Run ``fn`` once under ``torch.profiler``: wall ms, summed kernel ms,
    idle share of the device, and the kernels that took the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [  # kernels only: an op's row repeats the time of the kernels it launched
        (e.key, e.count, e.self_device_time_total / 1e3)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    return dict(
        wall_ms=wall_ms,
        kernel_ms=busy_ms,
        idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
        top=[dict(kernel=k[:90], calls=c, ms=ms) for k, c, ms in rows[:top]],
    )


def bound(bytes_moved: float, ops: float, op_rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def exp_bound_ms(exps: float) -> float:
    """Least time of ``exps`` exponentials on the multi-function units:
    `EXP_PER_SM_CLOCK` a clock on each SM at the card's largest SM clock
    (`nvidia-smi`'s clocks.max.sm)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    clock_hz = float(out.stdout.strip().splitlines()[0]) * 1e6
    rate = torch.cuda.get_device_properties(0).multi_processor_count * EXP_PER_SM_CLOCK * clock_hz
    return exps / rate * 1e3


# -- phase 1: build ---------------------------------------------------------------------


def kernel_name(mangled: str) -> str:
    """The kernel's own name inside a mangled symbol: the last of its
    length-prefixed names (namespaces first), with a bool or int template
    flag."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group()
        start = pos + len(digits)
        name, pos = mangled[start : start + int(digits)], start + int(digits)
    flag = re.match(r"IL[bi]\d+E", mangled[pos:])
    return name + (flag.group() if flag else "")


def ptxas_report(log_text: str) -> dict:
    """``{kernel: {"registers": n, "spill_bytes": n}}`` from ``-Xptxas -v``.
    Instances of a template that `kernel_name` does not tell apart (the
    rescore's slot types) merge: the most registers, the most spilled."""
    report, current = {}, None
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = kernel_name(entry.group(1))
            report.setdefault(current, {"registers": None, "spill_bytes": 0})
            continue
        if current is None:
            continue
        info = report[current]
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            info["spill_bytes"] = max(info["spill_bytes"], int(spill.group(1)) + int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            info["registers"] = max(info["registers"] or 0, int(used.group(1)))
    return report


#: SASS instructions counted per kernel: wgmma on floating-point (HGMMA)
#: and integer (IGMMA) operands, the TMA tile load (UTMALDG), and mma.sync
#: on floating-point (HMMA) and integer (IMMA) operands.
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "HMMA", "IMMA")


def sass_counts(library: Path) -> dict:
    """``{kernel: {op: n for op in SASS_OPS}}``: instructions in the
    library's SASS (`cuobjdump -sass`)."""
    from verbatim_rag_tpu_torch.ops import cuda_build

    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(tool), "-sass", str(library)], capture_output=True, text=True, check=True, timeout=300
    ).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            current = kernel_name(func.group(1))
            counts[current] = dict.fromkeys(SASS_OPS, 0)
        elif current is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[current][op] += 1
    return counts


def check_build(build_logs: dict) -> dict:
    """Print every kernel's registers and spills; require the wgmma kernels
    to spill nothing, to hold wgmma (HGMMA, or IGMMA on int8) and UTMALDG
    instructions, and no mma.sync (HMMA, IMMA); require no kernel of a
    `NO_MMA_SYNC` library to hold mma.sync; require the `FMA_KERNELS` to hold
    UTMALDG, no tensor-core instruction, and to spill nothing, and the
    `NO_SPILL` kernels to spill nothing."""
    from verbatim_rag_tpu_torch.ops import cuda_build

    result = {}
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                log(f"  {name}: {line.strip()}")
        for kernel, info in ptxas_report(text).items():
            log(f"  {name}: {kernel}: {info['registers']} registers, {info['spill_bytes']} bytes spilled")
            result[kernel] = dict(info)
    for name, kernels in WGMMA_KERNELS.items():
        counts = sass_counts(cuda_build._target(name))
        if name in NO_MMA_SYNC:
            for kernel, c in counts.items():
                mma_sync = c.get("HMMA", 0) + c.get("IMMA", 0)
                require(mma_sync == 0, f"{kernel}: mma.sync left in the {name} library {c}")
        for kernel in kernels:
            c = counts.get(kernel, {})
            log(f"  {name}: {kernel}: SASS {json.dumps(c)}")
            wgmma = c.get("HGMMA", 0) + c.get("IGMMA", 0)
            require(wgmma > 0 and c.get("UTMALDG", 0) > 0, f"{kernel}: no wgmma or no TMA load in its SASS {c}")
            require(c.get("HMMA", 0) + c.get("IMMA", 0) == 0, f"{kernel}: mma.sync left in its SASS {c}")
            if kernel in result:
                require(result[kernel]["spill_bytes"] == 0, f"{kernel} spills: {result[kernel]}")
            result.setdefault(kernel, {}).update(sass=c)
    for name, kernels in FMA_KERNELS.items():
        counts = sass_counts(cuda_build._target(name))
        for kernel in kernels:
            c = counts.get(kernel, {})
            log(f"  {name}: {kernel}: SASS {json.dumps(c)}")
            tensor_core = sum(c.get(op, 0) for op in ("HGMMA", "IGMMA", "HMMA", "IMMA"))
            require(tensor_core == 0, f"{kernel}: a tensor-core instruction in the float32 walk {c}")
            require(c.get("UTMALDG", 0) > 0, f"{kernel}: no TMA load in its SASS {c}")
            if kernel in result:
                require(result[kernel]["spill_bytes"] == 0, f"{kernel} spills: {result[kernel]}")
            result.setdefault(kernel, {}).update(sass=c)
    for kernel in NO_SPILL:
        if kernel in result:
            require(result[kernel]["spill_bytes"] == 0, f"{kernel} spills: {result[kernel]}")
    return result


# -- phase 2: kernels against their plain versions -------------------------------------


def attention_pairs(lengths, seq: int, window) -> int:
    """Unmasked (query, key) pairs: every query row of [0, S) against keys
    below its row's length and, on local layers, inside the band."""
    total = 0
    for n in lengths:
        n = int(n)
        if n <= 0:
            continue
        if window is None:
            total += seq * n
            continue
        half = window // 2
        q = range(seq)
        total += sum(max(0, min(n - 1, i + half) - max(0, i - half) + 1) for i in q)
    return total


def attention_rows(lengths, seq: int) -> tuple[int, int]:
    """Rows of [S, H, D] an attention call must move for ``lengths``: query
    rows of the batch rows with a live key (a row of length 0 is all zeros
    whatever its queries), and key rows below each row's length (k and v
    each). Outputs are written whole and counted by the caller."""
    q_rows = seq * sum(1 for n in lengths if int(n) > 0)
    kv_rows = sum(min(max(int(n), 0), seq) for n in lengths)
    return q_rows, kv_rows


def row_check(err, scale, live, floor: float = 0.0) -> tuple[float, float]:
    """Hold each live attention row (b, row, h) to its own scale.

    ``err`` and ``scale`` are [B, S, H]: max|out − plain| and max|plain| over
    D. A row's limit is FLASH_RTOL·max(scale, floor·M) plus half a bf16 ulp
    of its scale, with M the largest live scale of the whole tensor; an
    output element has std ≈ sqrt(e/n) for n live keys, so a flat limit
    would be loose on long rows. Returns (max abs error, worst error /
    limit) over the live rows."""
    import torch

    _, exponent = torch.frexp(scale)
    base = torch.clamp(scale, min=floor * float(scale[live].max()))
    limit = FLASH_RTOL * base + torch.ldexp(torch.ones_like(scale), exponent - 9)
    return float(err[live].max()), float((err / limit)[live].max())


def sdpa_mask(lens, seq: int, window):
    """[B, 1, S, S] boolean mask equivalent to the kernels' length and band
    masks, for the `scaled_dot_product_attention` yardstick."""
    import torch

    kidx = torch.arange(seq, device=lens.device)
    allowed = (kidx[None, None, :] < lens[:, None, None]).expand(lens.shape[0], seq, seq)
    if window is not None:
        allowed = allowed & ((kidx[:, None] - kidx[None, :]).abs() <= window // 2)[None]
    return allowed[:, None]


def flash_lengths(batch: int, seq: int) -> list[int]:
    """Ragged lengths of the forward checks: a full row, a zero-length row,
    a row of one key, rows off the tiles' edges, and for batches past 8
    random lengths below ``seq`` from a generator seeded by ``seq``."""
    import torch

    pattern = [seq, 0, seq // 2 + 3, 17, seq - 1, seq // 3, 1, seq][:batch]
    rest = torch.randint(2, seq, (batch - len(pattern),), generator=torch.Generator().manual_seed(seq))
    return pattern + [int(x) for x in rest]


def flash_faults(lens, seq: int, row: int) -> dict:
    """Planted faults the flash checks must catch, as the lengths the kernel
    is run with (each output is held to the true lengths): each row's last
    key tile dropped (rows longer than one tile), and ``row``'s length mask
    dropped."""
    import torch

    unmasked = lens.clone()
    unmasked[row] = seq
    return {
        "fault: last key tile dropped": torch.where(lens > 64, (lens - 1) // 64 * 64, lens),
        f"fault: row {row} length mask dropped": unmasked,
    }


def check_flash(gen, head_dim: int) -> dict:
    """The bf16 forward at ``head_dim`` (`FLASH_CASES`) against its plain
    version: each live row held to its own scale (`row_check`), the
    zero-length row exactly 0; at the fault lengths (global) two planted
    faults (each row's last 64-key tile dropped; row 2's length mask
    dropped) must fail the check. Times by events and, for the kernel, its
    device time, beside the plain version, SDPA and the bound."""
    import torch
    import torch.nn.functional as F

    from verbatim_rag_tpu_torch.ops import flash_attention as fa

    case_cfg = FLASH_CASES[head_dim]
    B, H, D = case_cfg["batch"], case_cfg["heads"], head_dim
    reps, plain_reps, library_reps = case_cfg["reps"]
    cases = []
    headline = None
    for seq in case_cfg["seqs"]:
        lengths = flash_lengths(B, seq)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q, k, v = (
            torch.randn(B, seq, H, D, generator=gen, device="cuda", dtype=torch.bfloat16)
            for _ in range(3)
        )
        live = torch.arange(seq, device="cuda")[None, :] < lens[:, None]
        for window in case_cfg["windows"]:
            outs = {"kernel": fa.flash_attention_cuda(q, k, v, lens, window)}
            if seq in case_cfg["faults"] and window is None:
                for name, fault_lens in flash_faults(lens, seq, 2).items():
                    outs[name] = fa.flash_attention_cuda(q, k, v, fault_lens, None)
            torch.cuda.synchronize()
            err = {name: 0.0 for name in outs}
            ratio = {name: 0.0 for name in outs}
            rows = 1 if seq > 1024 else B  # plain version per batch row at long S
            for b0 in range(0, B, rows):
                sl = slice(b0, b0 + rows)
                if not bool(live[sl].any()):
                    continue
                ref = fa.attention_reference(q[sl], k[sl], v[sl], lens[sl], window)
                scale = ref.abs().amax(dim=-1)
                for name, o in outs.items():
                    e, r = row_check((o[sl].float() - ref).abs().amax(dim=-1), scale, live[sl])
                    err[name], ratio[name] = max(err[name], e), max(ratio[name], r)
                del ref
            out, max_err, worst = outs.pop("kernel"), err.pop("kernel"), ratio.pop("kernel")
            what = f"flash D={D} S={seq} w={window}"
            require(bool((out[1] == 0).all()), f"{what}: zero-length row not 0")
            require(
                math.isfinite(worst) and worst <= 1.0,
                f"{what}: max abs err {max_err}, worst row at {worst} of its limit",
            )
            for name, r in ratio.items():
                require(r > 1.0, f"{what}: {name} passes the check ({r} of the limit)")
            del outs, out

            def kernel():
                return fa.flash_attention_cuda(q, k, v, lens, window)

            ms = cuda_ms(kernel, reps=reps)
            # The kernel's own time: where a call is as short as its wrapper's
            # host time, events around back-to-back calls measure the host.
            device_ms, _ = kernel_device_ms(kernel, 10, f"flash_fwd_wgmma_kernel<{D}>")

            def plain():
                for b0 in range(0, B, rows):
                    sl = slice(b0, b0 + rows)
                    fa.attention_reference(q[sl], k[sl], v[sl], lens[sl], window)

            plain_ms = cuda_ms(plain, reps=plain_reps)
            # Library yardstick: SDPA with the equivalent boolean mask ([B,H,S,D]).
            mask = sdpa_mask(lens, seq, window)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=library_reps
            )
            del qt, kt, vt, mask
            pairs = attention_pairs(lengths, seq, window)
            q_rows, kv_rows = attention_rows(lengths, seq)
            b_ms, b_by = bound(
                (q_rows + 2 * kv_rows + B * seq) * H * D * 2 + 4 * B, 4 * H * D * pairs, PEAK_BF16_FLOPS
            )
            case = dict(
                batch=B, heads=H, head_dim=D, seq=seq, window=window, max_abs_err=max_err,
                worst_row_of_limit=worst, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            )
            if ratio:
                case["planted_faults_worst_row_of_limit"] = ratio
            log("flash", json.dumps(case))
            cases.append(case)
            if seq == case_cfg["headline"] and window is None:
                headline = case
        del q, k, v
        torch.cuda.empty_cache()
    return dict(headline, cases=cases)


def check_flash_bwd(gen, head_dim: int) -> dict:
    """The forward's lse output and the FA2 backward kernels at ``head_dim``
    (`FLASH_BWD_CASES`) against their plain versions; planted faults at the
    fault length, global; times, bounds (with the exps' own bound beside
    them), SDPA."""
    import torch
    import torch.nn.functional as F

    from verbatim_rag_tpu_torch.ops import flash_attention as fa

    B, H, D = 8, 12, head_dim
    case_cfg = FLASH_BWD_CASES[head_dim]
    cases = []
    for seq in case_cfg["seqs"]:
        lengths = [seq, 0, seq // 2 + 3, 17, seq - 1, seq // 3, 1, seq]
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q, k, v, g = (
            torch.randn(B, seq, H, D, generator=gen, device="cuda", dtype=torch.bfloat16)
            for _ in range(4)
        )
        live = torch.arange(seq, device="cuda")[None, :] < lens[:, None]
        rows = 1 if seq > 1024 else B  # plain versions per batch row at long S
        for window in (None, 128):
            out, lse = fa.flash_attention_lse_cuda(q, k, v, lens, window)
            require(
                torch.equal(out, fa.flash_attention_cuda(q, k, v, lens, window)),
                f"flash lse S={seq} w={window}: out differs from the forward without lse",
            )
            delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            outs = {"kernel": fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g, window)}
            if seq == case_cfg["faults"] and window is None:
                # Planted faults the check must catch, each held to the true
                # lengths: the dk/dv kernel without each row's last key tile,
                # and both kernels with delta replaced by 0.
                cut = torch.where(lens > 64, (lens - 1) // 64 * 64, lens)
                dq_ok = outs["kernel"][0]
                _, dk_cut, dv_cut = fa._launch_bwd(q, k, v, cut, lse, delta, g, None, ("dkv",))
                outs["fault: last key tile dropped in dk/dv"] = (dq_ok, dk_cut, dv_cut)
                outs["fault: delta replaced by 0"] = fa._launch_bwd(
                    q, k, v, lens, lse, torch.zeros_like(delta), g, None
                )
            torch.cuda.synchronize()
            # Per-row errors and scales over D, gathered slice by slice: the
            # floor of the check is taken over the whole tensor.
            scales = torch.zeros((3, B, seq, H), device="cuda")
            errs = {name: torch.zeros_like(scales) for name in outs}
            lse_err = 0.0
            for b0 in range(0, B, rows):
                sl = slice(b0, b0 + rows)
                if not bool(live[sl].any()):
                    continue
                _, ref_lse = fa.attention_lse_reference(q[sl], k[sl], v[sl], lens[sl], window)
                lse_gap = (lse[sl] - ref_lse).abs() - 1e-5 * ref_lse.abs()
                lse_err = max(lse_err, float(lse_gap.max()))
                del ref_lse
                refs = fa.flash_attention_bwd_reference(
                    q[sl], k[sl], v[sl], lens[sl], out[sl], lse[sl], g[sl], window
                )
                for i, ref in enumerate(refs):
                    ref = ref.float()
                    scales[i, sl] = ref.abs().amax(dim=-1)
                    for name, grads in outs.items():
                        errs[name][i, sl] = (grads[i][sl].float() - ref).abs().amax(dim=-1)
                del refs
            err, ratio = {}, {}
            for name in outs:
                checks = [row_check(errs[name][i], scales[i], live, floor=1e-3) for i in range(3)]
                err[name] = max(c[0] for c in checks)
                ratio[name] = max(c[1] for c in checks)
            del scales, errs
            grads, max_err, worst = outs.pop("kernel"), err.pop("kernel"), ratio.pop("kernel")
            again = fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g, window)
            require(
                all(torch.equal(a, b) for a, b in zip(grads, again)),
                f"flash bwd D={D} S={seq} w={window}: two calls differ (the kernels must be deterministic)",
            )
            del again
            what = f"flash bwd D={D} S={seq} w={window}"
            require(lse_err <= 1e-4, f"flash lse D={D} S={seq} w={window}: error {lse_err} over 1e-4 + 1e-5·|lse|")
            require(all(bool((x[1] == 0).all()) for x in grads), f"{what}: zero-length row not 0")
            require(
                math.isfinite(worst) and worst <= 1.0,
                f"{what}: max abs err {max_err}, worst row at {worst} of its limit",
            )
            for name, r in ratio.items():
                require(r > 1.0, f"{what}: {name} passes the check ({r} of the limit)")
            del outs, grads
            dq_ms = cuda_ms(lambda: fa._launch_bwd(q, k, v, lens, lse, delta, g, window, ("dq",)), reps=3)
            dkv_ms = cuda_ms(lambda: fa._launch_bwd(q, k, v, lens, lse, delta, g, window, ("dkv",)), reps=3)
            wrapper_ms = cuda_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g, window), reps=3)

            def plain():
                for b0 in range(0, B, rows):
                    sl = slice(b0, b0 + rows)
                    fa.flash_attention_bwd_reference(q[sl], k[sl], v[sl], lens[sl], out[sl], lse[sl], g[sl], window)

            plain_ms = cuda_ms(plain, reps=1)
            # Library yardstick: the backward of SDPA with the equivalent boolean mask.
            mask = sdpa_mask(lens, seq, window)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            go = g.transpose(1, 2).contiguous()
            library_ms = cuda_ms(
                lambda: torch.autograd.grad(o, (qt, kt, vt), go, retain_graph=True), reps=3
            )
            del qt, kt, vt, o, go, mask
            pairs = attention_pairs(lengths, seq, window)
            q_rows, kv_rows = attention_rows(lengths, seq)
            # The bound counts the least work (five products: 10·D FLOP a
            # live pair and head); the dq + dk/dv split does seven (14·D).
            # Bytes: q, g, lse and delta of the live rows, k and v up to each
            # row's length, dq, dk and dv written whole. Beside it the exps'
            # own bound: one exp a live pair and head (p, the least work; the
            # split takes it twice), which at D = 32 weighs twice as much
            # against the products as at D = 64.
            b_ms, b_by = bound(
                (2 * q_rows + 2 * kv_rows + 3 * B * seq) * H * D * 2 + 2 * H * q_rows * 4 + 4 * B,
                10 * H * D * pairs,
                PEAK_BF16_FLOPS,
            )
            case = dict(
                head_dim=D, seq=seq, window=window, max_abs_err=max_err, worst_row_of_limit=worst,
                lse_max_excess=lse_err, ms=dq_ms + dkv_ms, dq_ms=dq_ms, dkv_ms=dkv_ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                exp_bound_ms=exp_bound_ms(H * pairs), exp_bound_by="one exp a live pair and head",
                library_ms=library_ms, least_gflop=10 * H * D * pairs / 1e9,
                split_gflop=14 * H * D * pairs / 1e9, deterministic=True,
            )
            if ratio:
                case["planted_faults_worst_row_of_limit"] = ratio
            log("flash_bwd", json.dumps(case))
            cases.append(case)
            del out, lse, delta
        del q, k, v, g
        torch.cuda.empty_cache()
    # Headline: the training path's shape, global layers.
    headline = next(c for c in cases if c["seq"] == case_cfg["headline"] and c["window"] is None)
    return dict(headline, cases=cases)


def check_flash_partial(gen, head_dim: int) -> dict:
    """The ring step's partial kernel at ``head_dim`` (`FLASH_PARTIAL_CASES`)
    against its plain version at every k_offset of a 4-shard ring over each
    block; planted faults on each block; times at the headline block (B=1,
    every key live) with bound, plain version and SDPA."""
    import torch
    import torch.nn.functional as F

    from verbatim_rag_tpu_torch.ops import flash_attention as fa

    case_cfg = FLASH_PARTIAL_CASES[head_dim]
    H, D = 12, head_dim

    def held(got, q, k, v, lens, offset) -> dict:
        """How the kernel's (numer, m, l) stand against the plain version's:
        the worst live row's error over its limit for each output, and
        whether every dead row is exactly (-1e30, 0, 0)."""
        numer, m, l = got
        ref_numer, ref_m, ref_l = fa.flash_attention_partial_reference(q, k, v, lens, offset)
        live = (lens > offset)[:, None, None].expand_as(m)  # [B, H, Sq]
        dead = ~live
        dead_exact = bool(
            (m[dead] == fa.NEG_INF).all() and (l[dead] == 0).all()
            and (numer.transpose(1, 2)[dead] == 0).all()
        )
        m_ratio = float(((m - ref_m).abs() / (1e-5 * ref_m.abs() + 1e-6))[live].max())
        l_ratio = float(((l - ref_l).abs() / (PARTIAL_L_RTOL * ref_l))[live].max())
        err, n_ratio = row_check(
            (numer - ref_numer).abs().amax(dim=-1), ref_numer.abs().amax(dim=-1), live.transpose(1, 2)
        )
        del ref_numer, ref_m, ref_l
        return dict(
            max_abs_err=err, numer_worst_row_of_limit=n_ratio, m_worst_of_limit=m_ratio,
            l_worst_of_limit=l_ratio, dead_rows_exact=dead_exact,
            worst=max(n_ratio, m_ratio, l_ratio),
        )

    def fails(h: dict) -> bool:
        return not h["dead_rows_exact"] or not (math.isfinite(h["worst"]) and h["worst"] <= 1.0)

    cases, faults = [], {}
    for S in case_cfg["blocks"]:
        lengths = case_cfg["lengths"](S)
        B = len(lengths)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q, k, v = (
            torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3)
        )
        for offset in (0, S, 2 * S, 3 * S):
            h = held(fa.flash_attention_partial_cuda(q, k, v, lens, offset), q, k, v, lens, offset)
            require(not fails(h), f"flash partial D={D} S={S} k_offset={offset}: {h}")
            live_keys = [max(0, min(S, n - offset)) for n in lengths]
            case = dict(head_dim=D, batch=B, seq_q=S, seq_k=S, k_offset=offset, live_keys=live_keys, **h)
            case["ms"] = cuda_ms(lambda: fa.flash_attention_partial_cuda(q, k, v, lens, offset), reps=10)
            log("flash_partial", json.dumps(case))
            cases.append(case)
        # Planted faults the check must catch, each held to the true offset:
        # the kernel run at k_offset 0 for the last block (partly live, or
        # dead for D = 64's row 1), and without the last key tile of the
        # first block.
        block_faults = {
            "fault: k_offset ignored": held(fa.flash_attention_partial_cuda(q, k, v, lens, 0), q, k, v, lens, 3 * S),
            "fault: last key tile dropped": held(
                fa.flash_attention_partial_cuda(q, k[:, : S - 64].contiguous(), v[:, : S - 64].contiguous(), lens, 0),
                q, k, v, lens, 0,
            ),
        }
        for name, h in block_faults.items():
            require(fails(h), f"flash partial D={D} S={S}: {name} passes the check ({h})")
            faults[f"{name} (S={S})"] = h
        log("flash_partial faults", json.dumps(block_faults))
        del q, k, v
        torch.cuda.empty_cache()

    # Times at the main path's shape: one row, a fully live block.
    S = case_cfg["headline"]
    q1, k1, v1 = (torch.randn(1, S, H, D, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    lens1 = torch.tensor([4 * S], dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: fa.flash_attention_partial_cuda(q1, k1, v1, lens1, 0), reps=20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_partial_reference(q1, k1, v1, lens1, 0), reps=3)
    # Library yardsticks with the same key mask: SDPA (the normalised output
    # alone), and the memory-efficient kernel with its logsumexp, (o, lse):
    # the information of (numer, m, l) up to a per-row rescale.
    live = torch.arange(S, device="cuda") < lens1[0]
    mask = live[None, None, None, :].expand(1, 1, S, S)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q1, k1, v1))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=10)
    library_ms, library_note = efficient_attention_ms(qt, kt, vt, live)
    del qt, kt, vt, mask, q1, k1, v1
    pairs = S * S
    b_ms, b_by = bound(
        3 * S * H * D * 2 + S * H * D * 4 + 2 * H * S * 4 + 4, 4 * H * D * pairs, PEAK_BF16_FLOPS
    )
    result = dict(
        head_dim=D, batch=1, seq_q=S, seq_k=S, heads=H, k_offset=0, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, exp_bound_ms=exp_bound_ms(H * pairs),
        exp_bound_by="one exp a live pair and head", library_ms=library_ms,
        library_note=library_note, sdpa_ms=sdpa_ms,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        worst_of_limit=max(c["worst"] for c in cases),
        planted_faults_worst_of_limit={n: h["worst"] for n, h in faults.items()},
        cases=cases,
    )
    log("flash_partial", json.dumps(result))
    torch.cuda.empty_cache()
    return result


def efficient_attention_ms(qt, kt, vt, live) -> tuple[float | None, str]:
    """Time of `aten::_scaled_dot_product_efficient_attention` with
    compute_log_sumexp=True on [B, H, S, D] inputs, the key mask ``live``
    ([Sk], or [B, Sk] a batch row) as an additive bias broadcast over rows
    and heads: (ms, note), or (None, why) where the library refuses the
    inputs."""
    import torch

    bias = torch.zeros(live.shape, dtype=qt.dtype, device=qt.device).masked_fill(~live, float("-inf"))
    bias = bias.reshape(-1 if live.dim() == 2 else 1, 1, 1, live.shape[-1])
    bias = bias.expand(qt.shape[0], qt.shape[1], qt.shape[2], live.shape[-1])
    op = torch.ops.aten._scaled_dot_product_efficient_attention
    try:
        ms = cuda_ms(lambda: op(qt, kt, vt, bias, True), reps=10)
    except RuntimeError as err:  # a yardstick, not a kernel of the port
        return None, f"efficient attention refused the inputs: {str(err).splitlines()[0]}"
    return ms, (
        "aten::_scaled_dot_product_efficient_attention(compute_log_sumexp=True), the key "
        "mask as bias: (o, lse), the same information as (numer, m, l) up to a per-row rescale"
    )


def rescore_inputs(gen, m: int = 128, qm: int = 32, vocab: int = 30522, batch: int = 512,
                   cands: int = 256):
    """The rescore's serving point: B=512 queries (``batch``) of ``qm`` terms,
    C=256 candidates each (``cands``; some missing, -1) over a 1M-row forward index of ``m``
    int32 / float32 slots (1-m live, pads id 0 / weight 0) over ``vocab``
    ids; half of each query's terms come from its candidate rows so that
    scores are not all 0. The defaults are the SPLADE arm's shape; the BM25
    arm's is m=256, qm=64 over 2^17 ids."""
    import torch

    B, C, N = batch, cands, 1_000_000
    sp_ids = torch.randint(1, vocab, (N, m), generator=gen, device="cuda", dtype=torch.int32)
    sp_w = torch.rand((N, m), generator=gen, device="cuda")
    nnz = torch.randint(1, m + 1, (N, 1), generator=gen, device="cuda")
    pad = torch.arange(m, device="cuda")[None, :] >= nnz
    sp_ids[pad] = 0
    sp_w[pad] = 0.0
    cand = torch.randint(0, N, (B, C), generator=gen, device="cuda", dtype=torch.int32)
    cand[:, -5:] = -1
    cand[::7, :20] = -1
    q_ids = torch.randint(1, vocab, (B, qm), generator=gen, device="cuda", dtype=torch.int32)
    src = cand[:, : qm // 2].clamp(min=0).long()
    q_ids[:, : qm // 2] = sp_ids[src, torch.arange(qm // 2, device="cuda")[None, :]]
    q_w = torch.rand((B, qm), generator=gen, device="cuda")
    return cand, sp_ids, sp_w, q_ids, q_w


def rescore_bound(cand, ids, w, qm: int) -> tuple[float, str]:
    """The rescore's bound, counted from this run's data: of each live
    candidate's row, the id and weight of every live slot (weight not 0) and
    the weight alone of every pad slot, which is enough to know it adds
    nothing; the candidate ids, the query terms and the scores; against a
    compare-select of each live slot with each query term on the CUDA
    cores."""
    valid = cand >= 0
    rows = cand[valid].long()
    live = int((w[rows] != 0).sum())
    pads = rows.numel() * w.shape[1] - live
    B, C = cand.shape
    row_bytes = live * (ids.element_size() + w.element_size()) + pads * w.element_size()
    return bound(row_bytes + B * C * 4 + B * qm * 8 + B * C * 4, live * qm, PEAK_FP32_OPS)


def rescore_fault(got, ref, valid) -> str | None:
    """Why a rescore does not hold to the plain version's, or None: -1e30
    exactly where the candidate is missing, elsewhere rel ≤ 1e-5."""
    if not bool(((got <= -1e29) == ~valid).all()) or not bool((got[~valid] == -1e30).all()):
        return "missing candidates differ"
    rel = ((got - ref).abs() / ref.abs().clamp(min=1e-6))[valid]
    if not bool((rel <= 1e-5).all()):
        return f"max rel err {float(rel.max())}"
    return None


def rescore_planted_faults(cand, ids, w, q_ids, q_w, ref, valid, faults) -> dict:
    """The kernel run on each planted fault's inputs (``faults``: name →
    (cand, ids, w, q_ids, q_w) changes), held to the true plain scores
    ``ref``: each must fail `rescore_fault`."""
    from verbatim_rag_tpu_torch.ops import rescore as rs

    found = {}
    for name, change in faults.items():
        args = dict(cand=cand, ids=ids, w=w, q_ids=q_ids, q_w=q_w)
        args.update(change())
        got = rs.exact_rescore_cuda(args["cand"], args["ids"], args["w"], args["q_ids"], args["q_w"])
        why = rescore_fault(got, ref, valid)
        require(why is not None, f"rescore: planted fault '{name}' passes the check")
        found[name] = why
    return found


def check_rescore(gen) -> dict:
    """The rescore kernel against its plain version at the serving point
    (B=512, C=256, m=128, qm=32 over a 1M-row forward index, missing
    candidates) on int32/float32 and int16/float16 slots, rel ≤ 1e-5; three
    planted faults (every candidate row shifted by one; each query's last
    live term dropped; the int16/float16 index with its weights zeroed past
    slot m/2) must fail that check."""
    import torch

    from verbatim_rag_tpu_torch.ops import rescore as rs

    cand, sp_ids, sp_w, q_ids, q_w = rescore_inputs(gen)
    (N, m), qm = sp_ids.shape, q_ids.shape[1]
    got = rs.exact_rescore_cuda(cand, sp_ids, sp_w, q_ids, q_w)
    torch.cuda.synchronize()
    ref = rs.exact_rescore_oneshot(cand, sp_ids, sp_w, q_ids, q_w)
    valid = cand >= 0
    why = rescore_fault(got, ref, valid)
    require(why is None, f"rescore: {why}")
    rel = ((got - ref).abs() / ref.abs().clamp(min=1e-6))[valid]
    err = float((got - ref)[valid].abs().max())
    require(float((got[valid] > 0).float().mean()) > 0.05, "rescore: too few matches to check")
    # The last live term of each query: its highest index with a nonzero weight.
    last = (torch.arange(qm, device="cuda")[None, :] * (q_w != 0)).argmax(dim=1, keepdim=True)
    faults = rescore_planted_faults(cand, sp_ids, sp_w, q_ids, q_w, ref, valid, {
        "every candidate row shifted by one": lambda: dict(
            cand=torch.where(cand >= 0, (cand + 1) % N, cand)
        ),
        "each query's last live term dropped": lambda: dict(q_w=q_w.scatter(1, last, 0.0)),
    })
    log("rescore planted faults", json.dumps(faults))
    # ms: CUDA events around calls, as for every kernel. The wrapper's host
    # time (tens of µs) comes close to the kernel's, so its device time from
    # the profiler stands beside it, with the records it rests on.
    ms = cuda_ms(lambda: rs.exact_rescore_cuda(cand, sp_ids, sp_w, q_ids, q_w), reps=20)
    device_ms, records = kernel_device_ms(
        lambda: rs.exact_rescore_cuda(cand, sp_ids, sp_w, q_ids, q_w), 20, "rescore_kernel"
    )
    plain_ms = cuda_ms(lambda: rs.exact_rescore_oneshot(cand, sp_ids, sp_w, q_ids, q_w), reps=3)
    b_ms, b_by = rescore_bound(cand, sp_ids, sp_w, qm)
    result = dict(
        max_abs_err=err, max_rel_err=float(rel.max()), ms=ms, device_ms=device_ms,
        device_records=records, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        planted_faults_caught=faults,
    )
    # The store's narrow forward index: int16 ids (vocab < 32768) and float16
    # weights, read straight from the [N, m] rows and widened in registers.
    ids16, w16 = sp_ids.to(torch.int16), sp_w.to(torch.float16)
    del sp_ids, sp_w
    got = rs.exact_rescore_cuda(cand, ids16, w16, q_ids, q_w)
    torch.cuda.synchronize()
    ref = rs.exact_rescore_oneshot(cand, ids16, w16, q_ids, q_w)
    why = rescore_fault(got, ref, valid)
    require(why is None, f"rescore int16/float16: {why}")
    rel16 = ((got - ref).abs() / ref.abs().clamp(min=1e-6))[valid]
    faults16 = rescore_planted_faults(cand, ids16, w16, q_ids, q_w, ref, valid, {
        "weights zeroed past slot m/2": lambda: dict(
            w=torch.where(torch.arange(m, device="cuda")[None, :] < m // 2, w16, 0.0)
        ),
    })
    log("rescore int16/float16 planted faults", json.dumps(faults16))
    b16_ms, b16_by = rescore_bound(cand, ids16, w16, qm)
    device16_ms, records16 = kernel_device_ms(
        lambda: rs.exact_rescore_cuda(cand, ids16, w16, q_ids, q_w), 20, "rescore_kernel"
    )
    result["int16_float16"] = dict(
        max_abs_err=float((got - ref)[valid].abs().max()), max_rel_err=float(rel16.max()),
        ms=cuda_ms(lambda: rs.exact_rescore_cuda(cand, ids16, w16, q_ids, q_w), reps=20),
        device_ms=device16_ms, device_records=records16,
        plain_ms=cuda_ms(lambda: rs.exact_rescore_oneshot(cand, ids16, w16, q_ids, q_w), reps=3),
        bound_ms=b16_ms, bound_by=b16_by, library_ms=None, planted_faults_caught=faults16,
    )
    log("rescore", json.dumps(result))
    return result


def check_rescore_bm25(gen) -> dict:
    """The rescore at the BM25 arm's width: B=512, C=256, m=256 int32 /
    float32 slots over 2^17 ids, qm=64, over a 1M-row forward index with
    missing candidates; rel ≤ 1e-5 and -1e30 exactly where missing; three
    planted faults (every candidate row shifted by one; each query's last
    live term dropped; the weights zeroed past slot m/2) must fail that
    check."""
    import torch

    from verbatim_rag_tpu_torch.ops import rescore as rs

    cand, ids, w, q_ids, q_w = rescore_inputs(gen, m=256, qm=64, vocab=1 << 17)
    (N, m), qm = ids.shape, q_ids.shape[1]
    got = rs.exact_rescore_cuda(cand, ids, w, q_ids, q_w)
    torch.cuda.synchronize()
    ref = rs.exact_rescore_oneshot(cand, ids, w, q_ids, q_w)
    valid = cand >= 0
    why = rescore_fault(got, ref, valid)
    require(why is None, f"rescore at m=256: {why}")
    require(float((got[valid] > 0).float().mean()) > 0.05, "rescore at m=256: too few matches to check")
    rel = ((got - ref).abs() / ref.abs().clamp(min=1e-6))[valid]
    err = float((got - ref)[valid].abs().max())
    last = (torch.arange(qm, device="cuda")[None, :] * (q_w != 0)).argmax(dim=1, keepdim=True)
    faults = rescore_planted_faults(cand, ids, w, q_ids, q_w, ref, valid, {
        "every candidate row shifted by one": lambda: dict(
            cand=torch.where(cand >= 0, (cand + 1) % N, cand)
        ),
        "each query's last live term dropped": lambda: dict(q_w=q_w.scatter(1, last, 0.0)),
        "weights zeroed past slot m/2": lambda: dict(
            w=torch.where(torch.arange(m, device="cuda")[None, :] < m // 2, w, 0.0)
        ),
    })
    log("rescore m=256 planted faults", json.dumps(faults))
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: rs.exact_rescore_cuda(cand, ids, w, q_ids, q_w), reps=20)
    device_ms, records = kernel_device_ms(
        lambda: rs.exact_rescore_cuda(cand, ids, w, q_ids, q_w), 20, "rescore_kernel"
    )
    plain_ms = cuda_ms(lambda: rs.exact_rescore_oneshot(cand, ids, w, q_ids, q_w), reps=2)
    b_ms, b_by = rescore_bound(cand, ids, w, qm)
    result = dict(
        m=m, qm=qm, vocab=1 << 17, max_abs_err=err, max_rel_err=float(rel.max()), ms=ms,
        device_ms=device_ms, device_records=records, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, planted_faults_caught=faults,
    )
    log("rescore m=256", json.dumps(result))
    return result


def check_section_three_arms(gen) -> dict:
    """The 3-way section launch at the int8 store's geometry: three int8
    arms (dense 384, SPLADE sketch 768, BM25 sketch 768) at B=512 over
    N=1,007,616 rows (blocks of 8192), dead rows in the mask, tables
    bit-equal to the plain version's; a planted fault (arm 2 reading arm
    1's rows) must fail that check. Library yardstick: `torch._int_mm` of
    the three products alone."""
    import torch

    from verbatim_rag_tpu_torch.ops import fused_topk as ft
    from verbatim_rag_tpu_torch.ops import section as sec

    n, batch, block = 123 * 8192, 512, 8192
    arms = [table_arm(gen, n, batch, d, "int8") for d in (384, 768, 768)]
    mask = table_mask(gen, n)
    corpora, queries, scales = zip(*arms)
    before = sec.launches
    got = sec.section_tables_cuda(corpora, queries, mask, scales, block)
    require(sec.launches == before + 1, "section three arms: not one launch")
    torch.cuda.synchronize()
    ref = sec.section_tables_reference(corpora, queries, mask, scales, block)
    why = section_fault(got, ref, corpora, queries, block, True)
    require(why is None, f"section three arms: {why}")
    err = max(
        float((g - e).abs()[e > -1e29].max()) for g, e in zip(got, ref)
    )
    del got
    faulty = sec.section_tables_cuda(
        (corpora[0], corpora[1], corpora[1]), queries, mask, (scales[0], scales[1], scales[1]), block
    )
    fault = section_fault(faulty, ref, corpora, queries, block, True)
    require(fault is not None, "section three arms: planted fault 'arm 2 reading arm 1's rows' passes the check")
    log("section three arms planted fault", json.dumps({"arm 2 reading arm 1's rows": fault}))
    del ref, faulty
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: sec.section_tables_cuda(corpora, queries, mask, scales, block), reps=10)
    plain_ms = cuda_ms(lambda: sec.section_tables_reference(corpora, queries, mask, scales, block), reps=2)
    width = n // block * 128
    b_ms, b_by = bound(
        table_bytes(arms, n, batch, width, 4), sum(2.0 * batch * n * c.shape[1] for c in corpora),
        PEAK_INT8_OPS,
    )
    prepared = [ft.prepare_queries(q, c)[0] for c, q in zip(corpora, queries)]
    library_ms = cuda_ms(lambda: [torch._int_mm(p, c.t()) for p, c in zip(prepared, corpora)], reps=5)
    result = dict(
        n=n, block=block, arms=[int(c.shape[1]) for c in corpora], dtype="int8", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        planted_faults_caught={"arm 2 reading arm 1's rows": fault},
    )
    log("section three arms", json.dumps(result))
    return result


def table_arm(gen, n: int, batch: int, d: int, dtype: str):
    """One arm: unit-norm rows [n, d] as int8 codes + scales, bf16 or
    float32, and float32 queries [batch, d]."""
    import torch

    from verbatim_rag_tpu_torch.ops.dense import quantize_rows_int8

    rows = torch.randn(n, d, generator=gen, device="cuda")
    rows /= rows.norm(dim=1, keepdim=True)
    q = torch.randn(batch, d, generator=gen, device="cuda")
    if dtype == "int8":
        codes, scale = quantize_rows_int8(rows)
        return codes, q, scale
    return rows.to(getattr(torch, dtype)), q, None


def table_mask(gen, n: int):
    """1% of the rows dead at random and 5000 in a run from the middle."""
    import torch

    mask = torch.rand(n, generator=gen, device="cuda") > 0.01
    mask[n // 2 : n // 2 + 5000] = False
    return mask


def table_arms(gen, n: int, batch: int, dtype: str):
    """Dense (384) and sketch (768) arms at the serving shape (`table_arm`)
    and a mask with dead rows."""
    arms = [table_arm(gen, n, batch, d, dtype) for d in (384, 768)]
    return arms, table_mask(gen, n)


def table_fault(got, expected, rows, q, int8: bool) -> str | None:
    """Why a kernel's (values, global rows) table does not hold to its plain
    version's, or None: int8 bit-equal; bf16 and float32 values within
    2⁻¹⁵·|q| (rows have unit norm; float32 sums in another order, and a pack
    step of 128 ulp is 2⁻¹⁶ of a value) and each differing row a winner whose
    exact score is within that of the plain version's row."""
    import torch

    (g_vals, g_rows), (e_vals, e_rows) = got, expected
    live = e_vals > -1e29
    if not torch.equal(live, g_vals > -1e29):
        return "table: live entries differ"
    if int8:
        if not torch.equal(g_vals.view(torch.int32), e_vals.view(torch.int32)):
            return "table: int8 values not bit-equal"
        return None if torch.equal(g_rows, e_rows) else "table: int8 rows differ"
    tol = 2.0**-15 * q.norm(dim=1, keepdim=True).expand_as(g_vals)
    if not bool(((g_vals - e_vals).abs() <= tol)[live].all()):
        return f"table: {rows.dtype} values off by {float((g_vals - e_vals).abs()[live].max())}"
    b_idx, c_idx = torch.nonzero((g_rows != e_rows) & live, as_tuple=True)
    qb = q.to(rows.dtype).float()[b_idx]
    s_g = (qb * rows[g_rows[b_idx, c_idx].long()].float()).sum(-1)
    s_e = (qb * rows[e_rows[b_idx, c_idx].long()].float()).sum(-1)
    if not bool(((s_g - s_e).abs() <= tol[b_idx, c_idx]).all()):
        return f"table: a {rows.dtype} row is not a near-winner"
    return None


def check_table(got, expected, rows, q, int8: bool) -> float:
    """Require `table_fault` to find nothing; the max abs error of the live
    values."""
    why = table_fault(got, expected, rows, q, int8)
    require(why is None, str(why))
    live = expected[0] > -1e29
    return float((got[0] - expected[0]).abs()[live].max())


def v2_planted_faults(c, q, mask, s, ref, int8: bool) -> dict:
    """The v2 kernel run with each planted fault, held to the true plain
    table: the mask ignored (every row live), and the last position of each
    block dropped (its rows masked). Each must fail the check."""
    import torch

    from verbatim_rag_tpu_torch.ops import fused_topk as ft

    n = c.shape[0]
    block = ft.choose_block_rows(n)
    last = (torch.arange(n, device=c.device) % block) // 128 == block // 128 - 1
    found = {}
    for name, fault_mask in (
        ("mask ignored", torch.ones_like(mask)),
        ("last position of each block dropped", mask & ~last),
    ):
        why = table_fault(ft.matmul_bucket_max_v2_cuda(c, q, fault_mask, s), ref, c, q, int8)
        require(why is not None, f"bucket_max_v2: planted fault '{name}' passes the check")
        found[name] = why
    return found


def section_fault(got, expected, corpora, queries, block: int, int8: bool) -> str | None:
    """`table_fault` of the first section table (decoded) that does not hold
    to its plain version's, or None."""
    n = corpora[0].shape[0]
    for g, e, c, q in zip(got, expected, corpora, queries):
        why = table_fault(sec_decode(g, block, n), sec_decode(e, block, n), c, q, int8)
        if why is not None:
            return why
    return None


def section_planted_faults(corpora, queries, mask, scales, block: int, ref, int8: bool) -> dict:
    """The section kernel run with each planted fault, held to the true
    plain tables: the mask ignored, the last position of each block dropped
    (its rows masked), and arm 1 reading arm 0's rows (with arm 1's queries
    cut to arm 0's width). Each must fail the check."""
    import torch

    from verbatim_rag_tpu_torch.ops import section as sec

    n, d0 = corpora[0].shape
    last = (torch.arange(n, device=mask.device) % block) // 128 == block // 128 - 1
    runs = {
        "mask ignored": (corpora, queries, None, scales),
        "last position of each block dropped": (corpora, queries, mask & ~last, scales),
        "arm 1 reading arm 0's rows": (
            (corpora[0], corpora[0]), (queries[0], queries[1][:, :d0].contiguous()), mask,
            (scales[0], scales[0]),
        ),
    }
    found = {}
    for name, (c, q, m, s) in runs.items():
        why = section_fault(sec.section_tables_cuda(c, q, m, s, block), ref, corpora, queries, block, int8)
        require(why is not None, f"section_tables: planted fault '{name}' passes the check")
        found[name] = why
    return found


#: Section calls that mix row kinds (one launch per kind) or tile sizes (the
#: 768-wide bf16 arm takes 64-query tiles, the others 128): each arm's
#: (columns, row dtype).
SECTION_MIXES = {
    "int8 dense + float32 sketch": ((384, "int8"), (768, "float32")),
    "bf16 dense + int8 sketch": ((384, "bfloat16"), (768, "int8")),
    "three bf16 arms of different widths": ((64, "bfloat16"), (384, "bfloat16"), (768, "bfloat16")),
}


def check_section_mixed(gen) -> dict:
    """Each `SECTION_MIXES` call at N=32,768 (blocks of 8192), a ragged batch
    of 300 and the dead-row mask, every arm held to the plain version (int8
    arms bit-equal); the max abs error of the live values per mix."""
    import torch

    from verbatim_rag_tpu_torch.ops import section as sec

    n, batch, block = 4 * 8192, 300, 8192
    result = {}
    for name, spec in SECTION_MIXES.items():
        arms = [table_arm(gen, n, batch, d, dtype) for d, dtype in spec]
        mask = table_mask(gen, n)
        corpora, queries, scales = zip(*arms)
        got = sec.section_tables_cuda(corpora, queries, mask, scales, block)
        torch.cuda.synchronize()
        ref = sec.section_tables_reference(corpora, queries, mask, scales, block)
        result[name] = max(
            check_table(sec_decode(g, block, n), sec_decode(e, block, n), c, q, c.dtype == torch.int8)
            for g, e, c, q in zip(got, ref, corpora, queries)
        )
    log("section mixed kinds", json.dumps(result))
    return result


def table_bytes(arms, n: int, batch: int, width: int, out_bytes: int) -> float:
    """Bytes a table function must move: each arm's rows (and scales), the
    bool mask, the queries, and its output tables."""
    total = n + sum(
        c.numel() * c.element_size() + (0 if s is None else 4 * n) + q.numel() * 4 + batch * width * out_bytes
        for c, q, s in arms
    )
    return float(total)


def check_tables(gen) -> tuple[dict, dict]:
    """Section kernel (both arms, one launch) and bucket-max v2 (one launch
    per arm) against their plain versions at the serving shapes: int8 and
    bf16 rows at both geometries, float32 rows at the int8 store's."""
    import torch

    from verbatim_rag_tpu_torch.ops import fused_topk as ft
    from verbatim_rag_tpu_torch.ops import section as sec

    batch = 512
    section_cases, bucket_cases = [], []
    cells = [(123 * 8192, 8192, dt) for dt in ("int8", "bfloat16", "float32")]
    cells += [(64 * 16384, 16384, dt) for dt in ("int8", "bfloat16")]
    for n, block, dtype in cells:
        int8 = dtype == "int8"
        arms, mask = table_arms(gen, n, batch, dtype)
        corpora, queries, scales = zip(*arms)
        scales = scales if int8 else (None, None)
        width = n // block * 128
        peak = {"int8": PEAK_INT8_OPS, "bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_FP32_OPS}[dtype]
        ops = [2.0 * batch * n * c.shape[1] for c in corpora]

        got = sec.section_tables_cuda(corpora, queries, mask, scales, block)
        torch.cuda.synchronize()
        ref = sec.section_tables_reference(corpora, queries, mask, scales, block)
        err = max(
            check_table(sec_decode(g, block, n), sec_decode(e, block, n), c, q, int8)
            for g, e, c, q in zip(got, ref, corpora, queries)
        )
        faults = None
        if block == 8192:
            faults = section_planted_faults(corpora, queries, mask, scales, block, ref, int8)
            log("section_tables planted faults", dtype, json.dumps(faults))
        del got, ref
        ms = cuda_ms(lambda: sec.section_tables_cuda(corpora, queries, mask, scales, block), reps=10)
        plain_ms = cuda_ms(lambda: sec.section_tables_reference(corpora, queries, mask, scales, block), reps=2)
        b_ms, b_by = bound(table_bytes(arms, n, batch, width, 4), sum(ops), peak)
        products = None
        if dtype != "bfloat16":  # the two products alone, as cuBLAS computes them
            prepared = [ft.prepare_queries(q, c)[0] for c, q in zip(corpora, queries)]
            product = torch._int_mm if int8 else torch.mm
            products = cuda_ms(
                lambda: [product(p, c.t()) for p, c in zip(prepared, corpora)], reps=5
            )
        case = dict(
            n=n, block=block, dtype=dtype, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, products_ms=products, planted_faults_caught=faults,
        )
        log("section", json.dumps(case))
        section_cases.append(case)

        for arm, (c, q, s) in zip(("dense", "sketch"), arms):
            got = ft.matmul_bucket_max_v2_cuda(c, q, mask, s)
            torch.cuda.synchronize()
            ref = ft.matmul_bucket_max_v2_reference(c, q, mask, s)
            err = check_table(got, ref, c, q, int8)
            faults = None
            if arm == "dense" and block == 8192:
                faults = v2_planted_faults(c, q, mask, s, ref, int8)
                log("bucket_max_v2 planted faults", dtype, json.dumps(faults))
            del got, ref
            ms = cuda_ms(lambda: ft.matmul_bucket_max_v2_cuda(c, q, mask, s), reps=10)
            plain_ms = cuda_ms(lambda: ft.matmul_bucket_max_v2_reference(c, q, mask, s), reps=2)
            b_ms, b_by = bound(
                table_bytes([(c, q, s)], n, batch, width, 8), 2.0 * batch * n * c.shape[1], peak
            )
            products = None
            if dtype != "bfloat16":
                qi = ft.prepare_queries(q, c)[0]
                product = torch._int_mm if int8 else torch.mm
                products = cuda_ms(lambda: product(qi, c.t()), reps=5)
            case = dict(
                n=n, block=ft.choose_block_rows(n), dtype=dtype, arm=arm, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                products_ms=products, planted_faults_caught=faults,
            )
            log("bucket_max_v2", json.dumps(case))
            bucket_cases.append(case)
        del arms, corpora, queries, scales, mask
        torch.cuda.empty_cache()
    # Headlines: the int8 store's geometry (N = 1,007,616, blocks of 8192),
    # int8, with the float32 arms beside them; for bucket-max v2 the two
    # arms of one hybrid batch added together.
    def headline(cases, dtype):
        rows = [c for c in cases if c["n"] == 123 * 8192 and c["dtype"] == dtype]
        out = {
            k: None if any(c[k] is None for c in rows) else sum(c[k] for c in rows)
            for k in ("ms", "plain_ms", "bound_ms", "products_ms")
        }
        out.update(max_abs_err=max(c["max_abs_err"] for c in rows), bound_by=rows[0]["bound_by"])
        return out

    section = dict(headline(section_cases, "int8"), library_ms=None, cases=section_cases)
    section["bfloat16"] = headline(section_cases, "bfloat16")
    section["float32"] = headline(section_cases, "float32")
    section["mixed_kinds_max_abs_err"] = check_section_mixed(gen)
    bucket = dict(headline(bucket_cases, "int8"), library_ms=None, cases=bucket_cases)
    bucket["float32"] = headline(bucket_cases, "float32")
    return section, bucket


#: Rows past 2944 bytes, whose query tile streams through the wgmma walk's
#: ring: int8 at text-embedding-3-large's 3072 and at 4096, bf16 at
#: text-embedding-ada-002's 1536. Each at N = 1,048,576 rows (blocks of
#: 16384), B = 512; the section planted faults run on a second arm of the
#: same kind (int8 3072 + 4096, bf16 1536 + 1536).
WIDE_ROWS = ((3072, "int8"), (4096, "int8"), (1536, "bfloat16"))
WIDE_N, WIDE_BLOCK = 64 * 16384, 16384


def check_wide_tables(gen) -> dict:
    """The wgmma walk's streamed arms against their plain versions:
    section tables (one arm a width, timed; then two arms of the kind, and a
    resident and a streamed int8 arm at 32 queries, with the three planted
    faults), bucket-max v2 (each width, its two planted
    faults) and bucket-max v1 (bf16 1536, the mask-ignored fault), with
    times, bounds and the products alone (`torch._int_mm` for int8, a bf16
    `torch.mm` into float32) as the yardstick."""
    import torch

    from verbatim_rag_tpu_torch.ops import fused_topk as ft
    from verbatim_rag_tpu_torch.ops import section as sec

    n, block, batch = WIDE_N, WIDE_BLOCK, 512
    width = n // block * 128
    out = {"section": [], "bucket_max_v2": [], "bucket_max_v1": []}

    def product_ms(c, q):
        qp = ft.prepare_queries(q, c)[0]
        if c.dtype == torch.int8:
            return cuda_ms(lambda: torch._int_mm(qp, c.t()), reps=5)
        return cuda_ms(lambda: torch.mm(qp, c.t(), out_dtype=torch.float32), reps=5)

    for d, dtype in WIDE_ROWS:
        int8 = dtype == "int8"
        peak = PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS
        c, q, s = table_arm(gen, n, batch, d, dtype)
        mask = table_mask(gen, n)
        row_bytes = c.shape[1] * c.element_size()
        require(ft.walk_streams(row_bytes), f"wide {dtype} d={d}: the query tile does not stream")
        geometry = ft.walk_geometry(row_bytes, "section")

        before = sec.launches_streamed
        got = sec.section_tables_cuda((c,), (q,), mask, (s,), block)
        torch.cuda.synchronize()
        require(sec.launches_streamed == before + 1, "wide section: not counted as streamed")
        ref = sec.section_tables_reference((c,), (q,), mask, (s,), block)
        err = check_table(sec_decode(got[0], block, n), sec_decode(ref[0], block, n), c, q, int8)
        del got, ref
        case = dict(
            n=n, block=block, batch=batch, d=d, dtype=dtype, row_bytes=row_bytes, queries=geometry[0],
            stages=geometry[1], max_abs_err=err,
            ms=cuda_ms(lambda: sec.section_tables_cuda((c,), (q,), mask, (s,), block), reps=10),
            plain_ms=cuda_ms(lambda: sec.section_tables_reference((c,), (q,), mask, (s,), block), reps=2),
            products_ms=product_ms(c, q),
        )
        case["bound_ms"], case["bound_by"] = bound(
            table_bytes([(c, q, s)], n, batch, width, 4), 2.0 * batch * n * d, peak
        )
        log("section wide", json.dumps(case))
        out["section"].append(case)

        got = ft.matmul_bucket_max_v2_cuda(c, q, mask, s)
        torch.cuda.synchronize()
        ref = ft.matmul_bucket_max_v2_reference(c, q, mask, s)
        err = check_table(got, ref, c, q, int8)
        faults = v2_planted_faults(c, q, mask, s, ref, int8)
        del got, ref
        case = dict(
            n=n, block=ft.choose_block_rows(n), batch=batch, d=d, dtype=dtype, max_abs_err=err,
            ms=cuda_ms(lambda: ft.matmul_bucket_max_v2_cuda(c, q, mask, s), reps=10),
            plain_ms=cuda_ms(lambda: ft.matmul_bucket_max_v2_reference(c, q, mask, s), reps=2),
            products_ms=case["products_ms"], planted_faults_caught=faults,
        )
        case["bound_ms"], case["bound_by"] = bound(
            table_bytes([(c, q, s)], n, batch, width, 8), 2.0 * batch * n * d, peak
        )
        log("bucket_max_v2 wide", json.dumps(case))
        out["bucket_max_v2"].append(case)

        if not int8:  # v1 reads bf16 and float32 rows
            got = ft.matmul_bucket_max_cuda(c, q, mask)
            torch.cuda.synchronize()
            ref = ft.matmul_bucket_max_reference(c, q, mask)
            why = v1_fails(got, ref, q, c, mask, V1_LIMITS[dtype])
            require(why is None, f"bucket v1 wide d={d}: {why}")
            live = ref[0] > -1e29
            err = float((got[0] - ref[0]).abs()[live].max())
            del got
            fault = v1_fails(ft.matmul_bucket_max_cuda(c, q, torch.ones_like(mask)), ref, q, c, mask, V1_LIMITS[dtype])
            require(fault is not None, f"bucket v1 wide d={d}: the mask-ignored fault passes the check")
            del ref
            case = dict(
                n=n, batch=batch, d=d, dtype=dtype, max_abs_err=err, fault_mask_ignored=fault,
                ms=cuda_ms(lambda: ft.matmul_bucket_max_cuda(c, q, mask), reps=10),
                plain_ms=cuda_ms(lambda: ft.matmul_bucket_max_reference(c, q, mask), reps=2),
                library_ms=product_ms(c, q),
            )
            case["bound_ms"], case["bound_by"] = v1_bound(n, batch, d, c.dtype)
            log("bucket_max_v1 wide", json.dumps(case))
            out["bucket_max_v1"].append(case)
        del c, q, s, mask
        torch.cuda.empty_cache()

    # The section kernel's planted faults on two streamed arms of one kind,
    # and on a call mixing layouts at the doc phase's batch (a resident
    # 768-byte arm and a streamed 3072-byte one: two launches, 32 queries in
    # a partial tile).
    for dims, dtype, batch in (((3072, 4096), "int8", 512), ((1536, 1536), "bfloat16", 512),
                               ((768, 3072), "int8", 32)):
        int8 = dtype == "int8"
        arms = [table_arm(gen, n, batch, d, dtype) for d in dims]
        mask = table_mask(gen, n)
        corpora, queries, scales = zip(*arms)
        got = sec.section_tables_cuda(corpora, queries, mask, scales, block)
        torch.cuda.synchronize()
        ref = sec.section_tables_reference(corpora, queries, mask, scales, block)
        err = max(
            check_table(sec_decode(g, block, n), sec_decode(e, block, n), c, q, int8)
            for g, e, c, q in zip(got, ref, corpora, queries)
        )
        del got
        faults = section_planted_faults(corpora, queries, mask, scales, block, ref, int8)
        case = dict(n=n, block=block, batch=batch, dims=list(dims), dtype=dtype,
                    streamed=[ft.walk_streams(c.shape[1] * c.element_size()) for c in corpora],
                    max_abs_err=err, planted_faults_caught=faults)
        log("section wide two arms", json.dumps(case))
        out["section"].append(case)
        del arms, corpora, queries, scales, mask, ref
        torch.cuda.empty_cache()
    return out


def sec_decode(table, block: int, n: int):
    """A packed section table → (values, global rows), decoded in full."""
    import torch

    from verbatim_rag_tpu_torch.ops import section as sec

    vals, pos = sec.unpack_table(table)
    cols = torch.arange(table.shape[1], device=table.device, dtype=torch.int32)
    rows = (cols // 128) * block + pos * 128 + cols % 128
    return vals, torch.clamp(rows, max=n - 1)


#: Bucket-max v1 checks: values within this share of |q| (rows have unit
#: norm). bf16 as the v2 checks; float32 sums of d products in another order
#: are off by about √d·2⁻²⁴·|q| (1.7e-6·|q| at d = 768); no pack step.
V1_LIMITS = {"bfloat16": 2.0**-15, "float32": 2.0**-18}
#: The bucket A/B phase (`benchmarks/bench_fused_bucket.py`'s defaults).
AB_ROWS, AB_BATCH, AB_K = 999_424, 512, 256


def v1_fails(got, expected, q, corpus, mask, limit: float | None) -> str | None:
    """Why a v1 table (values, rows) does not hold to the plain version's,
    or None: the same live entries, -1e30 and the same rows on dead buckets;
    values bit-equal and rows equal (``limit`` None: exact-tie inputs) or
    values within limit·|q| and rows equal except in buckets whose two best
    plain scores lie within that."""
    import torch

    (g_vals, g_rows), (e_vals, e_rows) = got, expected
    live = e_vals > -1e29
    if not torch.equal(live, g_vals > -1e29) or not bool((g_vals[~live] == -1e30).all()):
        return "live entries differ"
    if not torch.equal(g_rows[~live], e_rows[~live]):
        return "dead-bucket rows differ"
    if limit is None:
        if not torch.equal(g_vals.view(torch.int32), e_vals.view(torch.int32)):
            return "values not bit-equal"
        return None if torch.equal(g_rows, e_rows) else "rows differ"
    tol = limit * q.to(corpus.dtype).float().norm(dim=1, keepdim=True).expand_as(g_vals)
    if not bool(((g_vals - e_vals).abs() <= tol)[live].all()):
        return f"values off by {float((g_vals - e_vals).abs()[live].max())}"
    b_idx, c_idx = torch.nonzero((g_rows != e_rows) & live, as_tuple=True)
    if b_idx.numel():  # only the differing buckets' scores are computed
        qb = q.to(corpus.dtype).float()[b_idx]
        rows = c_idx[:, None] * 128 + torch.arange(128, device=q.device)[None, :]
        s = (qb[:, None, :] * corpus[rows].float()).sum(-1)
        s = torch.where(mask[rows], s, -1e30).topk(2, dim=1).values
        if not bool(((s[:, 0] - s[:, 1]).abs() <= tol[b_idx, c_idx]).all()):
            return f"{b_idx.numel()} rows differ outside a near-tie"
    return None


def v1_bound(n: int, batch: int, d: int, dtype) -> tuple[float, str]:
    import torch

    elt = torch.tensor([], dtype=dtype).element_size()
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_OPS
    return bound(n * d * elt + batch * d * elt + n + batch * (n // 128) * 8, 2.0 * batch * n * d, peak)


def v1_inputs(gen, n: int, batch: int, d: int, dtype):
    """Unit-norm rows and float32 queries, every 7th row dead and bucket 5
    dead."""
    import torch

    rows = torch.randn(n, d, generator=gen, device="cuda")
    rows = (rows / rows.norm(dim=1, keepdim=True)).to(dtype)
    q = torch.randn(batch, d, generator=gen, device="cuda")
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    mask[::7] = False
    mask[5 * 128 : 6 * 128] = False
    return rows, q, mask


def check_bucket_v1(gen) -> dict:
    """Bucket-max v1 against its plain version: bf16 and float32 rows at the
    A/B shapes (d = 384, 768) and at one block (N = 16384, a ragged batch of
    70), dead rows and a dead bucket; exact ties on small-integer rows with
    duplicates (bit-equal, highest lane); two planted faults; times, bounds
    and the product alone as the library yardstick."""
    import torch

    from verbatim_rag_tpu_torch.ops import fused_topk as ft

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        limit = V1_LIMITS[name]
        for n, batch, d in ((16384, 70, 384), (AB_ROWS, AB_BATCH, 384), (AB_ROWS, AB_BATCH, 768)):
            corpus, q, mask = v1_inputs(gen, n, batch, d, dtype)
            got = ft.matmul_bucket_max_cuda(corpus, q, mask)
            torch.cuda.synchronize()
            ref = ft.matmul_bucket_max_reference(corpus, q, mask)
            why = v1_fails(got, ref, q, corpus, mask, limit)
            require(why is None, f"bucket v1 {name} N={n} d={d}: {why}")
            require(
                bool((got[0][:, 5] == -1e30).all() and (got[1][:, 5] == 5 * 128 + 127).all()),
                f"bucket v1 {name}: dead bucket not (-1e30, highest lane)",
            )
            live = ref[0] > -1e29
            case = dict(n=n, batch=batch, d=d, dtype=name, max_abs_err=float((got[0] - ref[0]).abs()[live].max()))
            del got, ref
            if n == AB_ROWS:
                # Planted fault: the kernel run without the mask.
                unmasked = ft.matmul_bucket_max_cuda(corpus, q, torch.ones_like(mask))
                fault = v1_fails(unmasked, ft.matmul_bucket_max_reference(corpus, q, mask), q, corpus, mask, limit)
                require(fault is not None, f"bucket v1 {name}: the mask-ignored fault passes the check")
                case["fault_mask_ignored"] = fault
                del unmasked
                qp = q.to(dtype)
                case["ms"] = cuda_ms(lambda: ft.matmul_bucket_max_cuda(corpus, q, mask), reps=10)
                case["plain_ms"] = cuda_ms(lambda: ft.matmul_bucket_max_reference(corpus, q, mask), reps=2)
                # Library yardstick: the product alone (no bucket max, no argmax).
                if dtype == torch.bfloat16:
                    case["library_ms"] = cuda_ms(lambda: torch.mm(qp, corpus.t(), out_dtype=torch.float32), reps=10)
                else:
                    case["library_ms"] = cuda_ms(lambda: torch.mm(qp, corpus.t()), reps=10)
                case["bound_ms"], case["bound_by"] = v1_bound(n, batch, d, dtype)
            log("bucket_max_v1", json.dumps(case))
            cases.append(case)
            del corpus, q, mask
            torch.cuda.empty_cache()

        # Exact ties: small-integer rows (every dot exact in float32 and in
        # bf16) with 6 copies of one row in every bucket.
        n, batch, d = 4 * 16384, 77, 64
        corpus = torch.randint(-2, 3, (n, d), generator=gen, device="cuda").float()
        q = torch.randint(-2, 3, (batch, d), generator=gen, device="cuda").float()
        copies = torch.randint(0, 128, (n // 128, 6), generator=gen, device="cuda")
        rows = copies + torch.arange(0, n, 128, device="cuda")[:, None]
        corpus[rows] = corpus[rows[:, :1]]
        corpus = corpus.to(dtype)
        mask = torch.ones(n, dtype=torch.bool, device="cuda")
        mask[::11] = False
        mask[5 * 128 : 6 * 128] = False
        got = ft.matmul_bucket_max_cuda(corpus, q, mask)
        ref = ft.matmul_bucket_max_reference(corpus, q, mask)
        why = v1_fails(got, ref, q, corpus, mask, None)
        require(why is None, f"bucket v1 {name} exact ties: {why}")
        # Planted fault: ties to the lowest lane (the kernel on each bucket's
        # lanes reversed, its rows mapped back).
        flip = lambda x: x.reshape(-1, 128, *x.shape[1:]).flip(1).reshape(x.shape)  # noqa: E731
        vals, frows = ft.matmul_bucket_max_cuda(flip(corpus), q, flip(mask))
        lowest = (vals, (frows // 128) * 128 + 127 - frows % 128)
        fault = v1_fails(lowest, ref, q, corpus, mask, None)
        require(fault is not None, f"bucket v1 {name}: the lowest-lane fault passes the check")
        # ...and not only on dead buckets: on live buckets that hold a tie.
        live = ref[0] > -1e29
        fault_live = int((lowest[1] != ref[1])[live].sum())
        require(fault_live > 0, f"bucket v1 {name}: the lowest-lane fault moves no live row")
        scores = torch.where(mask, q.to(dtype).float() @ corpus.float().t(), -1e30)
        tied = int(((scores.reshape(batch, -1, 128) == ref[0][..., None]).sum(-1) > 1).sum())
        require(tied > 0, f"bucket v1 {name} exact ties: no bucket holds a tie")
        case = dict(
            n=n, batch=batch, d=d, dtype=name, exact_ties=True, tied_buckets=tied,
            fault_lowest_lane=fault, fault_lowest_lane_live_rows_moved=fault_live,
        )
        log("bucket_max_v1", json.dumps(case))
        cases.append(case)
        del corpus, q, mask, got, ref, vals, frows, scores
        torch.cuda.empty_cache()
    # Headline: bf16 at the A/B shape, d = 768 (the sketch width).
    head = next(c for c in cases if c["dtype"] == "bfloat16" and c["n"] == AB_ROWS and c["d"] == 768)
    d384 = next(c for c in cases if c["dtype"] == "bfloat16" and c["n"] == AB_ROWS and c["d"] == 384)
    return dict(
        {k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        library_note="torch.mm of the product alone: no PyTorch call computes the bucket argmax",
        max_abs_err=max(c.get("max_abs_err", 0.0) for c in cases),
        d384={k: d384[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        cases=cases,
    )


# -- phases 3-6: the main path ------------------------------------------------------------


def kernel_counters() -> dict:
    """Each kernel's launch counter: (module, attribute)."""
    from verbatim_rag_tpu_torch.ops import flash_attention, fused_topk, rescore, section

    return {
        "flash_attention": (flash_attention, "launches"),
        "flash_attention_d32": (flash_attention, "launches_d32"),
        "flash_bwd_dq": (flash_attention, "bwd_dq_launches"),
        "flash_bwd_dq_d32": (flash_attention, "bwd_dq_launches_d32"),
        "flash_bwd_dkv": (flash_attention, "bwd_dkv_launches"),
        "flash_bwd_dkv_d32": (flash_attention, "bwd_dkv_launches_d32"),
        "flash_attention_partial": (flash_attention, "partial_launches"),
        "flash_attention_partial_d32": (flash_attention, "partial_launches_d32"),
        "rescore": (rescore, "launches"),
        "section": (section, "launches"),
        "section_streamed": (section, "launches_streamed"),
        "bucket_max_v2": (fused_topk, "launches"),
        "bucket_max_v1": (fused_topk, "launches_v1"),
    }


def reset_counts() -> None:
    for module, attr in kernel_counters().values():
        setattr(module, attr, 0)
    from verbatim_rag_tpu_torch.engine import native

    native.tokenize_calls = native.analyze_calls = native.analyze_texts = 0


def scanner_counts() -> dict:
    """The host scanner's counters (`engine/native.py`): calls whose result
    the tokenizer took, and the analyzer's calls and texts."""
    from verbatim_rag_tpu_torch.engine import native

    return dict(
        tokenize_calls=native.tokenize_calls, analyze_calls=native.analyze_calls,
        analyze_texts=native.analyze_texts,
    )


#: The host scanner's parity and timing check (`check_scanner`): the BM25
#: vocabulary (the store's default) the analyzer runs at.
SCANNER_FT_VOCAB = 1 << 17


def host_ms(fn, reps: int):
    """(fn's first result, median host-clock ms of ``reps`` calls)."""
    import numpy as np

    times, first = [], None
    for i in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = out
    return first, float(np.median(times))


def check_scanner(texts, tokenizer, what: str, reps: int) -> dict:
    """A phase's own texts through the compiled host scanner and through
    the Python paths it replaces, each called directly: the tokenizer's scan
    (`native.hash_tokenize`) against its regex loop (`_regex_arrays`), ids
    and offsets bit-equal on every ASCII text (the scan declines the others,
    as in the JAX package); the batch analyzer (`analyzer.analyze_texts`)
    against its plain numpy version, every array equal. Host ms of each
    (median of ``reps`` calls over all ``texts``). Runs after the phase has
    read its counters: these calls are the comparison's, not the path's."""
    import numpy as np

    from verbatim_rag_tpu_torch.engine import analyzer, native

    vocab, reserved = tokenizer.vocab_size, tokenizer._reserved
    scanned, scan_ms = host_ms(lambda: [native.hash_tokenize(t, vocab, reserved, 1 << 62) for t in texts], reps)
    python, python_ms = host_ms(lambda: [tokenizer._regex_arrays(t, None) for t in texts], reps)
    n_ascii = sum(t.isascii() for t in texts)
    require(sum(s is not None for s in scanned) == n_ascii, f"{what}: the scan declined an ASCII text")
    differ = [
        i for i, (s, p) in enumerate(zip(scanned, python))
        if s is not None and not (np.array_equal(s[0], p[0]) and np.array_equal(s[1], p[1]))
    ]
    require(not differ, f"{what}: the scan's ids or offsets differ from the regex loop's on texts {differ[:8]}")
    analyzed, analyze_ms = host_ms(lambda: analyzer.analyze_texts(texts, SCANNER_FT_VOCAB), reps)
    plain, plain_ms = host_ms(lambda: analyzer.analyze_texts_plain(texts, SCANNER_FT_VOCAB), reps)
    require(
        all(np.array_equal(a, b) for a, b in zip(analyzed, plain)),
        f"{what}: the batch analyzer differs from its plain version",
    )
    result = dict(
        texts=len(texts), ascii_texts=n_ascii, tokens=int(sum(p[0].size for p in python)),
        tokenize_ms=scan_ms, tokenize_python_ms=python_ms, analyze_ms=analyze_ms,
        analyze_plain_ms=plain_ms, analyzer_slots=int(analyzed[0].size), reps=reps,
    )
    log(f"{what} host scanner", json.dumps(result))
    return result


def read_counts() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in kernel_counters().items()}


def build_host_runtime() -> dict:
    """Build (or find) and load the port's C++ host runtime
    (`engine/native.py`: g++ with `native/Makefile`'s flags, from
    `csrc/host/`); the compiler's version and the seconds it took."""
    from verbatim_rag_tpu_torch.engine import native

    version = subprocess.run(
        [native._compiler(), "--version"], capture_output=True, text=True, check=True
    ).stdout.splitlines()[0]
    built = not native.library_path().exists()
    t0 = time.perf_counter()
    native.load()
    result = dict(
        compiler=version, flags=" ".join(native.CXX_FLAGS), library=native.library_path().name,
        built=built, seconds=time.perf_counter() - t0,
    )
    log("host runtime", json.dumps(result))
    return result


def run_flow(seed: int, card: str):
    import torch

    from verbatim_rag_tpu_torch.engine import (
        HashedBowDenseProvider,
        HashedSparseProvider,
        VerbatimIndex,
    )
    from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
    from verbatim_rag_tpu_torch.models import ModelSpanExtractor, modernbert_base_config
    from verbatim_rag_tpu_torch.rag import VerbatimRAG

    docs = sorted((ROOT / "examples" / "example_docs").glob("*.md"))
    questions = [
        "How efficient are solar panels?",
        "Why do offshore wind farms produce more energy?",
        "How is solar energy stored for the night?",
    ]
    extractor = ModelSpanExtractor(config=modernbert_base_config(), seed=seed)
    reset_counts()
    result = dict(card=card)
    # (tier, store options, candidate impls set in turn; None keeps "auto"'s)
    tiers = (
        ("bf16", {}, (None,)),
        ("int8", dict(dense_dtype="int8", sketch_dtype="int8"), (None,)),
        (
            "f32_narrow",
            dict(dense_dtype="float32", sparse_ids_dtype="int16", sparse_weight_dtype="float16"),
            ("section", "bucket"),
        ),
    )
    for tier, dtypes, impls in tiers:
        before = read_counts()
        t0 = time.perf_counter()
        index = VerbatimIndex(
            dense_provider=HashedBowDenseProvider(), sparse_provider=HashedSparseProvider(), **dtypes
        )
        index.add_documents([DocumentSchema.from_file(str(p)) for p in docs])
        rag = VerbatimRAG(index, extractor=extractor)
        ingest_s = time.perf_counter() - t0
        store = index.store
        times, n_highlights = [], 0
        for impl in impls:
            if impl is not None:
                store.candidate_impl = impl
            for q in questions:
                t0 = time.perf_counter()
                response = rag.query(q)
                times.append(time.perf_counter() - t0)
                require(bool(response.documents), f"flow {tier} {impl}: no documents for {q!r}")
                for doc in response.documents:
                    for h in doc.highlights:
                        require(
                            doc.content[h.start : h.end] == h.text,
                            f"flow {tier} {impl}: highlight not verbatim",
                        )
                        n_highlights += 1
        require(n_highlights > 0, f"flow {tier}: no highlights")
        moved = {k: v - before[k] for k, v in read_counts().items()}
        names = ["_dense", "_sp_ids", "_sp_w", "_sp_proj", "_valid_dev"]
        if tier == "int8":
            require(store.candidate_impl == "section", f"flow int8: impl {store.candidate_impl}")
            names += ["_dense_scale", "_sp_proj_scale"]
        if tier == "f32_narrow":
            dtypes_seen = (store._dense.dtype, store._sp_proj.dtype, store._sp_ids.dtype, store._sp_w.dtype)
            require(
                dtypes_seen == (torch.float32, torch.float32, torch.int16, torch.float16),
                f"flow f32_narrow: store dtypes {dtypes_seen}",
            )
            require(
                moved["section"] > 0 and moved["bucket_max_v2"] > 0 and moved["rescore"] > 0,
                f"flow f32_narrow: launches {moved}",
            )
        for name in names:
            require(getattr(store, name).is_cuda, f"flow {tier}: store.{name} not on cuda")
        result[tier] = dict(
            ingest_s=ingest_s, impls=list(impls), query_s=times, highlights=n_highlights,
            launches=moved, answer_head=response.answer[:120],
        )
    counts = read_counts()
    require(
        counts["flash_attention"] > 0 and counts["rescore"] > 0 and counts["section"] > 0,
        f"flow: launches {counts}",
    )
    require(all(p.is_cuda for p in extractor.model.parameters()), "flow: parameter not on cuda")
    result["launches"] = counts
    log("flow", json.dumps(result))
    return extractor, result


#: The serve phase: `benchmarks/bench_serving.py`'s index (neural dense +
#: SPLADE providers at MiniLM width, `max_length=256`, batches of 64 and 32,
#: 64 terms a text; the repo's markdown repeated 16 times) and its
#: micro-batcher's largest batch (64 questions) through `query_batch`.
#: Layers of the extractor the serve, http and doc phases run (the flow
#: extractor's width and seed; layers 0, 3 and 6 global): a served batch pads
#: its rows to 8192 tokens, and at all 22 layers these three phases took
#: 282 s of the script's limit on the card (PR 22's final run), which the
#: later phases need.
SERVE_LAYERS = 7
SERVE_REPEAT = 16
SERVE_DIRS = ("docs", "benchmarks", "examples")
SERVE_QUESTIONS = 64
SERVE_TIMED = 5
SERVE_ASYNC = 8
#: Provider check: the card's encodings of SERVE_CHECK_TEXTS chunk texts held
#: to the same weights on the CPU (the plain versions: float32 products of
#: the same bf16-rounded operands, attention in float32 with bf16
#: probabilities). Both round activations to bf16 at the same points but sum
#: in other orders and round P at other points, so values may differ by a
#: few bf16 ulps: dense max |Δ| within SERVE_DENSE_ATOL (four bf16 ulps of a
#: unit vector's ≈ 0.05 entries) and cosine at least SERVE_DENSE_COS;
#: SPLADE's top-64 ids at least SERVE_SPLADE_OVERLAP shared on average
#: (weights near the 64th can swap), and where an id is in both, its weights
#: within SERVE_SPLADE_RTOL (two bf16 ulps) of each other.
SERVE_CHECK_TEXTS = 512
SERVE_DENSE_ATOL = 1e-3
SERVE_DENSE_COS = 0.9999
SERVE_SPLADE_OVERLAP = 0.95
SERVE_SPLADE_RTOL = 1e-2
SERVE_TOPICS = (
    "the section tables", "the exact sparse rescore", "bucket-max", "flash attention",
    "the int8 store", "sequence parallelism", "the span extractor", "hybrid retrieval",
    "reciprocal rank fusion", "training the highlighter", "the ModernBERT encoder", "SPLADE",
    "the dense provider", "the micro-batcher", "metadata filters", "solar panels",
)
SERVE_TEMPLATES = (
    "How does {} work?", "What limits {}?", "Why is {} fast on the card?", "Where is {} measured?",
)


def serve_corpus():
    """`bench_serving.py`'s documents: every non-empty markdown file at the
    root and under `SERVE_DIRS`, repeated SERVE_REPEAT times with the copy's
    number in its title."""
    from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema

    paths = sorted(ROOT.glob("*.md")) + [
        p for d in SERVE_DIRS for p in sorted((ROOT / d).rglob("*.md"))
    ]
    sources = []
    for path in paths:
        text = path.read_text(encoding="utf-8", errors="ignore")
        if text.strip():
            sources.append((path, text))
    return [
        DocumentSchema(content=text, title=f"{path.name}#{i}", source=str(path.relative_to(ROOT)))
        for i in range(SERVE_REPEAT)
        for path, text in sources
    ]


def serve_questions() -> list[str]:
    return [t.format(topic) for topic in SERVE_TOPICS for t in SERVE_TEMPLATES][:SERVE_QUESTIONS]


def retrieved_ids(response) -> list[tuple]:
    return [(d.metadata["document_id"], d.metadata["chunk_index"]) for d in response.documents]


def answer_of(response) -> tuple:
    """A response's retrieved chunks, each with its highlights, and its answer."""
    docs = tuple(
        (d.metadata["document_id"], d.metadata["chunk_index"], tuple((h.start, h.end, h.text) for h in d.highlights))
        for d in response.documents
    )
    return docs, response.answer


def check_providers(dense, sparse, texts) -> dict:
    """The card's dense and SPLADE encodings of ``texts`` against the same
    weights on the CPU (see SERVE_DENSE_ATOL and SERVE_SPLADE_OVERLAP)."""
    import numpy as np

    from verbatim_rag_tpu_torch.models import JaxDenseProvider, JaxSpladeProvider

    cpu_dense = JaxDenseProvider(
        params=dense.model.state_dict(), config=dense.config, max_length=dense.max_length,
        batch_size=dense.batch_size, device="cpu",
    )
    cpu_sparse = JaxSpladeProvider(
        params=sparse.model.state_dict(), config=sparse.config, max_length=sparse.max_length,
        batch_size=sparse.batch_size, max_nnz=sparse.max_nnz, device="cpu",
    )
    got, ref = dense.embed_batch(texts), cpu_dense.embed_batch(texts)
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    dense_err = float(np.abs(got - ref).max())
    require(
        dense_err <= SERVE_DENSE_ATOL and float(cos.min()) >= SERVE_DENSE_COS,
        f"serve: dense provider on the card vs the CPU: max |d| {dense_err}, min cosine {cos.min()}",
    )
    g_ids, g_w = sparse.embed_batch_arrays(texts)
    r_ids, r_w = cpu_sparse.embed_batch_arrays(texts)
    overlaps, rel = [], 0.0
    for gi, gw, ri, rw in zip(g_ids, g_w, r_ids, r_w):
        ref_w = {int(t): float(w) for t, w in zip(ri, rw) if w > 0}
        got_w = {int(t): float(w) for t, w in zip(gi, gw) if w > 0}
        shared = set(ref_w) & set(got_w)
        overlaps.append(len(shared) / max(len(ref_w), 1))
        for t in shared:
            rel = max(rel, abs(got_w[t] - ref_w[t]) / max(abs(ref_w[t]), 1e-6))
    overlap = float(np.mean(overlaps))
    require(
        overlap >= SERVE_SPLADE_OVERLAP and rel <= SERVE_SPLADE_RTOL,
        f"serve: SPLADE provider on the card vs the CPU: top-{sparse.max_nnz} overlap {overlap}, "
        f"relative weight error {rel}",
    )
    return dict(
        texts=len(texts), dense_max_abs_err=dense_err, dense_min_cosine=float(cos.min()),
        splade_overlap_mean=overlap, splade_overlap_min=float(np.min(overlaps)),
        splade_max_rel_err_shared=rel,
    )


def serve_split(rag, questions) -> dict:
    """One `query_batch` with host timers (synchronized) around its stages:
    the providers' encodes, the rest of `VerbatimIndex.query_batch` (the
    store's search), `extract_spans_multi`, and the rest (templates and
    responses). Timers are instance attributes, removed afterwards."""
    import torch

    spent = {"encode": 0.0, "retrieve": 0.0, "extract": 0.0}
    shapes = []

    def timed(obj, name, stage):
        fn = getattr(obj, name)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[stage] += time.perf_counter() - t0
            return out

        setattr(obj, name, wrapper)
        return obj, name

    forward_probs = rag.extractor._forward_probs

    def record(ids, mask):
        shapes.append((list(ids.shape), int(mask.sum())))
        return forward_probs(ids, mask)

    rag.extractor._forward_probs = record
    patched = [
        (rag.extractor, "_forward_probs"),
        timed(rag.index.dense_provider, "embed_batch_device", "encode"),
        timed(rag.index.sparse_provider, "embed_query_arrays_device", "encode"),
        timed(rag.index, "query_batch", "retrieve"),
        timed(rag.extractor, "extract_spans_multi", "extract"),
    ]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rag.query_batch(questions)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for obj, name in patched:
        delattr(obj, name)
    retrieve = spent["retrieve"] - spent["encode"]
    return dict(
        wall_ms=wall * 1e3, encode_ms=spent["encode"] * 1e3, retrieve_ms=retrieve * 1e3,
        extract_ms=spent["extract"] * 1e3,
        template_ms=(wall - spent["retrieve"] - spent["extract"]) * 1e3,
        extractor_slices=[dict(rows_by_seq=shape, live_tokens=live) for shape, live in shapes],
    )


def run_serve(extractor, seed: int, card: str):
    """`bench_serving.py`'s path without HTTP: ingest the repo's markdown
    through the neural providers, warm up, then 64 questions through
    `query_batch` (each equal to `query`) and 8 through `query_async`.
    Returns the result, the RAG and each question's `query` response (the
    http phase serves the same RAG and holds every route to them)."""
    import asyncio
    import logging

    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.engine import VerbatimIndex
    from verbatim_rag_tpu_torch.models import JaxDenseProvider, JaxSpladeProvider, minilm_config
    from verbatim_rag_tpu_torch.rag import VerbatimRAG

    t_phase = time.perf_counter()
    # MiniLM leaves use_flash_attention off (plain attention, as in the JAX
    # package); the serving phase sets it so the providers' encodes run the
    # flash forward's D = 32 arm.
    config = minilm_config(use_flash_attention=True)
    dense = JaxDenseProvider(config=config, max_length=256, batch_size=64, seed=seed)
    sparse = JaxSpladeProvider(config=config, max_length=256, batch_size=32, max_nnz=64, seed=seed)
    require(dense.config.head_dim == 32 and sparse.config.head_dim == 32, "serve: not MiniLM heads")
    index = VerbatimIndex(dense_provider=dense, sparse_provider=sparse)
    rag = VerbatimRAG(index, extractor=extractor)
    docs = serve_corpus()
    questions = serve_questions()

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rag.add_documents_batch(docs)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    n_chunks = index.inspect()["num_chunks"]
    log(f"serve: {len(docs)} documents, {n_chunks} chunks ingested in {ingest_s:.3f} s")
    ingest_counts = read_counts()
    require(ingest_counts["flash_attention_d32"] > 0, f"serve: ingest launches {ingest_counts}")

    warned = []
    handler = logging.Handler(level=logging.WARNING)
    handler.emit = lambda record: warned.append(record.getMessage())
    core_log = logging.getLogger("verbatim_rag_tpu_torch.rag.core")
    core_log.addHandler(handler)
    before = read_counts()
    t0 = time.perf_counter()
    rag.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    core_log.removeHandler(handler)
    after = read_counts()
    d32 = after["flash_attention_d32"] - before["flash_attention_d32"]
    d64 = (after["flash_attention"] - after["flash_attention_d32"]) - (
        before["flash_attention"] - before["flash_attention_d32"]
    )
    require(not warned, f"serve: warm-up logged {warned}")
    require(d32 > 0 and d64 > 0, f"serve: warm-up launched the flash forward {d32} times at D=32, {d64} at D=64")

    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    batch = rag.query_batch(questions)  # untimed first call
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times = []
    for _ in range(SERVE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rag.query_batch(questions)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    singles = [rag.query(q) for q in questions]
    differ = [i for i, (a, b) in enumerate(zip(batch, singles)) if retrieved_ids(a) != retrieved_ids(b)]
    require(not differ, f"serve: query_batch retrieved other chunks than query for questions {differ}")
    # The batch pads every window to its longest and `query` to its own, so a
    # leak between rows of the extractor's pass would show here.
    differ = [i for i, (a, b) in enumerate(zip(batch, singles)) if answer_of(a) != answer_of(b)]
    require(not differ, f"serve: query_batch answered or highlighted otherwise than query for {differ}")
    n_highlights = 0
    for response in batch:
        require(len(response.documents) == rag.k, f"serve: {len(response.documents)} documents")
        for doc in response.documents:
            for h in doc.highlights:
                require(doc.content[h.start : h.end] == h.text, "serve: highlight not verbatim")
                n_highlights += 1

    async def gather():
        return await asyncio.gather(*(rag.query_async(q) for q in questions[:SERVE_ASYNC]))

    t0 = time.perf_counter()
    concurrent = asyncio.run(gather())
    torch.cuda.synchronize()
    async_s = time.perf_counter() - t0
    require(
        all(answer_of(a) == answer_of(b) for a, b in zip(concurrent, singles)),
        "serve: query_async answered otherwise than query",
    )
    counts = read_counts()
    scanner = scanner_counts()
    require(
        counts["flash_attention_d32"] > 0
        and counts["flash_attention"] > counts["flash_attention_d32"]
        and counts["rescore"] > 0,
        f"serve: launches {counts}",
    )
    require(scanner["tokenize_calls"] > 0, f"serve: the tokenizer never took the host scanner {scanner}")
    for name in ("_dense", "_sp_ids", "_sp_w", "_sp_proj"):
        require(getattr(index.store, name).is_cuda, f"serve: store.{name} not on cuda")
    require(
        all(p.is_cuda for m in (dense.model, sparse.model, extractor.model) for p in m.parameters()),
        "serve: a parameter not on cuda",
    )

    providers = check_providers(dense, sparse, index.store._enhanced[:SERVE_CHECK_TEXTS])
    log("serve providers", json.dumps(providers))
    split = serve_split(rag, questions)
    log("serve split", json.dumps(split))
    profile = device_profile(lambda: rag.query_batch(questions), top=10)
    log("serve profile", json.dumps(profile))
    host = check_scanner(list(index.store._enhanced), dense.tokenizer, "serve", reps=2)
    result = dict(
        card=card, documents=len(docs), chunks=n_chunks, ingest_s=ingest_s, warmup_s=warmup_s,
        questions=len(questions), k=rag.k, extractor_window=extractor.max_length,
        query_batch_s=times, query_batch_s_median=float(np.median(times)),
        questions_per_s=len(questions) / float(np.median(times)),
        memory_before_gb=base_gb, query_batch_peak_gb=peak_gb, highlights=n_highlights,
        async_queries=SERVE_ASYNC, async_s=async_s, providers=providers, split=split,
        launches=counts, launches_flash_d32=counts["flash_attention_d32"],
        launches_flash_d64=counts["flash_attention"] - counts["flash_attention_d32"],
        scanner=scanner, host_scanner=host, profile_wall_ms=profile["wall_ms"],
        kernel_ms=profile["kernel_ms"], idle_share=profile["idle_share"],
        phase_s=time.perf_counter() - t_phase,
    )
    log("serve", json.dumps(result))
    log(f"serve: {result['phase_s']:.1f} s")
    return result, rag, singles


#: The http phase: the serve phase's RAG behind the port's aiohttp server on
#: a socket. A micro-batch of 64 questions at 8192-token windows took
#: 3.98-7.81 s (PERF.md §5): the client's timeout stands well above it.
HTTP_TIMEOUT_S = 600
HTTP_STREAMED = 2
HTTP_TRANSFORM_CHUNKS = 3
HTTP_PROBES = (  # (method, path, body: a str goes raw, status)
    ("POST", "/api/query", {"question": ""}, 400),
    ("POST", "/api/query", "not json", 400),
    ("POST", "/api/query", {"question": "solar", "search_type": "bogus"}, 400),
    ("GET", "/api/query", None, 404),
)


def json_answer(body: dict) -> tuple:
    """`answer_of` for a response as it comes over the wire."""
    docs = tuple(
        (
            d["metadata"]["document_id"],
            d["metadata"]["chunk_index"],
            tuple((h["start"], h["end"], h["text"]) for h in d["highlights"]),
        )
        for d in body["documents"]
    )
    return docs, body["answer"]


async def ndjson_lines(content):
    """Yield each line of an NDJSON body as soon as it is complete.

    aiohttp's ``async for line in resp.content`` refuses a line longer than
    twice its read buffer (128 KiB by default), and a ``highlights`` event
    carries every retrieved chunk's whole text, so it reads raw pieces and
    splits them itself."""
    pending = bytearray()
    async for piece in content.iter_any():
        pending += piece
        *lines, rest = bytes(pending).split(b"\n")
        pending = bytearray(rest)
        for line in lines:
            yield line
    if pending:
        yield bytes(pending)


def verbatim_highlights(body: dict, what: str) -> int:
    n = 0
    for d in body["documents"]:
        for h in d["highlights"]:
            require(d["content"][h["start"] : h["end"]] == h["text"], f"{what}: highlight not verbatim")
            n += 1
    return n


def run_http(rag, extractor, singles, card: str) -> dict:
    """The port's HTTP server (`verbatim_rag_tpu_torch.api.app.create_app`,
    its micro-batcher, NDJSON stream, transform and trace routes) on
    127.0.0.1, serving the serve phase's RAG; every answer is held to that
    phase's `query` response for its question.

    The server's default extractor and the transform's offline one are
    `ModelSpanExtractor(device=...)`, whose default config draws its own
    random weights; for this phase the class hands back the serve phase's
    full-width extractor instead, so that an answer can be held to
    ``singles``."""
    import asyncio
    import logging
    import tempfile

    import numpy as np
    from aiohttp import ClientSession, ClientTimeout, web

    from verbatim_rag_tpu_torch.api import app as api_app
    from verbatim_rag_tpu_torch.api import dependencies as deps
    from verbatim_rag_tpu_torch.models import highlighter

    t_phase = time.perf_counter()
    questions = serve_questions()
    env_keys = ("API_DEBUG_TRACE", "MICRO_BATCH", "MICRO_BATCH_MAX", "INDEX_PATH", "VERBATIM_FORCE_PLATFORM")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    os.environ.update(API_DEBUG_TRACE="1", MICRO_BATCH="1", MICRO_BATCH_MAX=str(SERVE_QUESTIONS))
    os.environ.pop("VERBATIM_FORCE_PLATFORM", None)
    default_extractor = highlighter.ModelSpanExtractor
    highlighter.ModelSpanExtractor = lambda device=None, **kwargs: extractor
    warned = []
    handler = logging.Handler(level=logging.WARNING)
    handler.emit = lambda record: warned.append(f"{record.name}: {record.getMessage()}")
    package_log = logging.getLogger("verbatim_rag_tpu_torch")
    package_log.addHandler(handler)
    frontend = str(ROOT / "frontend")
    result = dict(card=card)

    async def serve(application):
        runner = web.AppRunner(application)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", 0).start()
        await application["warmup_task"]
        require(not warned, f"http: the warm-up logged {warned}")
        return runner, "http://127.0.0.1:%d" % runner.addresses[0][1]

    async def call(session, method, url, body=None):
        kwargs = {"data": body} if isinstance(body, str) else {"json": body}
        t0 = time.perf_counter()
        async with session.request(method, url, **kwargs) as resp:
            text = await resp.text()
            cors = resp.headers.get("Access-Control-Allow-Origin")
            status = resp.status
        seconds = time.perf_counter() - t0
        data = json.loads(text) if text.startswith("{") else text
        return status, data, cors, seconds

    async def get_ok(session, url):
        status, body, cors, _ = await call(session, "GET", url)
        require(status == 200 and cors == "*", f"http: GET {url} gave {status}, CORS {cors}")
        return body

    async def phase():
        n_chunks = rag.index.inspect()["num_chunks"]
        deps.reset()
        deps.set_rag(rag)
        runner, url = await serve(api_app.create_app(static_dir=frontend))
        try:
            async with ClientSession(timeout=ClientTimeout(total=HTTP_TIMEOUT_S)) as session:
                status = await get_ok(session, url + "/api/status")
                require(status["status"] == "ok" and status["num_chunks"] == n_chunks, f"http: status {status}")
                documents = (await get_ok(session, url + "/api/documents"))["documents"]
                require(len(documents) == status["num_documents"], "http: /api/documents count")
                templates = await get_ok(session, url + "/api/templates")
                require(templates["current_mode"] == "static", f"http: templates {templates}")

                # 64 concurrent questions through the micro-batcher, traced.
                with tempfile.TemporaryDirectory() as logdir:
                    started = await call(session, "POST", url + "/api/debug/trace", {"action": "start", "logdir": logdir})
                    require(started[0] == 200, f"http: trace start {started[:2]}")
                    t0 = time.perf_counter()
                    burst = await asyncio.gather(
                        *(call(session, "POST", url + "/api/query", {"question": q}) for q in questions)
                    )
                    wall_s = time.perf_counter() - t0
                    stopped = await call(session, "POST", url + "/api/debug/trace", {"action": "stop"})
                require(stopped[0] == 200, f"http: trace stop {stopped[:2]}")
                busy_ms = stopped[1]["module_wall_ms"]
                require(busy_ms is not None and busy_ms > 0, f"http: device busy {busy_ms} ms in the burst")
                differ = []
                n_highlights = 0
                for i, (code, body, cors, _) in enumerate(burst):
                    require(code == 200 and cors == "*", f"http: /api/query {i}: {code}, CORS {cors}")
                    if json_answer(body) != answer_of(singles[i]):
                        differ.append(i)
                    n_highlights += verbatim_highlights(body, f"http /api/query {i}")
                require(not differ, f"http: /api/query answered otherwise than query for {differ}")
                batching = (await get_ok(session, url + "/api/status"))["micro_batching"]
                require(
                    batching["requests"] == len(questions) and batching["batches"] < len(questions),
                    f"http: micro-batching {batching}",
                )
                latencies = np.array([b[3] for b in burst]) * 1e3
                result.update(
                    requests=len(questions), wall_s=wall_s, requests_per_s=len(questions) / wall_s,
                    latency_ms_p50=float(np.percentile(latencies, 50)),
                    latency_ms_p99=float(np.percentile(latencies, 99)),
                    device_busy_ms=busy_ms, idle_share=(wall_s * 1e3 - busy_ms) / (wall_s * 1e3),
                    micro_batching=batching, highlights=n_highlights,
                )
                log(
                    f"http burst: {len(questions)} concurrent /api/query, {result['requests_per_s']:.3f} requests/s, "
                    f"latency p50 {result['latency_ms_p50']:.1f} ms, p99 {result['latency_ms_p99']:.1f} ms, "
                    f"device busy {busy_ms} ms of {wall_s * 1e3:.1f} ms (idle share {result['idle_share']:.4f}), "
                    f"{batching['batches']} micro-batches (torch.profiler on) | {card}"
                )

                # The NDJSON stream.
                streams = []
                for i in range(HTTP_STREAMED):
                    t0 = time.perf_counter()
                    seen = []
                    async with session.post(url + "/api/query/stream", json={"question": questions[i]}) as resp:
                        require(
                            resp.status == 200 and resp.headers["Content-Type"] == "application/x-ndjson"
                            and resp.headers.get("Access-Control-Allow-Origin") == "*",
                            f"http: stream {resp.status} {dict(resp.headers)}",
                        )
                        async for line in ndjson_lines(resp.content):
                            if line.strip():
                                seen.append((json.loads(line), time.perf_counter() - t0))
                    types = [e["type"] for e, _ in seen]
                    require(types == ["documents", "progress", "highlights", "answer"], f"http: stream events {types}")
                    answer = seen[-1][0]["data"]
                    require(json_answer(answer) == answer_of(singles[i]), f"http: stream {i} answered otherwise")
                    verbatim_highlights(seen[2][0]["data"], "http stream")
                    streams.append(dict(
                        documents_ms=seen[0][1] * 1e3, answer_ms=seen[-1][1] * 1e3,
                        timings=seen[-1][0]["timings"],
                    ))
                result["stream"] = streams
                log(
                    "http stream: "
                    + "; ".join(f"documents at {s['documents_ms']:.1f} ms, answer at {s['answer_ms']:.1f} ms" for s in streams)
                    + f" | {card}"
                )

                # The async route and the stateless transform.
                i = HTTP_STREAMED
                code, body, _, _ = await call(session, "POST", url + "/api/query_async", {"question": questions[i]})
                require(code == 200 and json_answer(body) == answer_of(singles[i]), "http: /api/query_async differs")
                best = max(
                    range(len(singles)),
                    key=lambda j: sum(len(d.highlights) for d in singles[j].documents[:HTTP_TRANSFORM_CHUNKS]),
                )
                chunks = singles[best].documents[:HTTP_TRANSFORM_CHUNKS]
                context = [{"content": d.content, "title": d.title, "metadata": d.metadata} for d in chunks]
                code, body, _, _ = await call(
                    session, "POST", url + "/api/transform/verbatim", {"question": questions[best], "context": context}
                )
                require(code == 200, f"http: transform {code} {str(body)[:300]}")
                got = [[(h["start"], h["end"], h["text"]) for h in d["highlights"]] for d in body["documents"]]
                expected = [[(h.start, h.end, h.text) for h in d.highlights] for d in chunks]
                require(got == expected, "http: the transform highlighted otherwise than query")
                result["transform_highlights"] = verbatim_highlights(body, "http transform")
                require(result["transform_highlights"] > 0, "http: the transform found no highlight")

                # Probes.
                for method, path, payload, expected_status in HTTP_PROBES:
                    code, _, cors, _ = await call(session, method, url + path, payload)
                    require(code == expected_status and cors == "*", f"http: {method} {path}: {code}, CORS {cors}")
        finally:
            await runner.cleanup()

        # A fresh server that loads the index from INDEX_PATH.
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            rag.index.save(os.path.join(tmp, "idx"))
            save_s = time.perf_counter() - t0
            deps.reset()
            os.environ["INDEX_PATH"] = os.path.join(tmp, "idx")
            t0 = time.perf_counter()
            runner, url = await serve(api_app.create_app(static_dir=frontend))
            startup_s = time.perf_counter() - t0
            try:
                async with ClientSession(timeout=ClientTimeout(total=HTTP_TIMEOUT_S)) as session:
                    status = await get_ok(session, url + "/api/status")
                    require(status["num_chunks"] == n_chunks, f"http: loaded {status['num_chunks']} of {n_chunks}")
                    code, body, _, _ = await call(session, "POST", url + "/api/query", {"question": questions[0]})
                    require(code == 200 and json_answer(body) == answer_of(singles[0]), "http: the loaded server differs")
                loaded = deps.get_index()
                for name in ("_dense", "_sp_ids", "_sp_w", "_sp_proj"):
                    require(getattr(loaded.store, name).is_cuda, f"http: loaded store.{name} not on cuda")
                for provider in (loaded.dense_provider, loaded.sparse_provider):
                    require(all(p.is_cuda for p in provider.model.parameters()), "http: loaded provider off the card")
            finally:
                await runner.cleanup()
        result.update(save_s=save_s, startup_from_disk_s=startup_s)

    reset_counts()
    try:
        asyncio.run(phase())
    finally:
        highlighter.ModelSpanExtractor = default_extractor
        package_log.removeHandler(handler)
        deps.reset()
        api_app._transform_cache = None
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    counts = read_counts()
    d32 = counts["flash_attention_d32"]
    d64 = counts["flash_attention"] - d32
    require(d64 > 0 and d32 > 0 and counts["rescore"] > 0, f"http: launches {counts}")
    for name in ("_dense", "_sp_ids", "_sp_w", "_sp_proj"):
        require(getattr(rag.index.store, name).is_cuda, f"http: store.{name} not on cuda")
    require(all(p.is_cuda for p in extractor.model.parameters()), "http: an extractor parameter not on cuda")
    require(not warned, f"http: logged {warned}")
    result.update(launches=counts, launches_flash_d64=d64, launches_flash_d32=d32, phase_s=time.perf_counter() - t_phase)
    log("http", json.dumps(result))
    log(f"http: {result['phase_s']:.1f} s")
    return result



#: The doc phase: the serve corpus as HTML pages, a few of them fetched over
#: a local server by URL; dense vectors at text-embedding-3-large's width
#: (3072, int8 rows of 3072 bytes: the wgmma walk's streamed arm) from an
#: OpenAI-compatible stub on 127.0.0.1; a report of 64 directives, one per
#: (topic, template) of the serve questions, under a header a topic, two
#: `k` values (so two `query_batch` calls).
DOC_DIM = 3072
DOC_MODEL = "text-embedding-3-large"
DOC_URL_PAGES = 4  # half through `DocumentSchema.from_url`, half through `process_url`
DOC_KS = (5, 3)
DOC_ENHANCED = 8


def markdown_page(text: str, title: str) -> str:
    """A markdown document as an HTML page: ``#`` headings as <h1>, deeper
    ones as <h2>, every other run of lines as one <p>."""
    import html

    parts, para = [], []

    def flush():
        if para:
            parts.append("<p>" + html.escape(" ".join(para)) + "</p>")
            para.clear()

    for line in text.splitlines():
        m = re.match(r"^(#{1,6})\s+(.*)$", line)
        if m:
            flush()
            tag = "h1" if len(m.group(1)) == 1 else "h2"
            parts.append(f"<{tag}>{html.escape(m.group(2).strip())}</{tag}>")
        elif line.strip():
            para.append(line.strip())
        else:
            flush()
    flush()
    return f"<!DOCTYPE html><html><head><title>{html.escape(title)}</title></head><body>{''.join(parts)}</body></html>"


class DocServer:
    """A local HTTP server on 127.0.0.1 (port 0) in a thread: GET
    ``/pages/<name>`` serves a file of ``pages``; POST ``/v1/embeddings``
    answers as an OpenAI-compatible endpoint with `HashedBowDenseProvider`
    vectors at the requested model's width. ``embed_s`` sums the seconds its
    handler spent embedding and encoding."""

    def __init__(self, pages: Path, dim: int):
        import http.server
        import threading

        from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider

        embed = HashedBowDenseProvider(dim=dim)
        owner = self
        self.embed_s, self.embed_requests, self.page_requests = 0.0, 0, 0
        lock = threading.Lock()  # the handler threads add to the counts

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, body: bytes, ctype: str, status: int = 200):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = pages / self.path.removeprefix("/pages/")
                if not self.path.startswith("/pages/") or not path.is_file():
                    return self._send(b"not found", "text/plain", 404)
                with lock:
                    owner.page_requests += 1
                self._send(path.read_bytes(), "text/html; charset=utf-8")

            def do_POST(self):
                t0 = time.perf_counter()
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                data = [
                    {"object": "embedding", "index": i, "embedding": embed.embed_text(t).tolist()}
                    for i, t in enumerate(body["input"])
                ]
                out = json.dumps({"object": "list", "data": data, "model": body["model"]}).encode()
                with lock:
                    owner.embed_s += time.perf_counter() - t0
                    owner.embed_requests += 1
                self._send(out, "application/json")

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = "http://127.0.0.1:%d" % self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


def doc_report() -> tuple[str, list]:
    """The report (a header a topic, its four templates' questions as
    directives, the first two at the default k, the other two at the second
    k) and its directives' (section, question, k)."""
    lines, directives = ["# The system, by topic", ""], []
    for topic in SERVE_TOPICS:
        lines += [f"## {topic}", ""]
        for j, template in enumerate(SERVE_TEMPLATES):
            question = template.format(topic)
            k = DOC_KS[0] if j < 2 else DOC_KS[1]
            param = "" if k == DOC_KS[0] else f"|k={k}"
            lines += [f"{question} [!query={question}{param}]", ""]
            directives.append((topic, question, k))
    return "\n".join(lines), directives


def doc_hits(rows) -> list:
    return [[(h.metadata["document_id"], h.metadata["chunk_index"], h.score) for h in r] for r in rows]


def doc_section_check(calls) -> dict:
    """The doc path's section call held to the plain version at the shapes
    the path gave it: the first recorded call of `VerbatimDOC.process` (the
    store's own rows, scales and mask, a 32-query batch, a partial tile; the
    3072-byte dense arm streamed and the int8 sketch arm resident, so two
    launches), both tables bit-equal, and the planted faults (the first
    position of each block dropped, the queries in reverse order) caught."""
    import torch

    from verbatim_rag_tpu_torch.ops import fused_topk as ft
    from verbatim_rag_tpu_torch.ops import section as sec

    require(len(calls) == len(DOC_KS), f"doc: {len(calls)} section calls in process")
    corpora, queries, mask, scales, block = calls[0]
    n = corpora[0].shape[0]
    row_bytes = [c.shape[1] * c.element_size() for c in corpora]
    layouts = [ft.walk_streams(b) for b in row_bytes]
    require(
        all(c.dtype == torch.int8 for c in corpora) and layouts == [True, False] and mask is not None,
        f"doc: section arms of {row_bytes} bytes, streamed {layouts}",
    )
    require(len(sec.plan_section_launches([(c.dtype, b) for c, b in zip(corpora, row_bytes)])) == 2,
            "doc: the section call is not two launches")
    got = sec.section_tables_cuda(corpora, queries, mask, scales, block)
    torch.cuda.synchronize()
    ref = sec.section_tables_reference(corpora, queries, mask, scales, block)
    err = max(
        check_table(sec_decode(g, block, n), sec_decode(e, block, n), c, q, True)
        for g, e, c, q in zip(got, ref, corpora, queries)
    )
    # (The live rows fill the first block only in part, and every bucket
    # holds live rows whose scores are not below a dead row's, so the faults
    # are the first position of each block dropped, not the last, and the
    # batch's queries in reverse order, not the mask ignored.)
    first = (torch.arange(n, device=mask.device) % block) // 128 == 0
    faults = {}
    for name, fault_q, fault_mask in (
        ("first position of each block dropped", queries, mask & ~first),
        ("queries in reverse order", tuple(q.flip(0) for q in queries), mask),
    ):
        why = section_fault(
            sec.section_tables_cuda(corpora, fault_q, fault_mask, scales, block), ref, corpora, queries, block, True
        )
        require(why is not None, f"doc: section planted fault '{name}' passes the check")
        faults[name] = why
    out = dict(
        n=n, block=block, batch=queries[0].shape[0], row_bytes=row_bytes, streamed=layouts,
        max_abs_err=err, planted_faults_caught=faults,
    )
    log("doc section at the path's shapes", json.dumps(out))
    return out


def run_doc(extractor, seed: int, card: str, device=None) -> dict:
    """The orchestration modules on the card: HTML pages ingested through
    `DocumentProcessor.process_directory` and, over a local server, through
    `DocumentSchema.from_url` / `process_url`; an int8 index (dense 3072 and
    sketch int8, "auto" → the section kernel's streamed arm, then the
    rescore) whose dense vectors come from `OpenAIEmbeddingProvider` against
    a stub on 127.0.0.1, held equal to the index built from the stub's
    vectors directly; `VerbatimDOC.process` of a 64-directive report (two
    `query_batch` calls, each directive's spans those of `query`, the splice
    and numbering those `Replacer` builds from the `query` answers, which
    one `stream_process` asks for); `verbatim_enhance` around
    `IndexProvider.retrieve`
    answering as `VerbatimTransform.transform` on the same contexts. The
    serve phase's extractor (full width, flash on) answers."""
    import asyncio
    import tempfile

    import torch

    from verbatim_rag_tpu_torch.core import TemplateManager, VerbatimTransform, verbatim_enhance
    from verbatim_rag_tpu_torch.engine import (
        HashedBowDenseProvider,
        HashedSparseProvider,
        OpenAIEmbeddingProvider,
        VerbatimIndex,
    )
    from verbatim_rag_tpu_torch.ingestion.document_processor import DocumentProcessor
    from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
    from verbatim_rag_tpu_torch.ops import fused_topk as ft
    from verbatim_rag_tpu_torch.ops import section as sec
    from verbatim_rag_tpu_torch.rag import IndexProvider, VerbatimDOC, VerbatimRAG
    from verbatim_rag_tpu_torch.rag.verbatim_doc import Processor

    t_phase = time.perf_counter()
    for key in [k for k in os.environ if k.lower().endswith("_proxy")]:
        del os.environ[key]  # every request of the phase goes to 127.0.0.1
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_doc_"))
    server = None
    try:
        local, remote = tmp / "local", tmp / "pages"
        local.mkdir()
        remote.mkdir()
        corpus = serve_corpus()
        for i, doc in enumerate(corpus):
            folder = remote if i < DOC_URL_PAGES else local
            (folder / f"{i:04d}.html").write_text(markdown_page(doc.content, doc.title), encoding="utf-8")
        server = DocServer(remote, DOC_DIM)
        t0 = time.perf_counter()
        docs = list(DocumentProcessor().process_directory(str(local)))
        urls = [f"{server.url}/pages/{p.name}" for p in sorted(remote.iterdir())]
        half = DOC_URL_PAGES // 2
        fetched = [DocumentSchema.from_url(u) for u in urls[:half]]
        fetched += [DocumentProcessor().process_url(u) for u in urls[half:]]
        convert_s = time.perf_counter() - t0
        require(len(docs) == len(corpus) - DOC_URL_PAGES, f"doc: {len(docs)} pages converted")
        require(
            all(f.content == DocumentProcessor().extract_content_from_file(str(remote / u.rsplit("/", 1)[1]))
                for f, u in zip(fetched, urls)),
            "doc: a fetched page differs from the same file converted",
        )
        require(server.page_requests == DOC_URL_PAGES, f"doc: {server.page_requests} page requests")
        sources = [*docs, *fetched]

        def make_index(dense):
            return VerbatimIndex(
                dense_provider=dense, sparse_provider=HashedSparseProvider(), dense_dtype="int8",
                sketch_dtype="int8", device=device,
            )

        index = make_index(OpenAIEmbeddingProvider(model=DOC_MODEL, api_base=server.url + "/v1"))
        require(index.dense_provider.get_dimension() == DOC_DIM, "doc: the model's default width")
        require(index.store.candidate_impl == "section", f"doc: impl {index.store.candidate_impl}")
        # The main path's runs (ingest, process, stream_process, enhance),
        # each with the counts zeroed just before it and read just after; the
        # comparison runs between them are not counted.
        main_runs = {}

        def counted(name, fn):
            reset_counts()
            out = fn()
            torch.cuda.synchronize()
            main_runs[name] = read_counts() if name not in main_runs else {
                k: v + main_runs[name][k] for k, v in read_counts().items()
            }
            return out

        t0 = time.perf_counter()
        counted("ingest", lambda: index.add_documents_bulk(sources))
        ingest_s = time.perf_counter() - t0
        n_chunks = index.inspect()["num_chunks"]
        row_bytes = index.store._dense.shape[1] * index.store._dense.element_size()
        require(ft.walk_streams(row_bytes) and row_bytes == DOC_DIM, f"doc: dense rows of {row_bytes} bytes")
        log(f"doc: {len(sources)} pages, {n_chunks} chunks, converted in {convert_s:.2f} s, "
            f"ingested in {ingest_s:.2f} s ({server.embed_requests} embedding requests, "
            f"{server.embed_s:.2f} s in the stub)")

        ref = make_index(HashedBowDenseProvider(dim=DOC_DIM))
        ref.add_documents_bulk(sources)
        for name in ("_dense", "_dense_scale", "_sp_proj", "_sp_proj_scale", "_sp_ids", "_sp_w"):
            require(torch.equal(getattr(index.store, name), getattr(ref.store, name)), f"doc: store.{name} differs")
        questions = serve_questions()
        for k in DOC_KS:
            require(
                doc_hits(index.query_batch(questions, k=k)) == doc_hits(ref.query_batch(questions, k=k)),
                f"doc: the stub's index answers otherwise than the vectors' at k={k}",
            )
        del ref

        rag = VerbatimRAG(index, extractor=extractor)
        report, directives = doc_report()
        calls = []
        batch = rag.query_batch

        def timed_batch(qs, k=5, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = batch(qs, k=k, **kw)
            end.record()
            calls.append((len(qs), k, start, end))
            return out

        rag.query_batch = timed_batch
        section_calls = []
        section_tables = sec.section_bucket_tables

        def recorded_tables(corpora, queries, mask, scales=(), block_cols=sec.BLOCK_COLS):
            section_calls.append((corpora, queries, mask, scales, block_cols))
            return section_tables(corpora, queries, mask, scales, block_cols)

        sec.section_bucket_tables = recorded_tables
        t0 = time.perf_counter()
        try:
            response = counted("process", lambda: VerbatimDOC(rag).process(report))
        finally:
            sec.section_bucket_tables = section_tables
        process_s = time.perf_counter() - t0
        del rag.query_batch
        counts = main_runs["process"]
        require(
            [(n, k) for n, k, _, _ in calls] == [(32, DOC_KS[0]), (32, DOC_KS[1])],
            f"doc: query_batch calls {[(n, k) for n, k, _, _ in calls]}",
        )
        batch_ms = [start.elapsed_time(end) for _, _, start, end in calls]
        require(
            counts["section"] == 2 and counts["section_streamed"] == 2 and counts["rescore"] == 2
            and counts["flash_attention"] > 0,
            f"doc: process launches {counts}",
        )
        require(
            [(r.query.section, r.query.text, r.query.params.get("k", DOC_KS[0])) for r in response.queries]
            == directives and not any(r.error for r in response.queries),
            "doc: the directives parsed or ran otherwise",
        )
        path_tables = doc_section_check(section_calls)
        del section_calls

        # `stream_process` runs each directive through `query` in order: its
        # calls are recorded and are the answers the batches are held to.
        singles = []
        query = rag.query

        def recorded_query(question, k=5, **kw):
            singles.append((question, k, query(question, k=k, **kw)))
            return singles[-1][2]

        async def events():
            return [e async for e in VerbatimDOC(rag).stream_process(report)]

        rag.query = recorded_query
        t0 = time.perf_counter()
        streamed = counted("stream_process", lambda: asyncio.run(events()))
        stream_s = time.perf_counter() - t0
        del rag.query
        require(
            [e["type"] for e in streamed] == ["start"] + ["progress", "query_complete"] * len(directives) + ["done"]
            and streamed[-1]["document"] == response.document
            and streamed[-1]["citations"] == response.citations,
            "doc: stream_process ended otherwise than process",
        )
        processor = Processor(rag)
        require(
            [(q, k) for q, k, _ in singles]
            == [(processor._question(r.query), r.query.params.get("k", DOC_KS[0])) for r in response.queries],
            "doc: stream_process asked other questions than the directives",
        )
        expected = [processor._collect(r.query, s) for r, (_, _, s) in zip(response.queries, singles)]
        differ = [i for i, (r, e) in enumerate(zip(response.queries, expected)) if r.spans != e.spans]
        require(not differ, f"doc: directives {differ} got other spans than query")
        spliced = VerbatimDOC(rag)._build_response(report, expected)
        require(
            response.document == spliced.document and response.citations == spliced.citations,
            "doc: the splice or its numbering differs from Replacer's over the query answers",
        )
        # (The corpus quotes directive syntax, so spans may hold "[!query".)
        n_spans = sum(len(r.spans) for r in response.queries)
        require(n_spans > 0 and response.citations, f"doc: {n_spans} spans, {len(response.citations)} citations")

        provider = IndexProvider(index)
        transform = VerbatimTransform(extractor=extractor, template_manager=TemplateManager(default_mode="static"))
        wrapped = verbatim_enhance(transform=transform)(lambda question: provider.retrieve(question))
        enhanced = 0
        for question in questions[:DOC_ENHANCED]:
            got = counted("enhance", lambda: wrapped(question))
            want = transform.transform(question, provider.retrieve(question))
            require(got.model_dump() == want.model_dump(), f"doc: verbatim_enhance answered {question!r} otherwise")
            enhanced += sum(len(d.highlights) for d in got.documents)

        first = [processor._question(r.query) for r in response.queries if r.query.params.get("k", DOC_KS[0]) == DOC_KS[0]]
        profile = device_profile(lambda: rag.query_batch(first, k=DOC_KS[0]))  # the report's first batch
        log("doc profile", json.dumps(profile))
        result = dict(
            card=card, pages=len(sources), pages_by_url=DOC_URL_PAGES, chunks=n_chunks, dense_dim=DOC_DIM,
            dense_row_bytes=row_bytes, convert_s=convert_s, ingest_s=ingest_s,
            stub_embed_s=server.embed_s, stub_embed_requests=server.embed_requests,
            directives=len(directives), query_batch_calls=len(calls),
            query_batch_event_ms=batch_ms, process_s=process_s, stream_process_s=stream_s,
            spans=n_spans, citations=len(response.citations), enhanced_highlights=enhanced,
            idle_share=profile["idle_share"], profile_wall_ms=profile["wall_ms"],
            profile_kernel_ms=profile["kernel_ms"], section_at_path_shapes=path_tables,
            launches_by_run=main_runs,
            launches={k: sum(run[k] for run in main_runs.values()) for k in main_runs["process"]},
            phase_s=time.perf_counter() - t_phase,
        )
        log("doc", json.dumps(result))
        log(f"doc: {result['phase_s']:.1f} s")
        del rag, index
        return result
    finally:
        if server is not None:
            server.close()
        shutil.rmtree(tmp, ignore_errors=True)


def median_ms(fn, reps: int = 10) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` calls, each between
    its own CUDA events, after one warm-up call."""
    import numpy as np
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def run_bucket_ab(gen, card: str) -> dict:
    """The port's counterpart of `benchmarks/bench_fused_bucket.py`: candidate
    top-k (k=256) of 512 unit queries over 999,424 normal bf16 rows, all
    live, at d = 384 and 768, by three arms: the score matrix and exact
    top-k (`candidate_topk(impl="xla")`: the port has no approx_max_k), v1
    (`fused_candidate_topk`) and v2 (`fused_candidate_topk_v2`, both variant
    names, one kernel). Each arm's median ms and its candidate overlap with
    the exact set; a bucket kernel below 0.95 fails."""
    import torch

    from verbatim_rag_tpu_torch.ops.dense import candidate_topk
    from verbatim_rag_tpu_torch.ops.fused_topk import fused_candidate_topk, fused_candidate_topk_v2

    arms = {
        "xla_exact_topk": lambda c, q, m: candidate_topk(c, q, AB_K, m, impl="xla"),
        "v1": lambda c, q, m: fused_candidate_topk(c, q, AB_K, m),
        "v2_onedot": lambda c, q, m: fused_candidate_topk_v2(c, q, AB_K, m, variant="onedot"),
        "v2_chunked": lambda c, q, m: fused_candidate_topk_v2(c, q, AB_K, m, variant="chunked"),
    }
    reset_counts()
    result = dict(card=card, n=AB_ROWS, batch=AB_BATCH, k=AB_K)
    for d in (384, 768):
        corpus = torch.randn(AB_ROWS, d, generator=gen, device="cuda").to(torch.bfloat16)
        q = torch.randn(AB_BATCH, d, generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        mask = torch.ones(AB_ROWS, dtype=torch.bool, device="cuda")
        _, exact = arms["xla_exact_topk"](corpus, q, mask)
        exact_sets = [set(r) for r in exact.tolist()]
        cell = {}
        for name, fn in arms.items():
            _, rows = fn(corpus, q, mask)
            require(tuple(rows.shape) == (AB_BATCH, AB_K) and bool((rows >= 0).all()), f"bucket_ab {name}: rows")
            overlap = sum(len(e & set(r)) for e, r in zip(exact_sets, rows.tolist())) / (AB_BATCH * AB_K)
            cell[name] = dict(ms=median_ms(lambda: fn(corpus, q, mask)), overlap=overlap)
        for name in ("v1", "v2_onedot", "v2_chunked"):
            require(cell[name]["overlap"] >= 0.95, f"bucket_ab d={d}: {name} overlap {cell[name]['overlap']}")
        result[f"d{d}"] = cell
        log("bucket_ab", json.dumps({"d": d, **cell}))
        del corpus, q, mask, exact
        torch.cuda.empty_cache()
    counts = read_counts()
    require(counts["bucket_max_v1"] > 0 and counts["bucket_max_v2"] > 0, f"bucket_ab: launches {counts}")
    result["launches"] = counts
    log("bucket_ab", json.dumps(result))
    return result


def bench_data(seed: int) -> dict:
    """The store phases' records and query batches (`bench.py`'s operating
    point): 1M chunks, dense 384, 128-nnz forward index, 32 query terms."""
    import numpy as np

    dim, nnz, vocab, batch, qm = 384, 128, 30522, 512, 32
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((STORE_ROWS, dim), dtype=np.float32)
    ids = rng.integers(1, vocab, size=(STORE_ROWS, nnz), dtype=np.int32)
    weights = rng.random((STORE_ROWS, nnz), dtype=np.float32)
    records = [
        {"id": str(i), "dense": dense[i], "sparse_arrays": (ids[i], weights[i])}
        for i in range(STORE_ROWS)
    ]

    def queries(i):
        r = np.random.default_rng(seed + 1 + i)
        src = r.integers(0, STORE_ROWS, size=batch)
        q_dense = dense[src] + 0.5 * r.standard_normal((batch, dim), dtype=np.float32)
        q_ids = ids[src, :qm].copy()
        q_ids[:, qm // 2 :] = r.integers(1, vocab, size=(batch, qm - qm // 2))
        q_w = r.random((batch, qm), dtype=np.float32)
        return q_dense, (q_ids, q_w), src

    return dict(
        dim=dim, nnz=nnz, vocab=vocab, batch=batch, records=records, queries=queries,
        arrays=dict(dense=dense, ids=ids, weights=weights),
    )


def fill_store(data, records=None, **kwargs):
    """A store on the card filled with the bench records (or ``records``);
    (store, ingest s, state GB)."""
    import torch

    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

    from verbatim_rag_tpu_torch.ops.fused_topk import resident_bytes

    store = DeviceVectorStore(
        dense_dim=data["dim"], sparse_vocab=data["vocab"], sparse_max_nnz=data["nnz"], **kwargs
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.add_vectors(data["records"] if records is None else records)
    store.flush()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    arrays = (
        "_dense", "_dense_scale", "_sp_ids", "_sp_w", "_sp_proj", "_sp_proj_scale", "_valid_dev",
        "_ft_ids", "_ft_tf", "_ft_w", "_ft_proj", "_ft_proj_scale",
    )
    state_gb = sum(resident_bytes(t) for t in (getattr(store, a) for a in arrays) if t is not None) / 1e9
    return store, ingest_s, state_gb


def timed_batches(store, data, first: int, count: int, top_k: int):
    """Host ms of each batch, and the ms the Python collector spent in full
    (generation 2) collections inside it."""
    import gc

    import torch

    times, gc_ms = [], []
    started = []

    def on_gc(phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            gc_ms[-1] += (time.perf_counter() - started.pop()) * 1e3

    gc.callbacks.append(on_gc)
    try:
        for i in range(first, first + count):
            b_dense, b_sparse, _ = data["queries"](i)
            torch.cuda.synchronize()
            gc_ms.append(0.0)
            t0 = time.perf_counter()
            out = store.query_batch(dense_queries=b_dense, sparse_queries=b_sparse, top_k=top_k)
            times.append((time.perf_counter() - t0) * 1e3)
            require(len(out) == data["batch"], "store: batch size")
    finally:
        gc.callbacks.remove(on_gc)
    return times, gc_ms


def first_batch(store, data, top_k: int, what: str):
    import numpy as np

    q_dense, q_sparse, src = data["queries"](0)
    first = store.query_batch(dense_queries=q_dense, sparse_queries=q_sparse, top_k=top_k)
    require(len(first) == data["batch"] and all(len(r) == top_k for r in first), f"{what}: result shape")
    require(all(math.isfinite(h.score) and h.score > 0 for r in first for h in r), f"{what}: scores")
    hit = float(np.mean([str(s) in {h.id for h in r} for s, r in zip(src, first)]))
    return first, hit


def run_store(data, card: str) -> dict:
    import numpy as np
    import torch

    top_k, n_batches = 10, STORE_BATCHES
    reset_counts()
    store, ingest_s, state_gb = fill_store(data)
    first, hit = first_batch(store, data, top_k, "store")
    times, gc_ms = timed_batches(store, data, 1, n_batches, top_k)
    counts = read_counts()
    require(counts["rescore"] == n_batches + 1, f"store: launches {counts}")
    differ = same_rows_with_plain_rescore(store, data, first, top_k, "store")
    q_dense, q_sparse, _ = data["queries"](1)
    profile = device_profile(
        lambda: store.query_batch(dense_queries=q_dense, sparse_queries=q_sparse, top_k=top_k)
    )
    log("store profile", json.dumps(profile))
    ms = float(np.median(times))
    result = dict(
        card=card, rows=STORE_ROWS, capacity=store._capacity, state_gb=state_gb, ingest_s=ingest_s,
        batch=data["batch"], batch_ms_median=ms, batch_ms=times, qps=data["batch"] / ms * 1e3,
        gc_full_ms=gc_ms, source_row_in_top10=hit, queries_differing_from_plain_on_a_tie=differ,
        launches=counts,
    )
    log("store", json.dumps(result))
    del store
    torch.cuda.empty_cache()
    return result


def same_rows_with_plain_rescore(store, data, first, top_k: int, what: str) -> int:
    """The first batch with the plain rescore must give the same rows on
    every query. A query may differ only where the rescore's float32 sums,
    taken in another order, reorder a near-tie: its sparse arm (the
    sparse-only query at the hybrid's fetch depth, 2·top_k) must then differ,
    and only at positions whose exact scores tie within 1e-6 relative.
    Returns the count of such queries."""
    q_dense, q_sparse, _ = data["queries"](0)
    kernel_sparse = store.query_batch(sparse_queries=q_sparse, top_k=2 * top_k)
    store.rescore_impl = "oneshot"
    try:
        plain = store.query_batch(dense_queries=q_dense, sparse_queries=q_sparse, top_k=top_k)
        plain_sparse = store.query_batch(sparse_queries=q_sparse, top_k=2 * top_k)
    finally:
        store.rescore_impl = "pallas"
    differ = 0
    for b in range(data["batch"]):
        if [h.id for h in first[b]] == [h.id for h in plain[b]]:
            continue
        differ += 1
        pairs = list(zip(kernel_sparse[b], plain_sparse[b]))
        require(
            len(kernel_sparse[b]) == len(plain_sparse[b])
            and any(x.id != y.id for x, y in pairs)
            and all(
                x.id == y.id or abs(x.score - y.score) <= 1e-6 * max(x.score, y.score)
                for x, y in pairs
            ),
            f"{what}: query {b} rows differ from the plain rescore's without a score tie",
        )
    return differ


def same_rows_with_plain_tables(store, data, top_k: int, expected, what: str, text_queries=None) -> None:
    """The first batch again with the table kernels' plain versions in their
    place: int8 tables are bit-equal and everything after them is the same
    code, so every query must give the same rows."""
    from verbatim_rag_tpu_torch.ops import fused_topk as ft
    from verbatim_rag_tpu_torch.ops import section as sec

    kernels = (sec.section_tables_cuda, ft.matmul_bucket_max_v2_cuda)
    sec.section_tables_cuda = sec.section_tables_reference
    ft.matmul_bucket_max_v2_cuda = ft.matmul_bucket_max_v2_reference
    try:
        q_dense, q_sparse, _ = data["queries"](0)
        plain = store.query_batch(
            dense_queries=q_dense, sparse_queries=q_sparse, text_queries=text_queries, top_k=top_k
        )
    finally:
        sec.section_tables_cuda, ft.matmul_bucket_max_v2_cuda = kernels
    for b in range(data["batch"]):
        require(
            [h.id for h in expected[b]] == [h.id for h in plain[b]],
            f"{what}: query {b} rows differ from the plain tables'",
        )


def run_store_int8(data, card: str) -> dict:
    """The int8 tier: section path under "auto", then the bucket path."""
    import numpy as np
    import torch

    top_k, n_batches = 10, STORE_BATCHES
    reset_counts()
    store, ingest_s, state_gb = fill_store(data, dense_dtype="int8", sketch_dtype="int8")
    require(store.candidate_impl == "section", f"store_int8: impl {store.candidate_impl}")
    first, hit = first_batch(store, data, top_k, "store_int8")
    data["int8_first_rows"] = [[h.id for h in r] for r in first]  # the int4 phase's yardstick
    data["int8_bytes"] = matrix_bytes(store)
    times, gc_ms = timed_batches(store, data, 1, n_batches, top_k)
    store.candidate_impl = "bucket"
    bucket_first, bucket_hit = first_batch(store, data, top_k, "store_int8 bucket")
    bucket_times, bucket_gc_ms = timed_batches(store, data, 1, BUCKET_BATCHES, top_k)
    counts = read_counts()
    require(
        counts["section"] == n_batches + 1
        and counts["bucket_max_v2"] == 2 * (BUCKET_BATCHES + 1)
        and counts["rescore"] == n_batches + BUCKET_BATCHES + 2,
        f"store_int8: launches {counts}",
    )
    same_rows_with_plain_tables(store, data, top_k, bucket_first, "store_int8 bucket")
    store.candidate_impl = "section"
    same_rows_with_plain_tables(store, data, top_k, first, "store_int8")
    q_dense, q_sparse, _ = data["queries"](1)
    profiles = {}
    for impl in ("section", "bucket"):  # one batch of each candidate path
        store.candidate_impl = impl
        profiles[impl] = device_profile(
            lambda: store.query_batch(dense_queries=q_dense, sparse_queries=q_sparse, top_k=top_k)
        )
        log(f"store_int8 {impl} profile", json.dumps(profiles[impl]))
    store.candidate_impl = "section"
    _, event_ms = event_batches(store, data, 1, 3, top_k)  # beside the ragged phase's
    ms = float(np.median(times))
    result = dict(
        card=card, rows=STORE_ROWS, capacity=store._capacity, state_gb=state_gb, ingest_s=ingest_s,
        batch=data["batch"], batch_ms_median=ms, batch_ms=times, qps=data["batch"] / ms * 1e3,
        batch_event_ms=event_ms, batch_event_ms_median=float(np.median(event_ms)),
        gc_full_ms=gc_ms, source_row_in_top10=hit, bucket_batch_ms=bucket_times,
        bucket_gc_full_ms=bucket_gc_ms, bucket_source_row_in_top10=bucket_hit, launches=counts,
    )
    log("store_int8", json.dumps(result))
    del store
    torch.cuda.empty_cache()
    return result


# -- phase 5e: ragged -------------------------------------------------------------------

#: Phase ragged: rows whose width is not a multiple of 16 bytes, which TMA
#: cannot take as a row stride. The store keeps such rows at a 16-byte pitch
#: (`fused_topk.pitched_zeros`). `RAGGED_DIM` is the width of
#: sentence-transformers/average_word_embeddings_glove.6B.300d.
RAGGED_DIM = 300
#: The kernel arms at ragged widths, each against its plain version at B=512,
#: N=1,048,576 (blocks of 16384): (columns, row dtype); v1 takes the bf16 and
#: float32 ones. The streamed arms' rows are 3000 bytes, past 2944.
RAGGED_ROWS = ((300, "int8"), (300, "bfloat16"), (301, "float32"))
RAGGED_STREAMED = ((3000, "int8"), (1500, "bfloat16"))
RAGGED_N, RAGGED_BLOCK, RAGGED_BATCH = 64 * 16384, 16384, 512
#: Launches whose batch passes the grid's 65,535 rows on y: the flash
#: kernels at MiniLM's 12 heads of 32 (batch × heads = 65,544: one past the
#: limit plus eight) and the rescore at 65,600 queries of 16 candidates.
GRID_FLASH = dict(batch=5462, heads=12, head_dim=32, seq=128)
GRID_RESCORE = dict(batch=65_600, cands=16)
#: Batch rows the plain versions of the grid checks take at a time.
GRID_PLAIN_ROWS = 1024


def pad_columns(t, cols: int):
    """``t`` [n, d] zero-padded to [n, cols], contiguous."""
    import torch

    out = torch.zeros((t.shape[0], cols), dtype=t.dtype, device=t.device)
    out[:, : t.shape[1]] = t
    return out


def ragged_arm(gen, d: int, dtype: str):
    """One arm at a ragged width (`table_arm`), its rows at the store's
    16-byte pitch, and its aligned twin: the same rows and queries padded
    with zero columns to the next 16-byte multiple, read in place."""
    from verbatim_rag_tpu_torch.ops import fused_topk as ft

    c, q, s = table_arm(gen, RAGGED_N, RAGGED_BATCH, d, dtype)
    pitched = ft.pitched(c)
    require(not ft.is_pitched(c) and ft.is_pitched(pitched), f"ragged {dtype} d={d}: not a ragged width")
    cols = ft.pitch_columns(d, c.element_size())
    require(pitched.stride(0) == cols, f"ragged {dtype} d={d}: pitch {pitched.stride(0)}, not {cols}")
    del c
    return (pitched, q, s), (pad_columns(pitched, cols), pad_columns(q, cols), s)


def check_ragged_tables(gen) -> dict:
    """Kernels 3, 6 and 7 at ragged widths (`RAGGED_ROWS`, `RAGGED_STREAMED`)
    on rows at the store's 16-byte pitch, each against its plain version
    with the planted faults of the aligned checks (section: two arms of the
    width, the mask ignored, the last position dropped, arm 1 reading arm
    0's rows; v2: the first two; v1: the mask ignored): int8 bit-equal,
    bf16 and float32 within the aligned checks' limits. Each is timed beside
    its bound, its plain version and its aligned twin (zero columns up to
    the next 16-byte multiple), and for int8 the twin's tables must be the
    ragged ones, bit for bit. No corpus may be copied."""
    import torch

    from verbatim_rag_tpu_torch.ops import fused_topk as ft
    from verbatim_rag_tpu_torch.ops import section as sec

    n, block, batch = RAGGED_N, RAGGED_BLOCK, RAGGED_BATCH
    width = n // block * 128
    out = {"section": [], "bucket_max_v2": [], "bucket_max_v1": []}
    copies = ft.corpus_copies
    for d, dtype in RAGGED_ROWS + RAGGED_STREAMED:
        int8 = dtype == "int8"
        peak = {"int8": PEAK_INT8_OPS, "bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_FP32_OPS}[dtype]
        (c, q, s), (tc, tq, _) = ragged_arm(gen, d, dtype)
        (c1, q1, s1), _ = ragged_arm(gen, d, dtype)
        mask = table_mask(gen, n)
        row_bytes = d * c.element_size()
        streamed = dtype != "float32" and ft.walk_streams(row_bytes)
        info = dict(n=n, block=block, batch=batch, d=d, dtype=dtype, row_bytes=row_bytes,
                    pitch_bytes=ft.row_pitch_bytes(c), streamed=streamed)
        what = f"ragged {dtype} d={d}"

        corpora, queries, scales = (c, c1), (q, q1), (s, s1)
        before = sec.launches_streamed
        got = sec.section_tables_cuda(corpora, queries, mask, scales, block)
        torch.cuda.synchronize()
        require(sec.launches_streamed == before + streamed, f"{what}: section streamed count")
        ref = sec.section_tables_reference(corpora, queries, mask, scales, block)
        err = max(
            check_table(sec_decode(g, block, n), sec_decode(e, block, n), cc, qq, int8)
            for g, e, cc, qq in zip(got, ref, corpora, queries)
        )
        if int8:
            twin = sec.section_tables_cuda((tc,), (tq,), mask, (s,), block)[0]
            require(torch.equal(twin.view(torch.int32), got[0].view(torch.int32)),
                    f"{what}: section tables differ from the zero-padded twin's")
            del twin
        del got
        faults = section_planted_faults(corpora, queries, mask, scales, block, ref, int8)
        del ref
        one = lambda: sec.section_tables_cuda((c,), (q,), mask, (s,), block)  # noqa: E731
        case = dict(
            info, arms=2, max_abs_err=err, planted_faults_caught=faults,
            ms=cuda_ms(one, reps=10),
            aligned_ms=cuda_ms(lambda: sec.section_tables_cuda((tc,), (tq,), mask, (s,), block), reps=10),
            plain_ms=cuda_ms(lambda: sec.section_tables_reference((c,), (q,), mask, (s,), block), reps=1),
        )
        case["bound_ms"], case["bound_by"] = bound(
            table_bytes([(c, q, s)], n, batch, width, 4), 2.0 * batch * n * d, peak
        )
        log("section ragged", json.dumps(case))
        out["section"].append(case)
        del c1, q1, s1

        got = ft.matmul_bucket_max_v2_cuda(c, q, mask, s)
        torch.cuda.synchronize()
        ref = ft.matmul_bucket_max_v2_reference(c, q, mask, s)
        err = check_table(got, ref, c, q, int8)
        if int8:
            twin = ft.matmul_bucket_max_v2_cuda(tc, tq, mask, s)
            require(torch.equal(twin[0].view(torch.int32), got[0].view(torch.int32))
                    and torch.equal(twin[1], got[1]), f"{what}: v2 table differs from the twin's")
            del twin
        del got
        faults = v2_planted_faults(c, q, mask, s, ref, int8)
        del ref
        case = dict(
            info, max_abs_err=err, planted_faults_caught=faults,
            ms=cuda_ms(lambda: ft.matmul_bucket_max_v2_cuda(c, q, mask, s), reps=10),
            aligned_ms=cuda_ms(lambda: ft.matmul_bucket_max_v2_cuda(tc, tq, mask, s), reps=10),
            plain_ms=cuda_ms(lambda: ft.matmul_bucket_max_v2_reference(c, q, mask, s), reps=1),
        )
        case["bound_ms"], case["bound_by"] = bound(
            table_bytes([(c, q, s)], n, batch, width, 8), 2.0 * batch * n * d, peak
        )
        log("bucket_max_v2 ragged", json.dumps(case))
        out["bucket_max_v2"].append(case)

        if not int8:  # v1 reads bf16 and float32 rows
            got = ft.matmul_bucket_max_cuda(c, q, mask)
            torch.cuda.synchronize()
            ref = ft.matmul_bucket_max_reference(c, q, mask)
            why = v1_fails(got, ref, q, c, mask, V1_LIMITS[dtype])
            require(why is None, f"{what}: bucket v1 {why}")
            live = ref[0] > -1e29
            err = float((got[0] - ref[0]).abs()[live].max())
            del got
            fault = v1_fails(ft.matmul_bucket_max_cuda(c, q, torch.ones_like(mask)), ref, q, c, mask,
                             V1_LIMITS[dtype])
            require(fault is not None, f"{what}: bucket v1's mask-ignored fault passes the check")
            del ref
            case = dict(
                info, max_abs_err=err, fault_mask_ignored=fault,
                ms=cuda_ms(lambda: ft.matmul_bucket_max_cuda(c, q, mask), reps=10),
                aligned_ms=cuda_ms(lambda: ft.matmul_bucket_max_cuda(tc, tq, mask), reps=10),
                plain_ms=cuda_ms(lambda: ft.matmul_bucket_max_reference(c, q, mask), reps=1),
            )
            case["bound_ms"], case["bound_by"] = v1_bound(n, batch, d, c.dtype)
            log("bucket_max_v1 ragged", json.dumps(case))
            out["bucket_max_v1"].append(case)
        del c, q, s, tc, tq, mask
        torch.cuda.empty_cache()
    require(ft.corpus_copies == copies, f"ragged: {ft.corpus_copies - copies} corpus copies")
    return out


def grid_lengths(batch: int, seq: int, gen):
    """Random lengths in [1, seq], a zero-length row, and the last row (the
    second launch's) at full length."""
    import torch

    lens = torch.randint(1, seq + 1, (batch,), generator=gen, device="cuda", dtype=torch.int32)
    lens[1] = 0
    lens[-1] = seq
    return lens


def grid_flash_check(outs, plain, live, floor: float = 0.0) -> tuple[float, dict]:
    """Each output set in ``outs`` (name → tuple of [B, S, H, D] tensors)
    against ``plain(sl)`` (the plain outputs of batch rows ``sl``), slice by
    slice, each live row held to `row_check`: (max abs error of the
    kernel's, worst row of its limit per name)."""
    import torch

    B = live.shape[0]
    n_out = len(next(iter(outs.values())))
    scales = [torch.zeros(live.shape + (GRID_FLASH["heads"],), device="cuda") for _ in range(n_out)]
    errs = {name: [torch.zeros_like(x) for x in scales] for name in outs}
    for b0 in range(0, B, GRID_PLAIN_ROWS):
        sl = slice(b0, b0 + GRID_PLAIN_ROWS)
        for i, ref in enumerate(plain(sl)):
            ref = ref.float()
            scales[i][sl] = ref.abs().amax(dim=-1)
            for name, got in outs.items():
                errs[name][i][sl] = (got[i][sl].float() - ref).abs().amax(dim=-1)
    ratio, err = {}, 0.0
    for name in outs:
        checks = [row_check(errs[name][i], scales[i], live, floor) for i in range(n_out)]
        ratio[name] = max(c[1] for c in checks)
        if name == "kernel":
            err = max(c[0] for c in checks)
    return err, ratio


def check_grid_flash(gen) -> dict:
    """The flash forward (with lse), its FA2 backward and the ring step's
    partial at `GRID_FLASH` (batch × heads = 65,544): two launches each, the
    second holding the one batch row past the grid's limit. Each output
    against its plain version, every live row held as the kernels phase
    holds it, and two planted faults on the launch split (the last slice's
    rows left as zeros; the last slice fed the first slice's rows) must fail
    that check. The autograd path (`FlashAttention`) is one call whose
    backward gives the same gradients. Times beside the bound, the plain
    version and the library's call (SDPA with the boolean mask, its
    backward, the memory-efficient kernel with its logsumexp)."""
    import torch
    import torch.nn.functional as F

    from verbatim_rag_tpu_torch.ops import flash_attention as fa

    B, H, D, S = (GRID_FLASH[k] for k in ("batch", "heads", "head_dim", "seq"))
    last = 65535 // H  # the first batch row of the second launch
    require(B * H > 65535 and last == B - 1, "grid: the shape does not split in two")
    lens = grid_lengths(B, S, gen)
    q, k, v, g = (torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=torch.bfloat16)
                  for _ in range(4))
    live = torch.arange(S, device="cuda")[None, :] < lens[:, None]
    lengths = lens.tolist()
    pairs = attention_pairs(lengths, S, None)
    q_rows, kv_rows = attention_rows(lengths, S)

    def faults(x):
        """The planted split faults of one output tensor."""
        zeros, first = x.clone(), x.clone()
        zeros[last:] = 0
        first[last:] = x[:1]
        return zeros, first

    result = {}
    counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches, fa.partial_launches)
    out, lse = fa.flash_attention_lse_cuda(q, k, v, lens)
    torch.cuda.synchronize()
    require(fa.launches == counts[0] + 2, "grid: the forward did not launch twice")
    zeros, first = faults(out)
    err, ratio = grid_flash_check(
        {"kernel": (out,), "fault: last slice left as zeros": (zeros,),
         "fault: last slice fed the first slice's rows": (first,)},
        lambda sl: (fa.attention_reference(q[sl], k[sl], v[sl], lens[sl]),), live,
    )
    lse_gap = max(
        float(((lse[sl] - fa.attention_lse_reference(q[sl], k[sl], v[sl], lens[sl])[1]).abs()
               - 1e-5 * lse[sl].abs()).max())
        for sl in (slice(b0, b0 + GRID_PLAIN_ROWS) for b0 in range(0, B, GRID_PLAIN_ROWS))
    )
    worst = ratio.pop("kernel")
    require(worst <= 1.0 and lse_gap <= 1e-4, f"grid flash forward: worst row {worst}, lse {lse_gap}")
    for name, r in ratio.items():
        require(r > 1.0, f"grid flash forward: planted {name} passes the check ({r})")
    b_ms, b_by = bound((q_rows + 2 * kv_rows + B * S) * H * D * 2 + 4 * B, 4 * H * D * pairs,
                       PEAK_BF16_FLOPS)

    def plain_fwd():
        for b0 in range(0, B, GRID_PLAIN_ROWS):
            sl = slice(b0, b0 + GRID_PLAIN_ROWS)
            fa.attention_reference(q[sl], k[sl], v[sl], lens[sl])

    # Library yardsticks at this shape (the kernels phase's): SDPA with the
    # equivalent boolean mask, its backward, and the memory-efficient
    # kernel with its logsumexp for the partial.
    mask = sdpa_mask(lens, S, None)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    result["forward"] = dict(
        GRID_FLASH, grid_rows=B * H, launches=2, max_abs_err=err, worst_row_of_limit=worst,
        lse_max_excess=lse_gap, planted_faults_worst_row_of_limit=ratio,
        ms=cuda_ms(lambda: fa.flash_attention_lse_cuda(q, k, v, lens), reps=10),
        plain_ms=cuda_ms(plain_fwd, reps=1), bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=10),
        library_note="scaled_dot_product_attention, boolean mask",
    )
    log("grid flash forward", json.dumps(result["forward"]))

    grads = fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g)
    torch.cuda.synchronize()
    require(fa.bwd_dq_launches == counts[1] + 2 and fa.bwd_dkv_launches == counts[2] + 2,
            "grid: the backward did not launch twice")
    outs = {"kernel": grads}
    for i, name in enumerate(("dq", "dk", "dv")):
        zeros, first = faults(grads[i])
        for fault, x in (("last slice left as zeros", zeros), ("last slice fed the first slice's rows", first)):
            outs[f"fault: {name} {fault}"] = tuple(x if j == i else grads[j] for j in range(3))
    err, ratio = grid_flash_check(
        outs, lambda sl: fa.flash_attention_bwd_reference(
            q[sl], k[sl], v[sl], lens[sl], out[sl], lse[sl], g[sl]), live, floor=1e-3,
    )
    worst = ratio.pop("kernel")
    require(worst <= 1.0, f"grid flash backward: worst row {worst}")
    for name, r in ratio.items():
        require(r > 1.0, f"grid flash backward: planted {name} passes the check ({r})")
    # One autograd call over the whole batch: its forward and backward each
    # launch twice, and its gradients are the direct backward's.
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    o = fa.FlashAttention.apply(*leaves, lens, None)
    auto = torch.autograd.grad(o, leaves, g)
    require((fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == tuple(x + 2 for x in before),
            "grid: the autograd call did not launch each kernel twice")
    require(all(torch.equal(a, b) for a, b in zip(auto, grads)), "grid: autograd gradients differ")
    del o, auto, leaves, outs
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    b_ms, b_by = bound(
        (2 * q_rows + 2 * kv_rows + 3 * B * S) * H * D * 2 + 2 * H * q_rows * 4 + 4 * B,
        10 * H * D * pairs, PEAK_BF16_FLOPS,
    )

    def plain_bwd():
        for b0 in range(0, B, GRID_PLAIN_ROWS):
            sl = slice(b0, b0 + GRID_PLAIN_ROWS)
            fa.flash_attention_bwd_reference(q[sl], k[sl], v[sl], lens[sl], out[sl], lse[sl], g[sl])

    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    go = g.transpose(1, 2).contiguous()
    result["backward"] = dict(
        GRID_FLASH, grid_rows=B * H, launches_dq=2, launches_dkv=2, max_abs_err=err,
        worst_row_of_limit=worst, planted_faults_worst_row_of_limit=ratio,
        ms=cuda_ms(lambda: fa._launch_bwd(q, k, v, lens, lse, delta, g, None), reps=10),
        plain_ms=cuda_ms(plain_bwd, reps=1), bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), go, retain_graph=True), reps=5),
        library_note="scaled_dot_product_attention backward, boolean mask",
    )
    log("grid flash backward", json.dumps(result["backward"]))
    del grads, delta, out, lse, o, go, mask

    # The partial: the same rows as one KV block at k_offset 0.
    numer, m, l = fa.flash_attention_partial_cuda(q, k, v, lens, 0)
    torch.cuda.synchronize()
    require(fa.partial_launches == counts[3] + 2, "grid: the partial did not launch twice")
    zeros, first = faults(numer)
    err, ratio = grid_flash_check(
        {"kernel": (numer,), "fault: last slice left as zeros": (zeros,),
         "fault: last slice fed the first slice's rows": (first,)},
        lambda sl: fa.flash_attention_partial_reference(q[sl], k[sl], v[sl], lens[sl], 0)[:1], live,
    )
    ml_gap = 0.0
    for b0 in range(0, B, GRID_PLAIN_ROWS):
        sl = slice(b0, b0 + GRID_PLAIN_ROWS)
        _, ref_m, ref_l = fa.flash_attention_partial_reference(q[sl], k[sl], v[sl], lens[sl], 0)
        rows_live = (lens[sl] > 0)[:, None, None].expand_as(ref_m)
        ml_gap = max(ml_gap, float(((m[sl] - ref_m).abs() / (1e-5 * ref_m.abs() + 1e-6))[rows_live].max()),
                     float(((l[sl] - ref_l).abs() / (PARTIAL_L_RTOL * ref_l))[rows_live].max()))
    worst = ratio.pop("kernel")
    require(worst <= 1.0 and ml_gap <= 1.0, f"grid partial: worst row {worst}, m/l {ml_gap} of the limit")
    for name, r in ratio.items():
        require(r > 1.0, f"grid partial: planted {name} passes the check ({r})")
    # Bytes: q of the live rows, k and v up to each row's length; numer, m
    # and l written whole, in float32.
    b_ms, b_by = bound((q_rows + 2 * kv_rows) * H * D * 2 + B * S * H * D * 4 + 2 * B * H * S * 4 + 4 * B,
                       4 * H * D * pairs, PEAK_BF16_FLOPS)

    def plain_partial():
        for b0 in range(0, B, GRID_PLAIN_ROWS):
            sl = slice(b0, b0 + GRID_PLAIN_ROWS)
            fa.flash_attention_partial_reference(q[sl], k[sl], v[sl], lens[sl], 0)

    library_ms, library_note = efficient_attention_ms(*(x.detach() for x in (qt, kt, vt)), live)
    result["partial"] = dict(
        GRID_FLASH, grid_rows=B * H, launches=2, max_abs_err=err, worst_row_of_limit=worst,
        m_l_worst_of_limit=ml_gap, planted_faults_worst_row_of_limit=ratio,
        ms=cuda_ms(lambda: fa.flash_attention_partial_cuda(q, k, v, lens, 0), reps=10),
        plain_ms=cuda_ms(plain_partial, reps=1), bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms, library_note=library_note,
    )
    log("grid flash partial", json.dumps(result["partial"]))
    del q, k, v, g, numer, m, l, qt, kt, vt
    torch.cuda.empty_cache()
    return result


def check_grid_rescore(gen) -> dict:
    """The rescore at `GRID_RESCORE` (65,600 queries: two launches, the
    second holding 65 queries past the grid's limit) over the serving
    point's 1M-row forward index, against its plain version slice by slice
    (`rescore_fault`), with two planted faults on the split (the last
    slice's scores left as -1e30; the last slice scored with the first
    slice's queries) that must fail it; time beside its bound and the plain
    version."""
    import torch

    from verbatim_rag_tpu_torch.ops import rescore as rs

    B = GRID_RESCORE["batch"]
    cand, sp_ids, sp_w, q_ids, q_w = rescore_inputs(gen, batch=B, cands=GRID_RESCORE["cands"])
    before = rs.launches
    got = rs.exact_rescore_cuda(cand, sp_ids, sp_w, q_ids, q_w)
    torch.cuda.synchronize()
    require(rs.launches == before + 2, "grid: the rescore did not launch twice")
    last = 65535
    empty, first = got.clone(), got.clone()
    empty[last:] = -1e30
    first[last:] = rs.exact_rescore_cuda(cand[last:], sp_ids, sp_w, q_ids[: B - last], q_w[: B - last])
    found = {"last slice left as -1e30": None, "last slice scored with the first slice's queries": None}
    err, rel, rows = 0.0, 0.0, 4096
    for b0 in range(0, B, rows):
        sl = slice(b0, b0 + rows)
        ref = rs.exact_rescore_oneshot(cand[sl], sp_ids, sp_w, q_ids[sl], q_w[sl])
        valid = cand[sl] >= 0
        why = rescore_fault(got[sl], ref, valid)
        require(why is None, f"grid rescore rows {b0}+: {why}")
        err = max(err, float((got[sl] - ref)[valid].abs().max()))
        rel = max(rel, float(((got[sl] - ref).abs() / ref.abs().clamp(min=1e-6))[valid].max()))
        for name, x in (("last slice left as -1e30", empty), ("last slice scored with the first slice's queries", first)):
            found[name] = found[name] or rescore_fault(x[sl], ref, valid)
    for name, why in found.items():
        require(why is not None, f"grid rescore: planted fault '{name}' passes the check")
    b_ms, b_by = rescore_bound(cand, sp_ids, sp_w, q_ids.shape[1])

    def plain():
        for b0 in range(0, B, rows):
            sl = slice(b0, b0 + rows)
            rs.exact_rescore_oneshot(cand[sl], sp_ids, sp_w, q_ids[sl], q_w[sl])

    result = dict(
        GRID_RESCORE, m=sp_ids.shape[1], qm=q_ids.shape[1], launches=2, max_abs_err=err,
        max_rel_err=rel, planted_faults_caught=found,
        ms=cuda_ms(lambda: rs.exact_rescore_cuda(cand, sp_ids, sp_w, q_ids, q_w), reps=10),
        plain_ms=cuda_ms(plain, reps=1), bound_ms=b_ms, bound_by=b_by,
    )
    log("grid rescore", json.dumps(result))
    del cand, sp_ids, sp_w, q_ids, q_w, got, empty, first
    torch.cuda.empty_cache()
    return result


def ragged_data(data, cols: int) -> dict:
    """`bench_data`'s records and queries with their dense rows cut to the
    first `RAGGED_DIM` columns, rounded to multiples of 1/16, then
    zero-padded to ``cols``. The rounding makes every sum of squares of a
    row exact in float32, so a row's norm does not depend on the order in
    which the host's BLAS or a torch reduction adds its terms, which the
    zero columns of the twin may change: the twin's rows then normalize and
    quantize to the same values bit for bit."""
    import numpy as np

    dense = data["arrays"]["dense"]
    rows = np.zeros((dense.shape[0], cols), np.float32)
    rows[:, :RAGGED_DIM] = np.round(dense[:, :RAGGED_DIM] * 16) / 16
    records = [
        {"id": r["id"], "dense": rows[i], "sparse_arrays": r["sparse_arrays"]}
        for i, r in enumerate(data["records"])
    ]

    def queries(i):
        q_dense, q_sparse, src = data["queries"](i)
        padded = np.zeros((q_dense.shape[0], cols), np.float32)
        padded[:, :RAGGED_DIM] = np.round(q_dense[:, :RAGGED_DIM] * 16) / 16
        return padded, q_sparse, src

    return dict(data, dim=cols, records=records, queries=queries)


def run_ragged(data, card: str, gen, int8_event_ms: float) -> dict:
    """The int8 store at `RAGGED_DIM` (300 int8 bytes a row, sketch 768),
    "auto" → section: one 512-query batch (top-10, depth 256) held bit-equal
    (ids and scores) to a twin store filled with the same rows zero-padded to
    304 columns, which the aligned path serves; the batch's launches, the
    corpus pointers the section launch received (the store's own buffers),
    its ms by CUDA events beside the twin's and store_int8's 384-d batch's
    (``int8_event_ms``) and the state bytes of both.
    Then the kernels at ragged widths (`check_ragged_tables`) and the
    launches past the grid limit (`check_grid_flash`, `check_grid_rescore`)."""
    import torch

    from verbatim_rag_tpu_torch.ops import fused_topk as ft
    from verbatim_rag_tpu_torch.ops import section as sec

    t0 = time.perf_counter()
    top_k = 10
    result = dict(card=card, rows=STORE_ROWS, dense_dim=RAGGED_DIM,
                  store_int8_batch_event_ms_median=int8_event_ms)
    answers, passed = {}, []
    record = sec.kernel_operands

    def recording(corpus, q, what):
        operands = record(corpus, q, what)
        passed.append((corpus.data_ptr(), operands[0].data_ptr()))
        return operands

    for name, cols in (("ragged", RAGGED_DIM), ("twin", 304)):
        rdata = ragged_data(data, cols)
        store, ingest_s, state_gb = fill_store(
            rdata, dense_dtype="int8", sketch_dtype="int8", projection_dim=768
        )
        require(store.candidate_impl == "section", f"ragged {name}: impl {store.candidate_impl}")
        require(store.rescore_depth == 256, f"ragged {name}: depth {store.rescore_depth}")
        q_dense, q_sparse, _ = rdata["queries"](0)
        store.query_batch(dense_queries=q_dense, sparse_queries=q_sparse, top_k=top_k)  # warm
        reset_counts()
        copies = ft.corpus_copies
        passed.clear()
        sec.kernel_operands = recording
        try:
            first = store.query_batch(dense_queries=q_dense, sparse_queries=q_sparse, top_k=top_k)
        finally:
            sec.kernel_operands = record
        counts = read_counts()
        require(counts["section"] > 0, f"ragged {name}: no section launch in the batch {counts}")
        require(ft.corpus_copies == copies, f"ragged {name}: the batch copied a corpus")
        buffers = {store._dense.data_ptr(), store._sp_proj.data_ptr()}
        require(all(got == given and given in buffers for given, got in passed) and len(passed) == 2,
                f"ragged {name}: the section launch did not read the store's buffers {passed}")
        answers[name] = [[(h.id, h.score) for h in r] for r in first]
        _, event_ms = event_batches(store, rdata, 1, 3, top_k)
        result[name] = dict(
            dense_columns=cols, dense_pitch_bytes=ft.row_pitch_bytes(store._dense),
            dense_shape=list(store._dense.shape), capacity=store._capacity, state_gb=state_gb,
            state_gb_unpitched=sum(
                t.numel() * t.element_size() for t in (
                    store._dense, store._dense_scale, store._sp_ids, store._sp_w, store._sp_proj,
                    store._sp_proj_scale, store._valid_dev,
                )
            ) / 1e9,
            ingest_s=ingest_s, batch_event_ms=event_ms, batch_event_ms_median=sorted(event_ms)[1],
            section_reads_store_buffers=True, launches=counts,
        )
        log(f"ragged store {name}", json.dumps(result[name]))
        if name == "ragged":
            result["launches"] = counts
        del store, rdata, first
        torch.cuda.empty_cache()
    same = answers["ragged"] == answers["twin"]
    require(same, "ragged: the 300-d store's answers differ from its zero-padded twin's")
    require(all(len(r) == top_k for r in answers["ragged"]), "ragged: result shape")
    result["bit_equal_to_twin"] = same
    result["tables"] = check_ragged_tables(gen)
    result["grid"] = dict(check_grid_flash(gen), rescore=check_grid_rescore(gen))
    result["phase_s"] = time.perf_counter() - t0
    log("ragged", json.dumps({k: v for k, v in result.items() if k not in ("tables", "grid")}))
    return result


def matrix_bytes(store) -> dict:
    """Resident bytes of a store's dense and sketch matrices, each with its
    scale column (rows at their pitch)."""
    from verbatim_rag_tpu_torch.ops.fused_topk import resident_bytes

    def nbytes(*arrays):
        return sum(resident_bytes(a) for a in arrays if a is not None)

    return dict(
        dense=nbytes(store._dense, store._dense_scale),
        sketch=nbytes(store._sp_proj, store._sp_proj_scale),
    )


def event_batches(store, data, first: int, count: int, top_k: int, **query):
    """Host ms and CUDA-event ms of each of ``count`` hybrid batches."""
    import torch

    host, events = [], []
    for i in range(first, first + count):
        b_dense, b_sparse, _ = data["queries"](i)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = store.query_batch(dense_queries=b_dense, sparse_queries=b_sparse, top_k=top_k, **query)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
        require(len(out) == data["batch"], "batch size")
    return host, events


def numpy_int4(x):
    """The JAX package's numpy int4 quantization, written out here: codes
    in [-7, 7] half to even, scale max|x|/7 floored at 1e-12, column j in the
    low nibble of byte j and column j + d/2 in its high nibble."""
    import numpy as np

    x = x.astype(np.float32)
    half = x.shape[-1] // 2
    scale = np.clip(np.max(np.abs(x), axis=-1, keepdims=True) / 7.0, 1e-12, None)
    codes = np.clip(np.round(x / scale), -7, 7).astype(np.int8)
    packed = ((codes[..., :half] & 0xF) | ((codes[..., half:] & 0xF) << 4)).astype(np.int8)
    return packed, scale.astype(np.float32)


#: The int4 phase: how many rows' codes are held to numpy, and the rows of
#: its one large batch (`benchmarks/bench_capacity_4m.py --int4`'s N), run
#: when four times the 1M fill would take less than `INT4_4M_FILL_S`.
INT4_CHECKED_ROWS = 65_536
INT4_4M_ROWS = 3_997_696
INT4_4M_FILL_S = 60.0


def run_int4(data, card: str, seed: int) -> dict:
    """The int4 tier (see the module docstring, 5a)."""
    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.ops import dense as dense_mod

    top_k, n_batches = 10, STORE_BATCHES
    # The float32 rows the flush quantizes (dense 384, sketch 768 columns),
    # kept for a sample of rows to hold the stored codes to numpy's.
    rows = np.random.default_rng(seed + 5000).choice(STORE_ROWS, size=INT4_CHECKED_ROWS, replace=False)
    idx = torch.as_tensor(rows, device="cuda")
    quantized = {}
    quantize = dense_mod.quantize_rows_int4

    def keep_rows(x):
        quantized[x.shape[1]] = x[idx].cpu().numpy()
        return quantize(x)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    dense_mod.quantize_rows_int4 = keep_rows
    try:
        store, ingest_s, state_gb = fill_store(data, dense_dtype="int4", sketch_dtype="int4")
    finally:
        dense_mod.quantize_rows_int4 = quantize
    require(store.candidate_impl == "xla", f"int4: impl {store.candidate_impl}")
    first, hit = first_batch(store, data, top_k, "int4")
    host_ms, event_ms = event_batches(store, data, 1, n_batches, top_k)
    counts = read_counts()
    require(
        counts["rescore"] == n_batches + 1 and counts["section"] == counts["bucket_max_v2"] == 0,
        f"int4: launches {counts}",
    )
    differ = same_rows_with_plain_rescore(store, data, first, top_k, "int4")

    # The stored codes and scales bit-equal to numpy's quantization of the
    # same float32 rows.
    require(sorted(quantized) == [data["dim"], store.projection_dim], f"int4: quantized {sorted(quantized)}")
    for name, codes, scale, width in (
        ("dense", store._dense, store._dense_scale, data["dim"]),
        ("sketch", store._sp_proj, store._sp_proj_scale, store.projection_dim),
    ):
        want_codes, want_scale = numpy_int4(quantized[width])
        require(np.array_equal(codes[idx].cpu().numpy(), want_codes), f"int4: {name} codes differ from numpy's")
        require(
            np.array_equal(scale[idx].cpu().numpy().view(np.int32), want_scale.view(np.int32)),
            f"int4: {name} scales differ from numpy's",
        )
    overlap = float(np.mean([
        len({h.id for h in r} & set(i8)) / top_k for r, i8 in zip(first, data["int8_first_rows"])
    ]))
    q_dense, q_sparse, _ = data["queries"](1)
    profile = device_profile(
        lambda: store.query_batch(dense_queries=q_dense, sparse_queries=q_sparse, top_k=top_k)
    )
    log("int4 profile", json.dumps(profile))
    result = dict(
        card=card, rows=STORE_ROWS, capacity=store._capacity, state_gb=state_gb, ingest_s=ingest_s,
        batch=data["batch"], batch_ms=host_ms, batch_ms_median=float(np.median(host_ms)),
        batch_event_ms=event_ms, batch_event_ms_median=float(np.median(event_ms)),
        qps=data["batch"] / float(np.median(host_ms)) * 1e3, source_row_in_top10=hit,
        queries_differing_from_plain_on_a_tie=differ, codes_checked_rows=INT4_CHECKED_ROWS,
        bytes=matrix_bytes(store), int8_bytes=data["int8_bytes"],
        top10_overlap_with_int8_section=overlap, idle_share=profile["idle_share"],
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts,
    )
    del store
    torch.cuda.empty_cache()
    result["rows_4m"] = run_int4_4m(data, seed) if 4 * ingest_s < INT4_4M_FILL_S else (
        f"not run: four times the 1M fill ({4 * ingest_s:.1f} s) is not under {INT4_4M_FILL_S} s"
    )
    log("int4", json.dumps(result))
    return result


def run_int4_4m(data, seed: int) -> dict:
    """One 512-query hybrid batch over an int4 store of 3,997,696 records
    (dense 384, sketch 768, 128-nnz forward index). Block k of the store
    phase's 1M rows enters with its dense columns permuted by a permutation
    made from the seed and its term ids shifted by k · 7919 (mod the
    vocabulary): new rows and terms, made in seconds, with no copy of a row
    in another block."""
    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

    rng = np.random.default_rng(seed + 6000)
    n, dim, nnz, vocab = INT4_4M_ROWS, data["dim"], data["nnz"], data["vocab"]
    src = data["arrays"]
    t0 = time.perf_counter()
    blocks = -(-n // STORE_ROWS)
    dense = np.concatenate(
        [src["dense"][:, rng.permutation(dim) if k else np.arange(dim)] for k in range(blocks)]
    )[:n]
    ids = np.concatenate([(src["ids"] + k * 7919 - 1) % (vocab - 1) + 1 for k in range(blocks)])[:n]
    weights = np.concatenate([src["weights"]] * blocks)[:n]
    records = [{"id": str(i), "dense": dense[i], "sparse_arrays": (ids[i], weights[i])} for i in range(n)]
    make_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    store = DeviceVectorStore(
        dense_dim=dim, sparse_vocab=vocab, sparse_max_nnz=nnz, dense_dtype="int4", sketch_dtype="int4"
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.add_vectors(records)
    store.flush()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    del records
    q_dense, q_sparse, _ = data["queries"](0)
    out = store.query_batch(dense_queries=q_dense, sparse_queries=q_sparse, top_k=10)
    require(len(out) == data["batch"] and all(len(r) == 10 for r in out), "int4 4M: result shape")
    host_ms, event_ms = event_batches(store, data, 1, 1, 10)
    result = dict(
        rows=n, capacity=store._capacity, records_s=make_s, ingest_s=ingest_s,
        bytes=matrix_bytes(store), batch_ms=host_ms[0], batch_event_ms=event_ms[0],
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    del store
    torch.cuda.empty_cache()
    return result


#: The mesh phase: the mesh (dp × tp, every shard on the one card), the
#: rows of its 3-way / lifecycle store and of its exact-mode store, and the
#: timed batches of its section and bucket programs.
MESH_DP, MESH_TP = 2, 2
MESH_SHARDS = MESH_DP * MESH_TP
MESH_TEXT_ROWS = 65_536
MESH_EXACT_ROWS = 196_608
MESH_TABLE_BATCHES = 2


def sparse_dominates(got, ref) -> bool:
    """A mesh store's sparse arm against the unsharded store's at the same
    depth: its candidates are a superset (each shard keeps its own top
    ``depth``), so position by position its exact scores are at least the
    unsharded ones (within 1e-6 relative)."""
    return len(got) >= len(ref) and all(
        g.score >= r.score - 1e-6 * max(abs(r.score), 1e-30) for g, r in zip(got, ref)
    )


def held_to_unsharded(store, ref, data, top_k: int, what: str) -> dict:
    """The mesh store's first hybrid batch against the unsharded store's on
    the same records: the dense arm (dense-only at the fetch depth) equal,
    and every query's rows and scores equal unless its sparse arm differs,
    where the mesh store's must dominate (`sparse_dominates`)."""
    q_dense, q_sparse, _ = data["queries"](0)
    query = dict(dense_queries=q_dense, sparse_queries=q_sparse)
    got, want = store.query_batch(top_k=top_k, **query), ref.query_batch(top_k=top_k, **query)
    dense_got = store.query_batch(dense_queries=q_dense, top_k=2 * top_k)
    dense_want = ref.query_batch(dense_queries=q_dense, top_k=2 * top_k)
    sparse_got = store.query_batch(sparse_queries=q_sparse, top_k=2 * top_k)
    sparse_want = ref.query_batch(sparse_queries=q_sparse, top_k=2 * top_k)
    differ = 0
    for b in range(data["batch"]):
        require(
            [h.id for h in dense_got[b]] == [h.id for h in dense_want[b]],
            f"{what}: query {b} dense rows differ from the unsharded store's",
        )
        if hits([got[b]]) == hits([want[b]]):
            continue
        differ += 1
        require(
            [h.id for h in sparse_got[b]] != [h.id for h in sparse_want[b]]
            and sparse_dominates(sparse_got[b], sparse_want[b]),
            f"{what}: query {b} differs from the unsharded store's without a better sparse arm",
        )
    return dict(results=got, queries_with_a_better_sparse_arm=differ)


def section_arm_ties(store, queries, top_k: int, depth: int):
    """Queries of a 3-way batch where an arm of a single-device section
    store holds two equal values among its top 2·top_k + 1 (the dense arm's
    table values with the position bits cleared, the projected arms' exact
    scores above 0): there a mesh store, which merges its shards' lists by
    those values in shard order, may rank the tied rows otherwise. A [B]
    bool tensor."""
    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.ops.dense import topk
    from verbatim_rag_tpu_torch.ops.hybrid import rescore_fn
    from verbatim_rag_tpu_torch.ops.section import section_bucket_tables, table_topk

    q_dense, q_sparse, text_q = queries
    q = np.asarray(q_dense, np.float32)
    q = torch.from_numpy(q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)).cuda()
    q_ids, q_w, sq = store._sparse_query_device(q_sparse, store.sparse_vocab)
    f_ids, f_w, fq = store._sparse_query_device(store._bm25_query_sparse(text_q), store.full_text_vocab)
    n, fetch = store._capacity, 2 * top_k + 1
    bc = 16384 if n % 16384 == 0 else 8192
    td, ts, tf = section_bucket_tables(
        (store._dense, store._sp_proj, store._ft_proj), (q, sq, fq), store._valid_dev,
        scales=(store._dense_scale, store._sp_proj_scale, store._ft_proj_scale), block_cols=bc,
    )
    vals, _ = table_topk(td, fetch, bc, n)
    tied = (vals[:, 1:] == vals[:, :-1]).any(dim=1)
    for table, ids, w, qi, qw in (
        (ts, store._sp_ids, store._sp_w, q_ids, q_w), (tf, store._ft_ids, store._ft_w, f_ids, f_w)
    ):
        _, cand = table_topk(table, depth, bc, n)
        top, _ = topk(rescore_fn(store.rescore_impl)(cand.contiguous(), ids, w, qi, qw), fetch)
        tied |= ((top[:, 1:] == top[:, :-1]) & (top[:, 1:] > 0)).any(dim=1)
    return tied.cpu()


def held_unless_tied(got, want, tied, what: str) -> int:
    """Rows and scores equal on every query but those ``tied`` marks; the
    count of tied queries that differ."""
    differ = 0
    for b, (g, w) in enumerate(zip(got, want)):
        if hits([g]) == hits([w]):
            continue
        require(bool(tied[b]), f"{what}: query {b} differs from the unsharded store's without a tie")
        differ += 1
    return differ


def same_hits_within(got, want, what: str) -> None:
    """Rows equal except where their scores tie within 1e-6 relative, and
    scores within that."""
    for b, (g, w) in enumerate(zip(got, want)):
        require(len(g) == len(w), f"{what}: query {b} has {len(g)} hits, the reference {len(w)}")
        for x, y in zip(g, w):
            require(
                abs(x.score - y.score) <= 1e-6 * max(abs(y.score), 1e-30),
                f"{what}: query {b}: {x.id} ({x.score}) where the reference has {y.id} ({y.score})",
            )


def shard_tables_bit_equal(store, data, what: str) -> dict:
    """Each shard's int8 section tables (both arms) and bucket-max v2 tables
    (the dense arm) from the kernels, bit-equal to their plain versions on
    the shard's rows, and each kernel's time on one shard."""
    import torch

    from verbatim_rag_tpu_torch.ops import fused_topk as ft
    from verbatim_rag_tpu_torch.ops import section as sec
    from verbatim_rag_tpu_torch.ops.dense import normalize_rows

    q_dense, (q_ids, q_w), _ = data["queries"](0)
    dq = normalize_rows(torch.from_numpy(q_dense).cuda())
    _, _, sq = store._sparse_query_device((q_ids, q_w), store.sparse_vocab)
    block = 16384 if store._capacity // MESH_SHARDS % 16384 == 0 else 8192
    out = {}
    for i in range(MESH_SHARDS):
        corpora = (store._dense.shards[i], store._sp_proj.shards[i])
        scales = (store._dense_scale.shards[i], store._sp_proj_scale.shards[i])
        mask = store._valid_dev.shards[i]
        args = (corpora, (dq, sq), mask, scales, block)
        for got, ref in zip(sec.section_tables_cuda(*args), sec.section_tables_reference(*args)):
            require(torch.equal(got, ref), f"{what}: shard {i} section tables differ from the plain version")
        v2 = (corpora[0], dq, mask, scales[0])
        for got, ref in zip(ft.matmul_bucket_max_v2_cuda(*v2), ft.matmul_bucket_max_v2_reference(*v2)):
            require(torch.equal(got, ref), f"{what}: shard {i} bucket-max v2 tables differ from the plain version")
        if i == 0:
            out = dict(
                shard_rows=corpora[0].shape[0],
                section_ms=median_ms(lambda: sec.section_tables_cuda(*args)),
                section_plain_ms=median_ms(lambda: sec.section_tables_reference(*args), reps=3),
                bucket_max_v2_ms=median_ms(lambda: ft.matmul_bucket_max_v2_cuda(*v2)),
                bucket_max_v2_plain_ms=median_ms(lambda: ft.matmul_bucket_max_v2_reference(*v2), reps=3),
            )
    return out


def shard_rescore_ms(store, data) -> dict:
    """The rescore kernel and its plain version on shard 0's forward index,
    at the candidates the shard's section tables give (depth 256)."""
    import torch

    from verbatim_rag_tpu_torch.ops import rescore
    from verbatim_rag_tpu_torch.ops.dense import normalize_rows
    from verbatim_rag_tpu_torch.ops.section import section_bucket_tables, table_topk

    _, (q_ids, q_w), _ = data["queries"](0)
    q_ids, q_w, sq = store._sparse_query_device((q_ids, q_w), store.sparse_vocab)
    ids, w = store._sp_ids.shards[0], store._sp_w.shards[0]
    n = ids.shape[0]
    (table,) = section_bucket_tables(
        (store._sp_proj.shards[0],), (sq,), store._valid_dev.shards[0],
        scales=(store._sp_proj_scale.shards[0],),
    )
    _, cand = table_topk(table, store.rescore_depth, 8192, n)
    cand = cand.contiguous()
    got = rescore.exact_rescore_cuda(cand, ids, w, q_ids, q_w)
    ref = rescore.exact_rescore_oneshot(cand, ids, w, q_ids, q_w)
    live = cand >= 0
    require(torch.allclose(got[live], ref[live], rtol=1e-5, atol=1e-6), "mesh: shard 0 rescore differs")
    return dict(
        candidates=list(cand.shape),
        rescore_ms=median_ms(lambda: rescore.exact_rescore_cuda(cand, ids, w, q_ids, q_w)),
        rescore_plain_ms=median_ms(lambda: rescore.exact_rescore_oneshot(cand, ids, w, q_ids, q_w), reps=3),
    )


def run_mesh(data, card: str, seed: int) -> dict:
    """The row-sharded mesh store (see the module docstring, 5d)."""
    import tempfile

    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore
    from verbatim_rag_tpu_torch.parallel import RowSharded, make_mesh

    t_phase = time.perf_counter()
    top_k, n_batches = 10, STORE_BATCHES
    mesh = make_mesh(dp=MESH_DP, tp=MESH_TP, devices=[torch.device("cuda")] * MESH_SHARDS)
    int8 = dict(dense_dtype="int8", sketch_dtype="int8")
    block = MESH_SHARDS * 8192

    # (a) "auto" → "xla": one rescore launch per shard a batch, held to the
    # unsharded int8 store with candidate_impl="xla".
    reset_counts()
    store, ingest_s, state_gb = fill_store(data, mesh=mesh, block=block, **int8)
    capacity = store._capacity
    require(store.candidate_impl == "xla", f"mesh: auto resolved to {store.candidate_impl}")
    require(
        isinstance(store._dense, RowSharded) and len(store._dense.shards) == MESH_SHARDS
        and store._capacity % (MESH_SHARDS * 8192) == 0,
        "mesh: the store is not row-sharded over the mesh",
    )
    first, hit = first_batch(store, data, top_k, "mesh xla")
    xla_host, xla_events = event_batches(store, data, 1, n_batches, top_k)
    counts = read_counts()
    require(
        counts["rescore"] == MESH_SHARDS * (n_batches + 1) and counts["section"] == 0
        and counts["bucket_max_v2"] == 0,
        f"mesh xla: launches {counts}",
    )
    launches = dict(xla=counts)
    differ = same_rows_with_plain_rescore(store, data, first, top_k, "mesh xla")
    ref, _, _ = fill_store(data, candidate_impl="xla", **int8)
    ref_host, ref_events = event_batches(ref, data, 1, n_batches, top_k)
    held = held_to_unsharded(store, ref, data, top_k, "mesh xla")
    del ref
    torch.cuda.empty_cache()
    q_dense, q_sparse, _ = data["queries"](1)
    profile = device_profile(
        lambda: store.query_batch(dense_queries=q_dense, sparse_queries=q_sparse, top_k=top_k)
    )
    log("mesh xla profile", json.dumps(profile))

    # (b) "section": one section launch per shard a batch; (c) "bucket": two
    # v2 launches per shard a batch. Each held to the plain tables.
    tables = {}
    for impl, kernel, per_shard_batch in (("section", "section", 1), ("bucket", "bucket_max_v2", 2)):
        store.candidate_impl = impl
        reset_counts()
        impl_first, _ = first_batch(store, data, top_k, f"mesh {impl}")
        host, events = event_batches(store, data, 1, MESH_TABLE_BATCHES, top_k)
        counts = read_counts()
        require(
            counts[kernel] == per_shard_batch * MESH_SHARDS * (MESH_TABLE_BATCHES + 1)
            and counts["rescore"] == MESH_SHARDS * (MESH_TABLE_BATCHES + 1),
            f"mesh {impl}: launches {counts}",
        )
        require(not store._warned_section_fallback, f"mesh {impl}: fell back {store._warned_section_fallback}")
        launches[impl] = counts
        same_rows_with_plain_tables(store, data, top_k, impl_first, f"mesh {impl}")
        overlap = float(np.mean([
            len({h.id for h in r} & {h.id for h in x}) / top_k for r, x in zip(impl_first, first)
        ]))
        tables[impl] = dict(
            batch_ms=host, batch_event_ms=events, batch_event_ms_median=float(np.median(events)),
            top10_overlap_with_xla=overlap,
        )
    per_shard = shard_tables_bit_equal(store, data, "mesh")
    per_shard.update(shard_rescore_ms(store, data))
    store.candidate_impl = "xla"
    del store
    torch.cuda.empty_cache()

    # (d) One 3-way batch through the section path of a mesh store over the
    # full_text phase's first 65,536 records, and (e) its lifecycle.
    texts = bench_texts(data, seed)
    n_small = MESH_TEXT_ROWS
    records = [dict(rec, text=text) for rec, text in zip(data["records"][:n_small], texts[:n_small])]
    ft = dict(enable_full_text=True, candidate_impl="section", **int8)
    queries = small_queries(records, texts, n_small, data["batch"], seed + 7000)
    full_depth = {"rescore_depth": 512}  # every table entry, sharded or not
    # The unsharded store takes the mesh's block too, so that the file it
    # saves loads onto the mesh ("section" there needs 4 · 8192-row blocks).
    small, _, _ = fill_store(data, records, mesh=mesh, block=block, **ft)
    small_ref, _, _ = fill_store(data, records, block=block, **ft)
    q_dense, q_sparse, text_q = queries
    deep = dict(dense_queries=q_dense, sparse_queries=q_sparse, text_queries=text_q, top_k=top_k,
                search_params=full_depth)
    reset_counts()
    got = small.query_batch(**deep)
    launches["three_way"] = read_counts()
    require(
        launches["three_way"]["section"] == MESH_SHARDS and launches["three_way"]["rescore"] == 2 * MESH_SHARDS,
        f"mesh 3-way: launches {launches['three_way']}",
    )
    three_way_tied = held_unless_tied(
        got, small_ref.query_batch(**deep), section_arm_ties(small_ref, queries, top_k, 512), "mesh 3-way"
    )
    rng = np.random.default_rng(seed + 8000)
    dead = [records[r]["id"] for r in rng.choice(n_small, size=n_small // 20, replace=False)]
    for s in (small, small_ref):
        s.delete(dead)
        require(s.compact() == len(dead), "mesh: compact count")
    compacted = small.query_batch(**deep)
    compacted_tied = held_unless_tied(
        compacted, small_ref.query_batch(**deep), section_arm_ties(small_ref, queries, top_k, 512),
        "mesh compacted",
    )
    require(not set(dead) & {h.id for r in compacted for h in r}, "mesh: a deleted id was returned")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        small.save(os.path.join(tmp, "mesh"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = DeviceVectorStore.load(os.path.join(tmp, "mesh"), mesh=mesh)
        load_s = time.perf_counter() - t0
        small_ref.save(os.path.join(tmp, "single"))
        from_single = DeviceVectorStore.load(os.path.join(tmp, "single"), mesh=mesh)
    for what, s in (("loaded", loaded), ("saved unsharded", from_single)):
        require(isinstance(s._dense, RowSharded) and s.mesh is mesh, f"mesh: {what} store is not sharded")
        require(hits(s.query_batch(**deep)) == hits(compacted), f"mesh: the {what} store answers otherwise")
    del small, small_ref, loaded, from_single
    torch.cuda.empty_cache()

    # (f) The exact sparse mode at 196,608 rows, held to the unsharded scan.
    n_exact = MESH_EXACT_ROWS
    exact_recs = data["records"][:n_exact]
    exact, _, _ = fill_store(data, exact_recs, mesh=mesh, block=block, sparse_mode="exact")
    exact_ref, _, _ = fill_store(data, exact_recs, sparse_mode="exact")
    _, q_sparse, _ = small_queries(data["records"], texts, n_exact, FT_EXACT_BATCH, seed + 9000)
    same_hits_within(
        exact.query_batch(sparse_queries=q_sparse, top_k=top_k),
        exact_ref.query_batch(sparse_queries=q_sparse, top_k=top_k),
        "mesh exact",
    )
    del exact, exact_ref
    torch.cuda.empty_cache()

    result = dict(
        card=card, mesh=dict(dp=MESH_DP, tp=MESH_TP, devices="one card, repeated"),
        rows=STORE_ROWS, capacity=capacity, state_gb=state_gb, ingest_s=ingest_s,
        source_row_in_top10=hit, batch=data["batch"],
        xla=dict(
            batch_ms=xla_host, batch_event_ms=xla_events, batch_event_ms_median=float(np.median(xla_events)),
            unsharded_batch_event_ms=ref_events, unsharded_batch_event_ms_median=float(np.median(ref_events)),
            queries_differing_from_plain_on_a_tie=differ,
            queries_with_a_better_sparse_arm=held["queries_with_a_better_sparse_arm"],
            idle_share=profile["idle_share"],
        ),
        **tables, per_shard=per_shard,
        three_way=dict(
            rows=n_small, deleted=len(dead), save_s=save_s, load_s=load_s,
            queries_differing_on_a_tie=three_way_tied, compacted_queries_differing_on_a_tie=compacted_tied,
        ),
        exact=dict(rows=n_exact, batch=FT_EXACT_BATCH),
        launches={k: sum(c[k] for c in launches.values()) for k in launches["xla"]},
        launches_by_program=launches, phase_s=time.perf_counter() - t_phase,
    )
    log("mesh", json.dumps(result))
    return result


#: The processes phase: ranks sharing the card in one gloo group (NCCL
#: refuses two ranks on one device), mesh positions a rank, the group's rows
#: (the store phases' shapes), timed batches a program, the programs it runs,
#: and each program's arms (one pair all_gather each) and its section and
#: rescore launches a position and batch.
PROC_RANKS, PROC_POSITIONS = 2, 2
PROC_ROWS = 1 << 20
PROC_TIMED = 3
PROC_TOP_K, PROC_FETCH_K, PROC_DEPTH = 10, 20, 256
PROC_VOCAB, PROC_NNZ, PROC_QM = 30522, 128, 32
#: The sparse scan's queries (`sharded_sparse_topk` gathers every row's
#: slots for each query: 64 keeps it to milliseconds at 1M rows a shard).
PROC_SCAN_QUERIES = 64
PROC_PROGRAMS = {  # name: (arms, section launches, rescore launches)
    "section": (2, 1, 1), "xla": (2, 0, 1), "dense": (1, 0, 0), "projected": (1, 0, 1), "sparse": (1, 0, 0),
}
PROC_PHASE_PROGRAMS = ("section", "xla", "dense")
#: A run of a program: once for its result, `PROC_TIMED` times by events,
#: once with its gathers timed.
PROC_BATCHES = 1 + PROC_TIMED + 1


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def process_projection():
    """The store's SPLADE projection matrix [30522, 768] on the card."""
    import torch

    from verbatim_rag_tpu_torch.ops.sparse_projected import projection_matrix

    return torch.from_numpy(projection_matrix(PROC_VOCAB, 768, 0)).cuda()


def process_block(seed: int, block: int, rows: int, projection) -> dict:
    """Block ``block`` of the processes phase's rows, made on the current
    card from the seed in the store phases' shapes: dense 384 and the
    forward index's 768-d sketch (`project_rows` through the store's
    projection), both int8 with row scales (`quantize_rows_int8`), a
    128-slot forward index over 30,522 ids, one row in 13 dead. Any process
    makes the same block."""
    import torch

    from verbatim_rag_tpu_torch.ops.dense import normalize_rows, quantize_rows_int8
    from verbatim_rag_tpu_torch.ops.sparse_projected import project_rows

    gen = torch.Generator(device="cuda").manual_seed(seed * 7919 + block)
    dense = torch.randn(rows, 384, generator=gen, device="cuda")
    ids = torch.randint(1, PROC_VOCAB, (rows, PROC_NNZ), generator=gen, device="cuda", dtype=torch.int32)
    w = torch.rand(rows, PROC_NNZ, generator=gen, device="cuda")
    dense, dense_scale = quantize_rows_int8(normalize_rows(dense))
    sketch, sketch_scale = quantize_rows_int8(project_rows(ids, w, projection))
    mask = (torch.arange(rows, device="cuda") + block * rows) % 13 != 0
    return dict(dense=dense, dense_scale=dense_scale, sketch=sketch, sketch_scale=sketch_scale, ids=ids, w=w,
                mask=mask)


def process_programs(placed: dict, mesh, seed: int, projection) -> dict:
    """The sharded searches over ``placed`` (name → row-sharded array) on
    one 512-query batch made from the seed: the section program with the
    rescore kernel, the hybrid program on "xla", dense top-k, the projected
    sparse search (rescore kernel) and the exact scan (its first
    `PROC_SCAN_QUERIES` queries)."""
    import torch

    from verbatim_rag_tpu_torch.ops.dense import normalize_rows
    from verbatim_rag_tpu_torch.ops.sparse_projected import project_query_arrays
    from verbatim_rag_tpu_torch.parallel import sharded_search as ss

    gen = torch.Generator(device="cuda").manual_seed(seed * 7919 + 999)
    dq = normalize_rows(torch.randn(512, 384, generator=gen, device="cuda"))
    q_ids = torch.randint(1, PROC_VOCAB, (512, PROC_QM), generator=gen, device="cuda", dtype=torch.int32)
    q_w = torch.rand(512, PROC_QM, generator=gen, device="cuda")
    sq = project_query_arrays(q_ids, q_w, projection)
    q_scan = torch.zeros(PROC_SCAN_QUERIES, PROC_VOCAB, device="cuda")
    q_scan.scatter_add_(1, q_ids[:PROC_SCAN_QUERIES].long(), q_w[:PROC_SCAN_QUERIES])
    p = placed
    common = (p["dense"], p["sketch"], p["ids"], p["w"], dq, sq, q_ids, q_w)
    hybrid = dict(k=PROC_TOP_K, fetch_k=PROC_FETCH_K, depth=PROC_DEPTH, mask=p["mask"], mesh=mesh,
                  dense_scale=p["dense_scale"], sketch_scale=p["sketch_scale"], rescore_impl="pallas")
    return {
        "section": lambda: ss.sharded_hybrid_section_topk(*common, block_cols=16384, **hybrid),
        "xla": lambda: ss.sharded_hybrid_topk(*common, candidate_impl="xla", **hybrid),
        "dense": lambda: ss.sharded_dense_topk(p["dense"], dq, PROC_TOP_K, p["mask"], mesh,
                                               corpus_scale=p["dense_scale"]),
        "projected": lambda: ss.sharded_projected_sparse_topk(
            p["sketch"], p["ids"], p["w"], sq, q_ids, q_w, PROC_TOP_K, PROC_DEPTH, p["mask"], mesh,
            sketch_scale=p["sketch_scale"], rescore_impl="pallas"),
        "sparse": lambda: ss.sharded_sparse_topk(p["ids"], p["w"], q_scan, PROC_TOP_K, p["mask"], mesh),
    }


def run_programs(programs: dict, names) -> dict:
    """Each named program once (its result kept), `PROC_TIMED` times by
    CUDA events on the current card's stream (a call ends in its layout
    check's readback and the merges' selections), and once with each pair
    all_gather timed by the host clock between synchronizations (that time
    includes the wait for the slowest rank); the kernels' launches and the
    pair gathers counted over those `PROC_BATCHES` runs."""
    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.parallel import sharded_search as ss

    plain_gather, out = ss._gather_pairs, {}
    for name in names:
        run = programs[name]
        reset_counts()
        gathers = ss.gathers
        scores, rows = run()
        events = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROC_TIMED):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROC_TIMED
        gather_ms = []

        def timed_gather(s, r):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pairs = plain_gather(s, r)
            torch.cuda.synchronize()
            gather_ms.append((time.perf_counter() - t) * 1e3)
            return pairs

        ss._gather_pairs = timed_gather
        try:
            run()
        finally:
            ss._gather_pairs = plain_gather
        event_ms = [s.elapsed_time(e) for s, e in events]
        out[name] = dict(
            scores=scores.cpu(), rows=rows.cpu(), launches=read_counts(), gathers=ss.gathers - gathers,
            batch_event_ms=event_ms, batch_event_ms_median=float(np.median(event_ms)), batch_wall_ms=wall_ms,
            gather_ms_by_arm=gather_ms,
        )
    return out


def plant_offset_fault(rank: int) -> None:
    """Rank 1's global offsets shifted by one shard (a planted fault)."""
    from verbatim_rag_tpu_torch.parallel import sharded_search as ss

    if rank == 1:
        ss._Layout.offset = lambda self, i: (self.first + i + 1) * self.n_local


def held_to_one_process(ranks: list, oracle: dict, names, positions: int, what: str) -> dict:
    """Every rank's results (`run_programs`, with ``planted_rows``: the
    section program's rows with `plant_offset_fault`) against ``oracle``
    (name → one process's (scores, rows) over the same shards): bit-equal,
    the launches and gathers of `PROC_PROGRAMS` on each rank, and the
    planted fault failing the comparison. The per-program record."""
    import torch

    programs = {}
    for name in names:
        scores, rows = oracle[name]
        require(
            bool(torch.isfinite(scores).all()) and bool((rows >= 0).all()) and scores.shape[1] == PROC_TOP_K,
            f"{what} {name}: the one-process result is malformed",
        )
        arms, sections, rescores = PROC_PROGRAMS[name]
        for r in ranks:
            got = r["programs"][name]
            require(
                torch.equal(got["rows"], rows) and torch.equal(got["scores"], scores),
                f"{what} {name}: rank {r['rank']} differs from one process's mesh over the same rows",
            )
            launches = got["launches"]
            require(
                (launches["section"], launches["rescore"])
                == (PROC_BATCHES * positions * sections, PROC_BATCHES * positions * rescores)
                and got["gathers"] == PROC_BATCHES * arms,
                f"{what} {name}: rank {r['rank']} launches {launches}, {got['gathers']} gathers",
            )
        programs[name] = dict(
            bit_equal_on_every_rank=True, queries=scores.shape[0],
            batch_event_ms_by_rank=[r["programs"][name]["batch_event_ms"] for r in ranks],
            batch_event_ms_median_by_rank=[r["programs"][name]["batch_event_ms_median"] for r in ranks],
            batch_wall_ms_by_rank=[r["programs"][name]["batch_wall_ms"] for r in ranks],
            gather_ms_by_rank=[r["programs"][name]["gather_ms_by_arm"] for r in ranks],
            section_launches_by_rank=[r["programs"][name]["launches"]["section"] for r in ranks],
            rescore_launches_by_rank=[r["programs"][name]["launches"]["rescore"] for r in ranks],
        )
    for r in ranks:
        require(
            not torch.equal(r["planted_rows"], oracle["section"][1]),
            f"{what}: rank {r['rank']}'s result with a planted offset on rank 1 passes the check",
        )
    return programs


def serve_rank(rank: int, seed: int, rows: int, mesh, names, out_dir: str) -> None:
    """One rank of a group already up: its block of ``rows`` rows over
    ``mesh`` (`process_block`, `shard_process_rows`), `run_programs` of
    ``names``, then the section program once with `plant_offset_fault`;
    written to ``out_dir``/rank<r>.pt."""
    import torch

    from verbatim_rag_tpu_torch.parallel import sharded_search as ss

    projection = process_projection()
    t0 = time.perf_counter()
    block = process_block(seed, rank, rows, projection)
    placed = {name: ss.shard_process_rows(x, mesh) for name, x in block.items()}
    del block
    torch.cuda.synchronize()
    rows_made_s = time.perf_counter() - t0
    programs = process_programs(placed, mesh, seed, projection)
    out = dict(rank=rank, rows_made_s=rows_made_s, placed_rows=placed["dense"].shape[0],
               programs=run_programs(programs, names))
    plant_offset_fault(rank)
    out["planted_rows"] = programs["section"]()[1].cpu()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def one_process_oracle(seed: int, blocks: int, rows: int, mesh, names) -> dict:
    """``names``' (scores, rows) on the host from one process's ``mesh``
    over the group's rows: blocks 0 .. ``blocks`` − 1 of ``rows`` rows made
    on the current card and laid end to end, so that rank b's position i is
    shard b·P + i, as in the group."""
    import torch

    from verbatim_rag_tpu_torch.parallel import row_sharding

    projection = process_projection()
    made = [process_block(seed, b, rows, projection) for b in range(blocks)]
    placed = {name: row_sharding(torch.cat([b[name] for b in made]), mesh) for name in made[0]}
    del made
    programs = process_programs(placed, mesh, seed, projection)
    oracle = {name: tuple(x.cpu() for x in programs[name]()) for name in names}
    del placed, programs
    torch.cuda.empty_cache()
    return oracle


def process_worker(rank: int, port: int, seed: int, out_dir: str) -> None:
    """One rank of the processes phase: a gloo group, `PROC_POSITIONS`
    positions on the card, `serve_rank`."""
    import torch

    sys.path.insert(0, str(ROOT))
    from verbatim_rag_tpu_torch.parallel import distributed, make_mesh

    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=PROC_RANKS, rank=rank
    )
    require(distributed.process_count() == PROC_RANKS, "processes: the group is not up")
    mesh = make_mesh(dp=1, tp=PROC_POSITIONS, devices=[torch.device("cuda")] * PROC_POSITIONS)
    serve_rank(rank, seed, PROC_ROWS // PROC_RANKS, mesh, PROC_PHASE_PROGRAMS, out_dir)
    torch.distributed.destroy_process_group()


def run_processes(seed: int, card: str) -> dict:
    """The group path of the sharded searches (see the module docstring,
    5f): `PROC_RANKS` processes on the one card, held to one process's
    4-position mesh over the same rows (the mesh phase's layout)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from verbatim_rag_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
        t0 = time.perf_counter()
        mp.spawn(process_worker, args=(free_port(), seed, out_dir), nprocs=PROC_RANKS, join=True)
        group_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(PROC_RANKS)]
    mesh = make_mesh(dp=2, tp=2, devices=[torch.device("cuda")] * (PROC_RANKS * PROC_POSITIONS))
    oracle = one_process_oracle(seed, PROC_RANKS, PROC_ROWS // PROC_RANKS, mesh, PROC_PHASE_PROGRAMS)
    held = held_to_one_process(ranks, oracle, PROC_PHASE_PROGRAMS, PROC_POSITIONS, "processes")
    launches = {
        k: sum(r["programs"][name]["launches"][k] for r in ranks for name in PROC_PHASE_PROGRAMS)
        for k in kernel_counters()
    }
    result = dict(
        card=card, group="gloo, 2 ranks on one card (NCCL refuses two ranks on one device): "
        "the CUDA pairs go through host memory", ranks=PROC_RANKS, positions_a_rank=PROC_POSITIONS,
        rows=PROC_ROWS, rows_a_rank=[r["placed_rows"] for r in ranks], batch=512, top_k=PROC_TOP_K,
        depth=PROC_DEPTH, batches_a_program=PROC_BATCHES, rows_made_s_by_rank=[r["rows_made_s"] for r in ranks],
        group_s_with_start=group_s, planted_offset_caught=True, programs=held, launches=launches,
        launches_by_rank={
            k: [sum(r["programs"][n]["launches"][k] for n in PROC_PHASE_PROGRAMS) for r in ranks]
            for k in ("section", "rescore")
        },
        phase_s=time.perf_counter() - t_phase,
    )
    log("processes", json.dumps(result))
    return result


def bench_texts(data, seed: int) -> list[str]:
    """The full_text phase's synthetic texts of the store records, made once."""
    if "texts" not in data:
        data["texts"] = text_corpus(seed, STORE_ROWS)
    return data["texts"]


#: The full_text phase: the words of the synthetic texts (made from the
#: seed), each text's word count, the query texts' word count, the Zipf
#: exponent of word frequencies, and the sizes of its smaller stores.
TEXT_VOCAB_WORDS = 30_000
TEXT_WORDS = (16, 64)
TEXT_QUERY_WORDS = (4, 12)
TEXT_ZIPF = 1.1
FT_HOUSEKEEPING_ROWS = 65_536
FT_EXACT_ROWS = 196_608
FT_EXACT_BATCH = 64
FT_EXACT_CHECKED = 8
FT_BUCKET_BATCHES = 2
FT_SCANNER_TEXTS = 65_536


def text_corpus(seed: int, n: int) -> list[str]:
    """``n`` synthetic chunk texts: 16-64 words each, drawn Zipf-like (rank
    r with weight r^-1.1) from a 30,000-word vocabulary of random lowercase
    words, everything made from the seed."""
    import numpy as np

    rng = np.random.default_rng(seed + 7)
    letters = rng.integers(97, 123, size=(TEXT_VOCAB_WORDS, 10), dtype=np.uint8)
    lengths = rng.integers(3, 11, size=TEXT_VOCAB_WORDS)
    words = np.array([row[:k].tobytes().decode() for row, k in zip(letters, lengths)], dtype=object)
    p = 1.0 / np.arange(1, TEXT_VOCAB_WORDS + 1) ** TEXT_ZIPF
    counts = rng.integers(TEXT_WORDS[0], TEXT_WORDS[1] + 1, size=n)
    drawn = words[rng.choice(TEXT_VOCAB_WORDS, size=int(counts.sum()), p=p / p.sum())]
    ends = np.cumsum(counts)
    return [" ".join(drawn[e - c : e]) for e, c in zip(ends.tolist(), counts.tolist())]


def text_queries(texts, src, seed: int) -> list[str]:
    """One query text per source row: 4-12 consecutive words of its text."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for s in src:
        words = texts[int(s)].split()
        k = int(rng.integers(TEXT_QUERY_WORDS[0], TEXT_QUERY_WORDS[1] + 1))
        start = int(rng.integers(0, max(len(words) - k, 0) + 1))
        out.append(" ".join(words[start : start + k]))
    return out


def ft_batch(store, data, texts, i: int, top_k: int):
    """The store phase's query batch ``i`` with 3-way text queries added."""
    q_dense, q_sparse, src = data["queries"](i)
    text_q = text_queries(texts, src, 1000 + i)
    return store.query_batch(
        dense_queries=q_dense, sparse_queries=q_sparse, text_queries=text_q, top_k=top_k
    ), src, text_q


def small_queries(records, texts, n_rows: int, batch: int, seed: int):
    """A 3-way batch over the first ``n_rows`` records: dense and sparse
    queries from source rows (as `bench_data`'s), text queries from theirs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_rows, size=batch)
    q_dense = np.stack([records[s]["dense"] for s in src]) + 0.5 * rng.standard_normal(
        (batch, len(records[0]["dense"])), dtype=np.float32
    )
    q_ids = np.stack([records[s]["sparse_arrays"][0][:32] for s in src])
    q_w = rng.random(q_ids.shape, dtype=np.float32)
    return q_dense, (q_ids, q_w), text_queries(texts, src, seed)


def three_way(store, queries, top_k: int = 10):
    q_dense, q_sparse, text_q = queries
    return store.query_batch(dense_queries=q_dense, sparse_queries=q_sparse, text_queries=text_q, top_k=top_k)


def hits(results) -> list[list[tuple]]:
    return [[(h.id, h.score) for h in row] for row in results]


def reference_topk(ids, weights, qvec, k: int):
    """float64 top-k of Σ_j weights[n, j] · qvec[ids[n, j]] over every row
    (rows with a score above 0): (rows, scores of every row)."""
    import numpy as np

    scores = (weights.astype(np.float64) * qvec[ids]).sum(axis=1)
    order = np.lexsort((np.arange(scores.size), -scores))[:k]
    return [int(r) for r in order if scores[r] > 0], scores


def held_to_reference(rows, ref_rows, scores, what: str) -> int:
    """Rows equal to the float64 reference's, except where their reference
    scores tie within 1e-6 relative; the count of such tie swaps."""
    swaps = 0
    require(len(rows) == len(ref_rows), f"{what}: {len(rows)} rows, reference {len(ref_rows)}")
    for got, ref in zip(rows, ref_rows):
        if got == ref:
            continue
        swaps += 1
        require(
            abs(scores[got] - scores[ref]) <= 1e-6 * max(abs(scores[ref]), 1e-30),
            f"{what}: row {got} (score {scores[got]}) where the reference has {ref} ({scores[ref]})",
        )
    return swaps


def run_full_text(data, card: str, seed: int) -> dict:
    """The BM25 full-text tier on the card (see the module docstring, 5b)."""
    import tempfile

    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.engine import analyzer
    from verbatim_rag_tpu_torch.engine import store as store_mod
    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore
    from verbatim_rag_tpu_torch.models import HashTokenizer

    t_phase = time.perf_counter()
    top_k, n_batches = 10, STORE_BATCHES
    t0 = time.perf_counter()
    texts = bench_texts(data, seed)
    records = [dict(rec, text=text) for rec, text in zip(data["records"], texts)]
    texts_s = time.perf_counter() - t0
    ft_kwargs = dict(dense_dtype="int8", sketch_dtype="int8", enable_full_text=True)

    # Ingest, with the analyzer's share timed by a wrapper.
    analyzer_s = [0.0]

    def timed_analyze(*args, **kwargs):
        t = time.perf_counter()
        out = analyzer.analyze_texts(*args, **kwargs)
        analyzer_s[0] += time.perf_counter() - t
        return out

    store_mod.analyze_texts = timed_analyze
    reset_counts()
    try:
        store, ingest_s, state_gb = fill_store(data, records, **ft_kwargs)
    finally:
        store_mod.analyze_texts = analyzer.analyze_texts
    require(store.candidate_impl == "section", f"full_text: impl {store.candidate_impl}")
    require(
        store.full_text_max_nnz == 256 and store.full_text_vocab == 1 << 17,
        "full_text: not the default full-text shape",
    )
    ingest_counts = read_counts()
    ingest_scanner = scanner_counts()
    require(
        ingest_scanner["analyze_texts"] == STORE_ROWS,
        f"full_text: the ingest's analyzer did not take the host scanner {ingest_scanner}",
    )
    log(f"full_text: {STORE_ROWS} records ingested in {ingest_s:.1f} s (analyzer {analyzer_s[0]:.1f} s)")

    # 3-way batches: one untimed, then timed by the host clock and CUDA events.
    reset_counts()
    first, src, first_text = ft_batch(store, data, texts, 0, top_k)
    require(all(len(r) == top_k for r in first), "full_text: result shape")
    require(all(math.isfinite(h.score) and h.score > 0 for r in first for h in r), "full_text: scores")
    hit = float(np.mean([str(s) in {h.id for h in r} for s, r in zip(src, first)]))
    host_ms, event_ms = [], []
    for i in range(1, n_batches + 1):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out, _, _ = ft_batch(store, data, texts, i, top_k)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
        require(len(out) == data["batch"], "full_text: batch size")
    counts = read_counts()
    scanner = scanner_counts()
    require(
        scanner["analyze_calls"] == n_batches + 1,
        f"full_text: the text queries did not take the host scanner once a batch {scanner}",
    )
    per_batch = {k: v / (n_batches + 1) for k, v in counts.items() if v}
    require(
        counts["section"] == n_batches + 1 and counts["rescore"] == 2 * (n_batches + 1),
        f"full_text: launches {counts} (one section launch and two rescores a batch)",
    )
    same_rows_with_plain_tables(store, data, top_k, first, "full_text", text_queries=first_text)
    host = check_scanner(texts[:FT_SCANNER_TEXTS], HashTokenizer(), "full_text", reps=2)
    q_dense, q_sparse, src1 = data["queries"](1)
    text1 = text_queries(texts, src1, 1001)
    profile = device_profile(
        lambda: store.query_batch(dense_queries=q_dense, sparse_queries=q_sparse, text_queries=text1, top_k=top_k),
        top=10,
    )
    log("full_text profile", json.dumps(profile))
    # The BM25 query side on the host (analysis, idf dicts, host sketches,
    # padding, upload) for one batch's text queries.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store._sparse_query_device(store._bm25_query_sparse(text1), store.full_text_vocab)
    torch.cuda.synchronize()
    text_prep_ms = (time.perf_counter() - t0) * 1e3

    # candidate_impl="bucket": bucket-max v2 per arm (three launches a batch).
    store.candidate_impl = "bucket"
    before = read_counts()
    bucket_first, _, _ = ft_batch(store, data, texts, 0, top_k)
    bucket_ms = []
    for i in range(1, FT_BUCKET_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ft_batch(store, data, texts, i, top_k)
        bucket_ms.append((time.perf_counter() - t0) * 1e3)
    after = read_counts()
    require(
        after["bucket_max_v2"] - before["bucket_max_v2"] == 3 * FT_BUCKET_BATCHES
        and after["rescore"] - before["rescore"] == 2 * FT_BUCKET_BATCHES,
        f"full_text bucket: launches {after} (from {before})",
    )
    same_rows_with_plain_tables(store, data, top_k, bucket_first, "full_text bucket", text_queries=first_text)
    counts = read_counts()
    del store
    torch.cuda.empty_cache()

    # Housekeeping at 65,536 rows, built in one flush: delete 5%, compact,
    # save, load.
    n_small = FT_HOUSEKEEPING_ROWS
    small, small_ingest_s, _ = fill_store(data, records[:n_small], **ft_kwargs)
    queries = small_queries(records, texts, n_small, data["batch"], seed + 2000)
    rng = np.random.default_rng(seed + 3000)
    dead_rows = np.sort(rng.choice(n_small, size=n_small // 20, replace=False))
    dead = [records[r]["id"] for r in dead_rows]
    df_before = small._doc_freq.copy()
    dead_dev = torch.as_tensor(dead_rows, device=small.device)
    ft_ids, ft_tf = small._ft_ids[dead_dev].cpu().numpy(), small._ft_tf[dead_dev].cpu().numpy()
    expected_drop = np.bincount(ft_ids[ft_tf > 0], minlength=small.full_text_vocab)
    small.delete(dead)
    require(np.array_equal(df_before - small._doc_freq, expected_drop), "full_text: df drop after delete")
    after_delete = three_way(small, queries)
    require(not set(dead) & {h.id for r in after_delete for h in r}, "full_text: a deleted id was returned")
    idf_before = small._bm25_query_sparse(queries[2])
    t0 = time.perf_counter()
    reclaimed = small.compact()
    compact_s = time.perf_counter() - t0
    require(reclaimed == len(dead) and small.count() == n_small - len(dead), "full_text: compact count")
    require(small._bm25_query_sparse(queries[2]) == idf_before, "full_text: idf changed by compact")
    compacted = three_way(small, queries)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        small.save(os.path.join(tmp, "ft"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = DeviceVectorStore.load(os.path.join(tmp, "ft"), device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    require(
        loaded._dense.device == small._dense.device and loaded.count() == small.count(),
        "full_text: loaded store",
    )
    require(torch.equal(loaded._dense[:small.count()], small._dense[:small.count()]), "full_text: int8 codes")
    require(hits(three_way(loaded, queries)) == hits(compacted), "full_text: the loaded store answers otherwise")
    del small, loaded
    torch.cuda.empty_cache()

    # The exact sparse mode at 196,608 rows, held to a float64 scoring.
    n_exact = FT_EXACT_ROWS
    exact, exact_ingest_s, _ = fill_store(
        data, records[:n_exact], enable_full_text=True, sparse_mode="exact"
    )
    q_dense, (q_ids, q_w), text_q = small_queries(records, texts, n_exact, FT_EXACT_BATCH, seed + 4000)
    t0 = time.perf_counter()
    sparse_out = exact.query_batch(sparse_queries=(q_ids, q_w), top_k=top_k)
    sparse_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    text_out = exact.query_batch(text_queries=text_q, top_k=top_k)
    text_ms = (time.perf_counter() - t0) * 1e3
    sp_ids = exact._sp_ids[:n_exact].cpu().numpy()
    sp_w = exact._sp_w[:n_exact].cpu().numpy()
    ft_ids = exact._ft_ids[:n_exact].cpu().numpy()
    tf = exact._ft_tf[:n_exact].cpu().numpy().astype(np.float64)
    dl = exact._doc_len[:n_exact].astype(np.float64)
    k1, b = exact.bm25_k1, exact.bm25_b
    avgdl = max(dl.mean(), 1.0)
    bm25_w = np.where(tf > 0, tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl[:, None] / avgdl)), 0.0)
    df = exact._doc_freq.astype(np.float64)
    idf = np.log1p((n_exact - df + 0.5) / (df + 0.5))
    swaps = 0
    for i in range(FT_EXACT_CHECKED):
        # The query's {term: weight} dict (a repeated id keeps its last
        # weight), as the store reads an array payload in exact mode.
        terms = dict(zip(q_ids[i].tolist(), q_w[i].tolist()))
        qvec = np.zeros(exact.sparse_vocab, np.float64)
        qvec[list(terms)] = list(terms.values())
        ref_rows, scores = reference_topk(sp_ids, sp_w, qvec, top_k)
        swaps += held_to_reference([int(h.id) for h in sparse_out[i]], ref_rows, scores, f"exact sparse {i}")
        qvec = np.zeros(exact.full_text_vocab, np.float64)
        terms, _, _ = analyzer.analyze(text_q[i], exact.full_text_vocab)
        qvec[terms] = idf[terms]
        ref_rows, scores = reference_topk(ft_ids, bm25_w, qvec, top_k)
        swaps += held_to_reference([int(h.id) for h in text_out[i]], ref_rows, scores, f"exact text {i}")
    require(all(len(r) == top_k for r in text_out[:FT_EXACT_CHECKED]), "full_text: exact text hits")
    del exact
    torch.cuda.empty_cache()

    ms = float(np.median(host_ms))
    result = dict(
        card=card, rows=STORE_ROWS, texts_s=texts_s, ingest_s=ingest_s, analyzer_s=analyzer_s[0],
        ingest_rest_s=ingest_s - analyzer_s[0], state_gb=state_gb, batch=data["batch"],
        batch_ms_median=ms, batch_ms=host_ms, batch_event_ms=event_ms,
        batch_event_ms_median=float(np.median(event_ms)), qps=data["batch"] / ms * 1e3,
        source_row_in_top10=hit, launches_per_batch=per_batch, ingest_launches=ingest_counts,
        idle_share=profile["idle_share"], profile_wall_ms=profile["wall_ms"], kernel_ms=profile["kernel_ms"],
        text_query_prep_ms=text_prep_ms, bucket_batch_ms=bucket_ms,
        ingest_scanner=ingest_scanner, scanner=scanner, host_scanner=host,
        housekeeping=dict(
            rows=n_small, ingest_s=small_ingest_s, deleted=len(dead), compact_s=compact_s,
            save_s=save_s, load_s=load_s,
        ),
        exact=dict(
            rows=n_exact, ingest_s=exact_ingest_s, batch=FT_EXACT_BATCH, sparse_ms=sparse_ms,
            text_ms=text_ms, checked=FT_EXACT_CHECKED, tie_swaps=swaps,
        ),
        launches=counts, phase_s=time.perf_counter() - t_phase,
    )
    log("full_text", json.dumps(result))
    return result


CLI_QUESTION = "How efficient are solar panels?"


def run_cli(card: str) -> dict:
    """The CLI's round trip on the card, each command its own process:
    ``index examples/example_docs --sparse --neural``, then ``query ...
    --json``; every highlight verbatim, and the retrieved chunks those of an
    in-process `VerbatimIndex.load` + `VerbatimRAG.query` (whose extractor's
    flash launches are counted)."""
    import tempfile

    from verbatim_rag_tpu_torch.engine import VerbatimIndex
    from verbatim_rag_tpu_torch.rag import VerbatimRAG

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cli = [sys.executable, "-m", "verbatim_rag_tpu_torch.rag.cli"]
    with tempfile.TemporaryDirectory() as tmp:
        db, out = os.path.join(tmp, "idx"), os.path.join(tmp, "resp.json")
        seconds = {}
        for name, argv in (
            ("index", ["index", "examples/example_docs", "--db", db, "--sparse", "--neural"]),
            ("query", ["query", CLI_QUESTION, "--db", db, "--json", out]),
        ):
            t0 = time.perf_counter()
            proc = subprocess.run(cli + argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
            seconds[name] = time.perf_counter() - t0
            require(proc.returncode == 0, f"cli {name}: exit {proc.returncode}: {proc.stderr[-2000:]}")
            log(f"cli {name} ({seconds[name]:.1f} s):", proc.stdout.strip().splitlines()[0])
        with open(out) as f:
            response = json.load(f)
        docs = response["documents"]
        require(bool(docs), "cli: no documents")
        n_highlights = 0
        for d in docs:
            for h in d["highlights"]:
                require(d["content"][h["start"] : h["end"]] == h["text"], "cli: highlight not verbatim")
                n_highlights += 1
        reset_counts()
        index = VerbatimIndex.load(db)
        require(index.store._dense.is_cuda, "cli: the loaded index is not on the card")
        in_process = VerbatimRAG(index).query(CLI_QUESTION)
        counts = read_counts()
        del index
    key = lambda m: (m["document_id"], m["chunk_index"])  # noqa: E731
    require(
        [key(d["metadata"]) for d in docs] == [key(d.metadata) for d in in_process.documents],
        "cli: the query process retrieved other chunks than the in-process load",
    )
    require(counts["flash_attention"] > 0 and counts["rescore"] > 0, f"cli: launches {counts}")
    result = dict(
        card=card, index_s=seconds["index"], query_s=seconds["query"], documents=len(docs),
        highlights=n_highlights, launches=counts, phase_s=time.perf_counter() - t_phase,
    )
    log("cli", json.dumps(result))
    return result


#: The long phases' question; their document is `long_document`'s.
LONG_QUESTION = "How do solar panels store energy?"


def long_document(seed: int) -> str:
    """≈ 22.8k tokens: 19,000 words drawn from the example documents."""
    import numpy as np

    words = (ROOT / "examples" / "example_docs" / "solar.md").read_text().split()
    words += (ROOT / "examples" / "example_docs" / "wind.md").read_text().split()
    rng = np.random.default_rng(seed)
    return " ".join(rng.choice(words, size=19000))


def run_long(extractor, seed: int, card: str) -> dict:
    import torch

    text = long_document(seed)
    plan = extractor._plan(LONG_QUESTION, text)
    require(len(plan["rows"]) == 3, f"long: {len(plan['rows'])} windows, expected 3")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spans = extractor.process(LONG_QUESTION, text)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    scanner = scanner_counts()
    require(counts["flash_attention"] == extractor.config.num_layers, f"long: launches {counts}")
    require(scanner["tokenize_calls"] > 0, f"long: the tokenizer never took the host scanner {scanner}")
    profile = device_profile(lambda: extractor.process(LONG_QUESTION, text))
    log("long profile", json.dumps(profile))
    require(all(0 <= s < e <= len(text) for s, e in spans), "long: span offsets")
    host = check_scanner([text], extractor.tokenizer, "long", reps=5)
    result = dict(
        card=card, tokens=plan["n_tokens"], windows=len(plan["rows"]), seconds=seconds,
        spans=len(spans), launches=counts, scanner=scanner, host_scanner=host,
        profile_wall_ms=profile["wall_ms"], kernel_ms=profile["kernel_ms"], idle_share=profile["idle_share"],
    )
    log("long", json.dumps(result))
    return result


def run_long_sp(extractor, seed: int, card: str) -> dict:
    """The long document in one sequence-parallel pass over SP_SHARDS shards
    on the card, with the long extractor's weights; held to the
    single-device forward on the same row."""
    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.models import (
        ModelSpanExtractor,
        select_spans_from_token_probs,
        token_relevance_probs,
    )
    from verbatim_rag_tpu_torch.models.tokenizer import bucket_length
    from verbatim_rag_tpu_torch.parallel import make_mesh

    text = long_document(seed)
    config = extractor.config
    mesh = make_mesh(dp=1, tp=SP_SHARDS, devices=[torch.device("cuda")] * SP_SHARDS)
    sp = ModelSpanExtractor(params=extractor.model.state_dict(), config=config, sp_mesh=mesh)
    plan = sp._plan(LONG_QUESTION, text)
    row = plan["rows"][0]
    seq = bucket_length(len(row))
    require(len(plan["rows"]) == 1 and seq == 24576, f"long_sp: {len(plan['rows'])} rows at S={seq}")
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spans = sp.process(LONG_QUESTION, text)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = read_counts()
    global_layers = sum(config.is_global_layer(i) for i in range(config.num_layers))
    expected = global_layers * SP_SHARDS**2
    require(
        counts["flash_attention_partial"] == expected and counts["flash_attention"] == 0,
        f"long_sp: launches {counts}, expected {expected} partial and no forward launch",
    )
    starts = {a for a, _ in plan["offsets"]}
    ends = {b for _, b in plan["offsets"]}
    require(
        bool(spans) and all(s in starts and e in ends and 0 <= s < e <= len(text) for s, e in spans),
        "long_sp: a span does not index the document on token boundaries",
    )

    # The same row through the single-device forward (one window at S=24576).
    ids = np.full((1, seq), sp.tokenizer.pad_id, np.int32)
    mask = np.zeros((1, seq), np.int32)
    ids[0, : len(row)] = row
    mask[0, : len(row)] = 1
    sp_probs = sp._forward_probs(ids, mask)[0]
    with torch.no_grad():
        single = token_relevance_probs(
            extractor.model, torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
        )[0].cpu().numpy()
    probs_diff = float(np.abs(sp_probs - single)[: len(row)].max())
    require(probs_diff <= SP_PROBS_ATOL, f"long_sp: probabilities differ by {probs_diff}")
    start, length, tok_offset = plan["layout"][0]
    agg = single[tok_offset : tok_offset + length]
    single_spans = select_spans_from_token_probs(
        agg, plan["offsets"], threshold=sp.threshold, min_span_chars=sp.min_span_chars,
        merge_gap_chars=sp.merge_gap_chars,
    )
    near = int((np.abs(agg - sp.threshold) <= SP_PROBS_ATOL).sum())
    require(
        spans == single_spans or near > 0,
        "long_sp: spans differ from the single-device forward's with no probability near the threshold",
    )
    profile = device_profile(lambda: sp.process(LONG_QUESTION, text), top=10)
    log("long_sp profile", json.dumps(profile))
    result = dict(
        card=card, tokens=plan["n_tokens"], seq=seq, shards=SP_SHARDS, seconds=seconds,
        spans=len(spans), spans_equal_single_device=spans == single_spans,
        tokens_within_tol_of_threshold=near, probs_max_abs_diff_vs_single_device=probs_diff,
        peak_memory_gb=peak_gb, launches=counts,
    )
    log("long_sp", json.dumps(result))
    result.update(probs=sp_probs[: len(row)], span_list=spans, threshold=sp.threshold)  # for sp_processes
    del sp
    torch.cuda.empty_cache()
    return result


#: The sp_processes phase: gloo ranks on the one card, positions a rank.
SP_PROC_RANKS, SP_PROC_POSITIONS = 2, 2


def sp_process_worker(rank: int, port: int, seed: int, out_dir: str) -> None:
    """One rank of the sp_processes phase: a gloo group, its
    `SP_PROC_POSITIONS` positions of the global sequence axis on the card,
    the long extractor's weights from the seed; one untimed pass, one timed
    (its probabilities kept), written to ``out_dir``/rank<r>.pt."""
    import torch

    sys.path.insert(0, str(ROOT))
    from verbatim_rag_tpu_torch.models import ModelSpanExtractor, modernbert_base_config
    from verbatim_rag_tpu_torch.parallel import distributed, exchange

    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=SP_PROC_RANKS, rank=rank
    )
    mesh = distributed.global_mesh(dp=1, tp=SP_SHARDS, devices=[torch.device("cuda")] * SP_PROC_POSITIONS)
    line = mesh.line("tp")
    require(line.group is not None and line.count == SP_PROC_POSITIONS, "sp_processes: the line does not span ranks")
    sp = ModelSpanExtractor(config=modernbert_base_config(), seed=seed, sp_mesh=mesh)
    text = long_document(seed)
    sp.process(LONG_QUESTION, text)
    probs, forward = [], sp._forward_probs
    sp._forward_probs = lambda ids, mask: probs.append(forward(ids, mask)) or probs[-1]
    reset_counts()
    exchange.handoffs, exchange.handoff_s = 0, 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    spans = sp.process(LONG_QUESTION, text)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = dict(
        rank=rank, first=line.first, seconds=seconds, spans=spans, launches=read_counts(),
        probs=probs[0][0][: len(sp._plan(LONG_QUESTION, text)["rows"][0])], handoffs=exchange.handoffs,
        handoff_ms=exchange.handoff_s * 1e3, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def run_sp_processes(seed: int, card: str, long_sp: dict) -> dict:
    """Phase 6c: long_sp's row across `SP_PROC_RANKS` processes on the
    card, held to long_sp's one-process pass."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from verbatim_rag_tpu_torch.models import modernbert_base_config

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
        mp.spawn(sp_process_worker, args=(free_port(), seed, out_dir), nprocs=SP_PROC_RANKS, join=True)
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(SP_PROC_RANKS)]
    config = modernbert_base_config()
    expected = sum(config.is_global_layer(i) for i in range(config.num_layers)) * SP_PROC_POSITIONS * SP_SHARDS
    for r in ranks:
        require(
            r["launches"]["flash_attention_partial"] == expected and r["launches"]["flash_attention"] == 0,
            f"sp_processes: rank {r['rank']} launches {r['launches']}, expected {expected} partial, no forward",
        )
    ref = long_sp["probs"]
    diffs = [float(np.abs(r["probs"] - ref).max()) for r in ranks]
    bit_equal = all(np.array_equal(r["probs"], ref) for r in ranks)
    require(max(diffs) <= SP_PROBS_ATOL, f"sp_processes: probabilities differ from one process's by {diffs}")
    require(all(r["spans"] == ranks[0]["spans"] for r in ranks), "sp_processes: the ranks decode different spans")
    near = int((np.abs(ref - long_sp["threshold"]) <= max(diffs)).sum()) if not bit_equal else 0
    same = ranks[0]["spans"] == long_sp["span_list"]
    require(same or near > 0, "sp_processes: spans differ from one process's with no probability near the threshold")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in kernel_counters()}
    result = dict(
        card=card, group="gloo, 2 ranks on one card: every hand-off staged through host memory",
        ranks=SP_PROC_RANKS, positions_a_rank=SP_PROC_POSITIONS, seq=long_sp["seq"], shards=SP_SHARDS,
        probs_bit_equal_one_process=bit_equal, probs_max_abs_diff_by_rank=diffs, spans=len(ranks[0]["spans"]),
        spans_equal_on_every_rank=True, spans_equal_one_process=same, tokens_within_diff_of_threshold=near,
        seconds_by_rank=[r["seconds"] for r in ranks], one_process_seconds=long_sp["seconds"],
        partial_launches_by_rank=[r["launches"]["flash_attention_partial"] for r in ranks],
        handoffs_by_rank=[r["handoffs"] for r in ranks], handoff_ms_by_rank=[r["handoff_ms"] for r in ranks],
        peak_memory_gb_by_rank=[r["peak_memory_gb"] for r in ranks], launches=launches,
        phase_s=time.perf_counter() - t_phase,
    )
    log("sp_processes", json.dumps(result))
    return result


#: The train phase: 4 optimizer steps at the CLI defaults (batch 8,
#: max_seq_length 4096), then one more under the profiler.
TRAIN_STEPS = 4
TRAIN_BATCH = 8
TRAIN_SEQ = 4096
TRAIN_HEADS = 12  # ModernBERT-base


def train_examples(n: int, seed: int, tokenizer, context_tokens: tuple[int, int] = (2200, 4000)) -> list:
    """``n`` synthetic token-span examples of ``context_tokens`` context tokens each
    (2.2k-4k by default): `make_synthetic_token_data` clauses concatenated,
    their gold spans shifted along, so each example is one window at a
    max_seq_length above the range (4096 by default) and a batch pads to it
    with ragged rows."""
    import numpy as np

    from verbatim_rag_tpu_torch.training.token_dataset import (
        TokenSpanExample,
        make_synthetic_token_data,
    )

    rng = np.random.default_rng(seed)
    pool = iter(make_synthetic_token_data(n * 100, seed=seed))
    examples = []
    for _ in range(n):
        target = int(rng.integers(*context_tokens))
        parts, spans, pos, tokens, question = [], [], 0, 0, None
        while tokens < target:
            ex = next(pool)
            question = question or ex.question
            parts.append(ex.context)
            spans += [(pos + a, pos + b) for a, b in ex.spans]
            pos += len(ex.context)
            tokens += len(tokenizer.tokenize_with_offsets(ex.context)[0])
        examples.append(TokenSpanExample(question=question, context="".join(parts), spans=spans))
    return examples


def run_train(seed: int, card: str) -> dict:
    """The token highlighter trained at full ModernBERT-base width through
    `Trainer`, then its checkpoint served on the card."""
    import shutil

    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.models import (
        HashTokenizer,
        ModelSpanExtractor,
        init_highlighter_params,
        modernbert_base_config,
        token_relevance_probs,
    )
    from verbatim_rag_tpu_torch.models.config import TrainingConfig
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.token_dataset import TokenDatasetEncoder
    from verbatim_rag_tpu_torch.training.trainer import Trainer, batch_to_device, train_step

    config = modernbert_base_config()
    tokenizer = HashTokenizer(vocab_size=config.vocab_size)
    examples = train_examples((TRAIN_STEPS + 1) * TRAIN_BATCH, seed, tokenizer)
    encoder = TokenDatasetEncoder(tokenizer, max_length=TRAIN_SEQ, doc_stride=128)
    batches = list(encoder.iter_batches(examples, TRAIN_BATCH))
    require(
        all(b.input_ids.shape == (TRAIN_BATCH, TRAIN_SEQ) for b in batches),
        f"train: batch shapes {[b.input_ids.shape for b in batches]}",
    )
    lengths = [int(n) for b in batches[:TRAIN_STEPS] for n in b.attention_mask.sum(1)]
    out_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(out_dir, ignore_errors=True)

    model = init_highlighter_params(config, seed=seed, device="cuda")
    tc = TrainingConfig(batch_size=TRAIN_BATCH, max_seq_length=TRAIN_SEQ, seed=seed)
    trainer = Trainer(model, config, tc, output_dir=str(out_dir), loss_fn=token_loss, tokenizer=tokenizer)
    last = config.num_layers - 1
    probes = ("classifier.kernel", "layers.0.attn.q.kernel", f"layers.{last}.mlp.wo.kernel", "final_ln.scale")
    before = {name: model.state_dict()[name].clone() for name in probes}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer.train(batches[:TRAIN_STEPS], num_epochs=1)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = config.num_layers * TRAIN_STEPS
    require(
        counts["flash_attention"] == layers and counts["flash_bwd_dq"] == layers
        and counts["flash_bwd_dkv"] == layers,
        f"train: launches {counts}, expected {layers} of each flash kernel",
    )
    require(trainer.oom_skips == 0, f"train: {trainer.oom_skips} batches skipped for OOM")
    require(len(trainer.steps) == TRAIN_STEPS, f"train: {len(trainer.steps)} steps")
    require(
        all(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]) for st in trainer.steps),
        f"train: a loss or gradient norm is not finite: {trainer.steps}",
    )
    changed = {name: not torch.equal(model.state_dict()[name], before[name]) for name in probes}
    require(all(changed.values()), f"train: parameters unchanged: {changed}")

    # Serving: the saved checkpoint on the card gives the trained model's
    # probabilities, and every span is a verbatim piece of its context.
    final = out_dir / "final"
    extractor = ModelSpanExtractor(model_path=str(final), device="cuda")
    require(all(p.is_cuda for p in extractor.model.parameters()), "train: served parameter not on cuda")
    ex = examples[0]
    plan = extractor._plan(ex.question, ex.context)
    row = plan["rows"][0]
    ids = torch.zeros((1, TRAIN_SEQ), dtype=torch.int32, device="cuda")
    mask = torch.zeros_like(ids)
    ids[0, : len(row)] = torch.tensor(row, dtype=torch.int32)
    mask[0, : len(row)] = 1
    with torch.no_grad():
        served = token_relevance_probs(extractor.model, ids, mask)
        trained = token_relevance_probs(model, ids, mask)
    probs_diff = float((served - trained).abs().max())
    require(probs_diff == 0.0, f"train: served probabilities differ from the trained model's by {probs_diff}")

    class Result:
        text = ex.context

    spans = extractor.extract_spans(ex.question, [Result()])[ex.context]
    require(all(span and span in ex.context for span in spans), "train: a served span is not verbatim")
    del extractor

    profile_batch = batch_to_device(batches[TRAIN_STEPS], "cuda")
    profile = device_profile(lambda: train_step(model, trainer.optimizer, profile_batch, token_loss), top=12)
    log("train profile", json.dumps(profile))
    step_s = [st["seconds"] for st in trainer.steps]
    median_s = float(np.median(step_s[1:]))
    result = dict(
        card=card, batch=TRAIN_BATCH, seq=TRAIN_SEQ, layers=config.num_layers,
        live_tokens_per_step=sum(lengths) / TRAIN_STEPS, losses=[st["loss"] for st in trainer.steps],
        grad_norms=[st["grad_norm"] for st in trainer.steps], step_s=step_s,
        step_s_median_2_to_4=median_s, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / median_s,
        live_tokens_per_s=sum(lengths) / TRAIN_STEPS / median_s, peak_memory_gb=peak_gb,
        train_s_with_checkpoint=train_s, served_spans=len(spans), served_probs_max_diff=probs_diff,
        idle_share=profile["idle_share"], launches=counts,
    )
    log("train", json.dumps(result))
    del trainer, model
    torch.cuda.empty_cache()
    return result, batches


#: The train_mesh phase: the train phase's weights and batches as
#: `Trainer(mesh=make_mesh(dp=2, tp=2, devices=[cuda] * 4))`, 3 steps; step 1
#: held to the single-device step. Limits (bf16 operands; the mesh sums
#: float32 partials over the tp shards in another order than one GEMM does):
MESH_TRAIN_DP, MESH_TRAIN_TP = 2, 2
MESH_TRAIN_STEPS = 3
MESH_LOSS_RTOL = 1e-4  # |loss − loss_single| / loss_single
MESH_GRAD_RTOL = 5e-3  # per tensor, before clipping: `tensor_errors`
MESH_PARAM_RTOL = 1e-4  # per tensor after the update: ‖p − p_single‖ / ‖p_single‖
#: The SP backward: one row at S=8192 (8,000 live) in SP_SHARDS shards on the
#: card, under grad, held to the single-device flash backward per tensor.
SP_TRAIN_SEQ = 8192
SP_TRAIN_LIVE = 8000
SP_GRAD_RTOL = 5e-2


def tensor_errors(got: dict, want: dict) -> dict:
    """Per tensor ‖got − want‖ / ‖want‖, the denominator floored at 1e-4 of
    the largest ‖want‖ (a tensor whose true gradient is near 0 has no scale
    of its own)."""
    floor = 1e-4 * max(float(w.float().norm()) for w in want.values())
    return {
        k: float((got[k].float() - want[k].float()).norm()) / max(float(want[k].float().norm()), floor)
        for k in want
    }


def step_grads(trainer, batch, loss_fn) -> tuple[float, dict]:
    """The loss and the gradient before clipping of every parameter the loss
    reaches (ModernBERT's layer 0 has no attention norm), of one batch
    through ``trainer``'s model (no update). On a mesh the gradients are
    synced as the train step syncs them (`trainer.sync_grads`: every copy
    holds the sum) and read unsharded on the mesh's first device."""
    from verbatim_rag_tpu_torch.parallel.mesh import ShardedModel
    from verbatim_rag_tpu_torch.training.trainer import sync_grads

    trainer.optimizer.zero_grad()
    loss, _ = loss_fn(trainer.model, trainer.batch_to_device(batch))
    loss.backward()
    sync_grads(trainer.model, trainer.optimizer)
    if isinstance(trainer.model, ShardedModel):
        grads = trainer.model.logical_grads(trainer.model.mesh.devices[0][0])
    else:
        grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters() if p.grad is not None}
    return float(loss.detach()), grads


def held_to_single(
    loss: float, grads: dict, ref_loss: float, ref_grads: dict,
    loss_rtol: float = MESH_LOSS_RTOL, grad_rtol: float = MESH_GRAD_RTOL,
    norm: float | None = None, ref_norm: float | None = None,
) -> dict:
    """Step 1's loss and gradients against a reference step's (by default
    the single-device step's, at the mesh limits), each as its ratio to its
    limit (`worst` above 1 fails); with ``norm`` and ``ref_norm`` also the
    global gradient norm that clipping divides by, at ``grad_rtol``."""
    loss_ratio = abs(loss - ref_loss) / abs(ref_loss) / loss_rtol
    errors = tensor_errors(grads, ref_grads)
    name = max(errors, key=errors.get)
    held = dict(
        loss=loss, loss_of_limit=loss_ratio, grad_worst_rel=errors[name], grad_worst_tensor=name,
        grad_of_limit=errors[name] / grad_rtol, worst=max(loss_ratio, errors[name] / grad_rtol),
    )
    if norm is not None:
        held.update(grad_norm=norm, ref_grad_norm=ref_norm, norm_of_limit=abs(norm - ref_norm) / ref_norm / grad_rtol)
        held["worst"] = max(held["worst"], held["norm_of_limit"])
    return held


def mesh_step_grads(trainer, batch, loss_fn) -> dict:
    """`step_grads` on a mesh trainer with its global norm, as keyword
    arguments of `held_to_single`."""
    loss, grads = step_grads(trainer, batch, loss_fn)
    return dict(loss=loss, grads=grads, norm=float(trainer.optimizer.global_norm()))


def resident_gb(sharded, optimizer) -> list[dict]:
    """Per mesh position: GB of its leaves, their gradients and their AdamW
    state (`ShardedModel.resident_bytes`)."""
    rows = sharded.resident_bytes(optimizer.adamw.state)
    keys = ("params", "grads", "optimizer_state")
    return [dict(r, **{f"{k}_gb": r[k] / 1e9 for k in keys}, total_gb=sum(r[k] for k in keys) / 1e9) for r in rows]


def shards_by_live_labels(batch):
    """The batch with its rows ordered by live labels, so that dp shard 0
    holds the fewest: shards whose live counts differ, where a mean of the
    shards' means differs most from the global mean."""
    import dataclasses

    import numpy as np

    order = np.argsort(batch.label_mask.sum(1), kind="stable")
    return dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[order] for f in dataclasses.fields(batch)})


def mesh_kernel_rows(lengths, gen) -> dict:
    """Kernels 1, 4 and 5 at this phase's shapes: the forward with lse and
    the FA2 backward at a shard's B=4, S=4096, H=6 (global layer, the dp
    shard's lengths), the ring step's partial at the SP shard's B=1,
    Sq=Sk=2048, H=12 (a fully live block), each against its plain version
    (forward and backward rows held as in the kernels phase), with ms,
    bound and library times."""
    import torch
    import torch.nn.functional as F

    from verbatim_rag_tpu_torch.ops import flash_attention as fa

    B, S, H, D = len(lengths), TRAIN_SEQ, TRAIN_HEADS // MESH_TRAIN_TP, 64
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q, k, v, g = (torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(4))
    live = torch.arange(S, device="cuda")[None, :] < lens[:, None]
    out, lse = fa.flash_attention_lse_cuda(q, k, v, lens, None)
    ref_out, ref_lse = fa.attention_lse_reference(q, k, v, lens, None)
    fwd_err, fwd_ratio = row_check((out.float() - ref_out).abs().amax(-1), ref_out.abs().amax(-1), live)
    lse_err = float(((lse - ref_lse).abs() - 1e-5 * ref_lse.abs()).max())
    require(fwd_ratio <= 1.0 and lse_err <= 1e-4, f"train_mesh: forward at H={H}: {fwd_ratio}, lse {lse_err}")
    del ref_out, ref_lse
    grads = fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g, None)
    refs = fa.flash_attention_bwd_reference(q, k, v, lens, out, lse, g, None)
    bwd_err, bwd_ratio = 0.0, 0.0
    for got, ref in zip(grads, refs):
        e, r = row_check((got.float() - ref.float()).abs().amax(-1), ref.float().abs().amax(-1), live, floor=1e-3)
        bwd_err, bwd_ratio = max(bwd_err, e), max(bwd_ratio, r)
    require(bwd_ratio <= 1.0, f"train_mesh: backward at H={H}: worst row at {bwd_ratio} of its limit")
    del grads, refs
    pairs = attention_pairs(lengths, S, None)
    q_rows, kv_rows = attention_rows(lengths, S)
    mask = sdpa_mask(lens, S, None)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    go = g.transpose(1, 2).contiguous()
    fwd_bound = bound((q_rows + 2 * kv_rows + B * S) * H * D * 2 + 4 * B + 4 * B * H * S, 4 * H * D * pairs, PEAK_BF16_FLOPS)
    bwd_bound = bound(
        (2 * q_rows + 2 * kv_rows + 3 * B * S) * H * D * 2 + 2 * H * q_rows * 4 + 4 * B, 10 * H * D * pairs, PEAK_BF16_FLOPS
    )
    shape = dict(batch=B, seq=S, heads=H, head_dim=D, window=None, lengths=lengths)
    rows = {
        "flash_attention_fwd": dict(
            shape, kernel="forward with lse", max_abs_err=fwd_err, worst_row_of_limit=fwd_ratio,
            ms=cuda_ms(lambda: fa.flash_attention_lse_cuda(q, k, v, lens, None), reps=10),
            plain_ms=cuda_ms(lambda: fa.attention_lse_reference(q, k, v, lens, None), reps=2),
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=5),
        ),
        "flash_attention_bwd": dict(
            shape, max_abs_err=bwd_err, worst_row_of_limit=bwd_ratio,
            ms=cuda_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g, None), reps=5),
            plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, lens, out, lse, g, None), reps=1),
            bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
            library_ms=cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), go, retain_graph=True), reps=3),
        ),
    }
    del q, k, v, g, out, lse, qt, kt, vt, o, go, mask
    torch.cuda.empty_cache()

    # The partial at the SP shard's block, under grad: the kernel's forward
    # and the plain backward (FlashAttentionPartial).
    Sp, Hp = SP_TRAIN_SEQ // SP_SHARDS, TRAIN_HEADS
    qp, kp, vp = (torch.randn(1, Sp, Hp, D, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    lens1 = torch.tensor([SP_TRAIN_LIVE], dtype=torch.int32, device="cuda")
    numer, m, l = fa.flash_attention_partial_cuda(qp, kp, vp, lens1, 0)
    ref_numer, ref_m, ref_l = fa.flash_attention_partial_reference(qp, kp, vp, lens1, 0)
    part_err, part_ratio = row_check(
        (numer - ref_numer).abs().amax(-1), ref_numer.abs().amax(-1), torch.ones_like(numer[..., 0], dtype=torch.bool)
    )
    require(part_ratio <= 1.0, f"train_mesh: partial at the SP block: worst row at {part_ratio} of its limit")
    leaves = [x.clone().requires_grad_(True) for x in (qp, kp, vp)]
    outs = fa.FlashAttentionPartial.apply(*leaves, lens1, 0)
    cot = [torch.randn(x.shape, generator=gen, device="cuda") for x in outs]

    def backward():
        torch.autograd.grad(outs, leaves, cot, retain_graph=True)

    live_k = torch.ones(Sp, dtype=torch.bool, device="cuda")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qp, kp, vp))
    library_ms, library_note = efficient_attention_ms(qt, kt, vt, live_k)
    p_bound = bound(3 * Sp * Hp * D * 2 + Sp * Hp * D * 4 + 2 * Hp * Sp * 4 + 4, 4 * Hp * D * Sp * Sp, PEAK_BF16_FLOPS)
    rows["flash_attention_partial"] = dict(
        batch=1, seq_q=Sp, seq_k=Sp, heads=Hp, head_dim=D, k_offset=0, max_abs_err=part_err,
        worst_row_of_limit=part_ratio,
        ms=cuda_ms(lambda: fa.flash_attention_partial_cuda(qp, kp, vp, lens1, 0), reps=10),
        plain_ms=cuda_ms(lambda: fa.flash_attention_partial_reference(qp, kp, vp, lens1, 0), reps=3),
        backward_plain_ms=cuda_ms(backward, reps=3),
        bound_ms=p_bound[0], bound_by=p_bound[1], library_ms=library_ms, library_note=library_note,
    )
    del qp, kp, vp, leaves, outs, cot, qt, kt, vt, numer, m, l, ref_numer, ref_m, ref_l
    torch.cuda.empty_cache()
    return rows


def contiguous_wi(config, tp: int, t: int):
    """The planted GEGLU fault: wi's output cut into contiguous tp blocks."""
    width = 2 * config.intermediate_size // tp
    return [slice(t * width, (t + 1) * width)]


def mean_of_shard_means(model, batch):
    """The planted loss fault: each dp shard's masked mean, then their mean."""
    from verbatim_rag_tpu_torch.training.model import token_loss

    means = [token_loss(shard, b)[0] for shard, b in zip(model.dp_shards(), batch)]
    return sum(m.to(means[0].device) for m in means) / len(means), {}


def skipping_a_copy(grad_sum):
    """The planted sync fault: ``grad_sum`` with one copy's gradient left
    out of the sum."""
    return lambda grads, device: grad_sum(grads[:-1] or grads, device)


def run_train_mesh(batches, seed: int, card: str, train: dict) -> dict:
    """The train phase's weights and batches on a dp=2 × tp=2 mesh of the
    card through `Trainer(mesh=...)` (each position's slices, replicated
    copies, gradients and AdamW state resident at the position), 3 steps,
    step 1 held to the single-device step (with four planted faults that
    must fail), every copy bit-equal after step 3; then the
    sequence-parallel forward under grad (`run_sp_backward`)."""
    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.models import init_highlighter_params, modernbert_base_config
    from verbatim_rag_tpu_torch.models.config import TrainingConfig
    from verbatim_rag_tpu_torch.parallel import make_mesh
    from verbatim_rag_tpu_torch.parallel import mesh as mesh_module
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.trainer import Trainer, train_step

    config = modernbert_base_config()
    tc = TrainingConfig(batch_size=TRAIN_BATCH, max_seq_length=TRAIN_SEQ, seed=seed)
    first = shards_by_live_labels(batches[0])
    per_shard = first.label_mask.reshape(MESH_TRAIN_DP, -1).sum(1).tolist()
    require(len(set(per_shard)) == MESH_TRAIN_DP, f"train_mesh: shards' live labels {per_shard} do not differ")
    model = init_highlighter_params(config, seed=seed, device="cuda")
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}

    single = Trainer(model, config, tc, loss_fn=token_loss)
    ref_loss, ref_grads = step_grads(single, first, token_loss)
    ref_norm = float(single.optimizer.global_norm())
    single.optimizer.step()
    ref_params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del single
    model.load_state_dict(initial)
    del initial
    torch.cuda.empty_cache()

    mesh = make_mesh(dp=MESH_TRAIN_DP, tp=MESH_TRAIN_TP, devices=[torch.device("cuda")] * 4)
    trainer = Trainer(model, config, tc, mesh=mesh, loss_fn=token_loss)
    sharded = trainer.model
    require(
        all(p.device.type == "cpu" for p in model.parameters())
        and all(leaf.is_cuda for leaf in sharded.parameters()),
        "train_mesh: the unsharded module holds device memory or a leaf is off the card",
    )
    placed = resident_gb(sharded, trainer.optimizer)
    faults = {}
    mesh_module.wi_columns, kept = contiguous_wi, mesh_module.wi_columns
    try:
        sharded.load_state_dict(model.state_dict())  # placed again with the faulty cut
        faults["wi cut contiguously"] = held_to_single(ref_loss=ref_loss, ref_grads=ref_grads, ref_norm=ref_norm,
                                                       **mesh_step_grads(trainer, first, token_loss))
    finally:
        mesh_module.wi_columns = kept
        sharded.load_state_dict(model.state_dict())
    faults["loss as the mean of the dp shards' means"] = held_to_single(
        ref_loss=ref_loss, ref_grads=ref_grads, ref_norm=ref_norm, **mesh_step_grads(trainer, first, mean_of_shard_means)
    )
    kept = mesh_module.grad_sum
    mesh_module.grad_sum = skipping_a_copy(kept)
    try:
        faults["sync skips a copy"] = held_to_single(
            ref_loss=ref_loss, ref_grads=ref_grads, ref_norm=ref_norm, **mesh_step_grads(trainer, first, token_loss)
        )
    finally:
        mesh_module.grad_sum = kept
    step = mesh_step_grads(trainer, first, token_loss)
    kept_norm, trainer.optimizer.norm_params = trainer.optimizer.norm_params, trainer.optimizer.params
    try:
        step["norm"] = float(trainer.optimizer.global_norm())
    finally:
        trainer.optimizer.norm_params = kept_norm
    faults["norm over every copy"] = held_to_single(ref_loss=ref_loss, ref_grads=ref_grads, ref_norm=ref_norm, **step)
    del step
    trainer.optimizer.zero_grad()
    for name, h in faults.items():
        require(h["worst"] > 1.0, f"train_mesh: planted fault '{name}' passes the check: {h}")
    log("train_mesh faults", json.dumps(faults))

    layers = config.num_layers * mesh.size
    launches, per_step, step_s = None, [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate([first, *batches[1:MESH_TRAIN_STEPS]]):
        reset_counts()
        t0 = time.perf_counter()
        if i == 0:  # step 1 by hand, to read its gradients before clipping
            step1 = mesh_step_grads(trainer, batch, token_loss)
            loss = step1["loss"]
            trainer.optimizer.step()
        else:
            loss = float(train_step(trainer.model, trainer.optimizer, trainer.batch_to_device(batch), token_loss)[0])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        counts = read_counts()
        require(
            counts["flash_attention"] == layers and counts["flash_bwd_dq"] == layers
            and counts["flash_bwd_dkv"] == layers and counts["flash_attention_partial"] == 0,
            f"train_mesh: step {i + 1} launches {counts}, expected {layers} of each flash kernel",
        )
        require(math.isfinite(loss), f"train_mesh: step {i + 1} loss {loss}")
        per_step.append(counts)
        launches = counts if launches is None else {k: launches[k] + counts[k] for k in counts}
        if i == 0:
            held = held_to_single(ref_loss=ref_loss, ref_grads=ref_grads, ref_norm=ref_norm, **step1)
            gathered = {k: v.to("cuda") for k, v in sharded.state_dict().items()}
            param_errors = tensor_errors(gathered, ref_params)
            worst_param = max(param_errors, key=param_errors.get)
            held.update(
                param_worst_rel=param_errors[worst_param], param_worst_tensor=worst_param,
                param_of_limit=param_errors[worst_param] / MESH_PARAM_RTOL,
            )
            held["worst"] = max(held["worst"], held["param_of_limit"])
            require(held["worst"] <= 1.0, f"train_mesh: step 1 differs from the single-device step: {held}")
            log("train_mesh held", json.dumps(held))
            del step1, ref_grads, ref_params, gathered
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    unequal = sharded.unequal_copies()
    require(not unequal, f"train_mesh: copies differ after step {MESH_TRAIN_STEPS}: {unequal[:8]}")
    resident = resident_gb(sharded, trainer.optimizer)
    log("train_mesh resident", json.dumps(resident))
    profile_batch = trainer.batch_to_device(batches[MESH_TRAIN_STEPS])
    profile = device_profile(lambda: train_step(trainer.model, trainer.optimizer, profile_batch, token_loss), top=12)
    log("train_mesh profile", json.dumps(profile))
    sharded.gather().to("cuda")  # the trained tree, for the SP backward
    del trainer, sharded, profile_batch
    torch.cuda.empty_cache()

    kernels = mesh_kernel_rows([int(n) for n in first.attention_mask[: TRAIN_BATCH // MESH_TRAIN_DP].sum(1)], torch.Generator(device="cuda").manual_seed(seed))
    sp = run_sp_backward(model, seed)
    launches = {k: launches[k] + sp["launches"][k] for k in launches}
    kernels["flash_attention_fwd"]["launches"] = launches["flash_attention"]
    kernels["flash_attention_bwd"]["launches"] = launches["flash_bwd_dq"] + launches["flash_bwd_dkv"]
    kernels["flash_attention_partial"]["launches"] = launches["flash_attention_partial"]
    median_s = float(np.median(step_s[1:]))
    result = dict(
        card=card, dp=MESH_TRAIN_DP, tp=MESH_TRAIN_TP, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        layers=config.num_layers, live_labels_per_dp_shard=per_shard, step_s=step_s,
        step_s_median_2_to_3=median_s, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / median_s,
        peak_memory_gb=peak_gb, idle_share=profile["idle_share"],
        copies_bit_equal_after_step=MESH_TRAIN_STEPS, resident_per_position=resident,
        resident_at_placement_gb=[r["total_gb"] for r in placed],
        single_device=dict(
            step_s_median_2_to_4=train["step_s_median_2_to_4"], tokens_per_s=train["tokens_per_s"],
            peak_memory_gb=train["peak_memory_gb"], idle_share=train["idle_share"],
        ),
        limits=dict(loss_rtol=MESH_LOSS_RTOL, grad_rtol=MESH_GRAD_RTOL, param_rtol=MESH_PARAM_RTOL),
        held=held, worst_of_limit=held["worst"],
        planted_faults_worst_of_limit={n: h["worst"] for n, h in faults.items()},
        launches_per_step=per_step, sp_backward=sp, kernels=kernels, launches=launches,
    )
    log("train_mesh", json.dumps(result))
    del model
    torch.cuda.empty_cache()
    return result


def run_sp_backward(
    model, seed: int, seq: int = SP_TRAIN_SEQ, live_tokens: int = SP_TRAIN_LIVE, label: str = "train_mesh sp"
) -> dict:
    """`encoder_forward_sp` under grad: one row at ``seq`` (``live_tokens``
    live; S=8192 and 8,000 by default) in SP_SHARDS shards on the card (ring
    attention, the partial kernel, on the global layers; halo attention on
    the local ones), a fixed random projection of the hidden states as the
    loss; every parameter's gradient (the input embedding's among them) held
    to the single-device flash backward on the same row per tensor within
    SP_GRAD_RTOL."""
    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.models import encoder_forward_sp
    from verbatim_rag_tpu_torch.ops.ring_attention import shard_sequence
    from verbatim_rag_tpu_torch.parallel import make_mesh

    config = model.config
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(5, config.vocab_size, size=(1, seq)).astype(np.int32))
    mask = (torch.arange(seq)[None, :] < live_tokens).to(torch.int32)
    ids = ids * mask
    gen = torch.Generator(device="cuda").manual_seed(seed)
    probe = torch.randn(1, seq, config.hidden_size, generator=gen, device="cuda")
    live = mask.cuda().float()[..., None]
    mesh = make_mesh(dp=1, tp=SP_SHARDS, devices=[torch.device("cuda")] * SP_SHARDS)

    def grads_of(hidden) -> dict:
        ((hidden * probe) * live).sum().backward()
        out = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return out

    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    shards = encoder_forward_sp(model, shard_sequence(ids, mesh), shard_sequence(mask, mesh), mesh)
    counts = read_counts()
    sp_grads = grads_of(torch.cat(shards, dim=1))
    torch.cuda.synchronize()
    sp_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del shards
    global_layers = sum(config.is_global_layer(i) for i in range(config.num_layers))
    expected = global_layers * SP_SHARDS**2
    require(
        counts["flash_attention_partial"] == expected and counts["flash_attention"] == 0,
        f"{label}: launches {counts}, expected {expected} partial and no forward launch",
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_grads = grads_of(model(ids.cuda(), mask.cuda()))
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    require(set(sp_grads) == set(ref_grads), f"{label}: the SP backward reached other parameters")
    errors = tensor_errors(sp_grads, ref_grads)
    worst = max(errors, key=errors.get)
    require(errors[worst] <= SP_GRAD_RTOL, f"{label}: gradient of {worst} differs by {errors[worst]}")
    result = dict(
        seq=seq, live=live_tokens, shards=SP_SHARDS, seconds=sp_s, peak_memory_gb=peak_gb,
        single_device_seconds=single_s, grad_rtol=SP_GRAD_RTOL, grad_worst_rel=errors[worst],
        grad_worst_tensor=worst, grad_of_limit=errors[worst] / SP_GRAD_RTOL,
        input_embedding_grad_rel=errors["embeddings.word"], launches=counts,
    )
    log(label, json.dumps(result))
    del sp_grads, ref_grads
    torch.cuda.empty_cache()
    return result


#: The train_d32 phase: the token highlighter at full MiniLM width with flash
#: attention on (`minilm_config(use_flash_attention=True)`: hidden 384, 6
#: layers, 12 heads of 32, intermediate 1536, absolute positions, post-LN,
#: bf16; every layer global), 4 `Trainer` steps at batch 8 and S=512 (the
#: position table's end) on examples of 300-480 context tokens, then its
#: checkpoint served sequence-parallel and the model trained
#: sequence-parallel (`run_sp_backward` at S=512, 500 live tokens).
D32_STEPS = 4
D32_BATCH = 8
D32_SEQ = 512
D32_TOKENS = (300, 480)
D32_SP_ROWS = 4
D32_SP_LIVE = 500
#: Step 1's loss and gradients against the same step with the plain FA2
#: backward (same weights, batch and forward kernel, so the loss is the same
#: number): per tensor ‖g − g_plain‖ / ‖g_plain‖ (`tensor_errors`) within the
#: flash checks' bf16 limit (the kernels round P and dS to bf16 for the
#: second products, the plain version keeps them float32).
D32_LOSS_RTOL = 1e-6
D32_GRAD_RTOL = FLASH_RTOL


#: The tp_processes phase: gloo ranks on the one card, one tp position
#: each, `token_loss` at batch 2 × 1024, 2 steps.
TP_PROC_RANKS, TP_PROC_BATCH, TP_PROC_SEQ, TP_PROC_STEPS = 2, 2, 1024, 2


def tp_batches(seed: int, tokenizer) -> list:
    """`TP_PROC_STEPS` token batches of `TP_PROC_BATCH` × `TP_PROC_SEQ`
    (`train_examples` of 600-950 context tokens, one window each)."""
    from verbatim_rag_tpu_torch.training.token_dataset import TokenDatasetEncoder

    examples = train_examples(TP_PROC_STEPS * TP_PROC_BATCH, seed, tokenizer, context_tokens=(600, 950))
    encoder = TokenDatasetEncoder(tokenizer, max_length=TP_PROC_SEQ, doc_stride=128)
    batches = list(encoder.iter_batches(examples, TP_PROC_BATCH))[:TP_PROC_STEPS]
    require(
        len(batches) == TP_PROC_STEPS and all(b.input_ids.shape == (TP_PROC_BATCH, TP_PROC_SEQ) for b in batches),
        f"tp_processes: batch shapes {[b.input_ids.shape for b in batches]}",
    )
    return batches


def tp_process_worker(rank: int, port: int, seed: int, batches, out_dir: str) -> None:
    """One rank of the tp_processes phase: a gloo group, its position of a
    dp = 1 × tp = 2 global mesh on the card, the train phase's weights from
    the seed, `TP_PROC_STEPS` steps; rank 0 writes the tree gathered after
    step 1."""
    import torch

    sys.path.insert(0, str(ROOT))
    from verbatim_rag_tpu_torch.models import init_highlighter_params, modernbert_base_config
    from verbatim_rag_tpu_torch.models.config import TrainingConfig
    from verbatim_rag_tpu_torch.parallel import distributed, exchange
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.trainer import Trainer, train_step

    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=TP_PROC_RANKS, rank=rank
    )
    config = modernbert_base_config()
    mesh = distributed.global_mesh(dp=1, tp=TP_PROC_RANKS, devices=[torch.device("cuda")])
    require(mesh.axis_group("tp", 0) is not None, "tp_processes: the tp row does not span ranks")
    tc = TrainingConfig(batch_size=TP_PROC_BATCH, max_seq_length=TP_PROC_SEQ, seed=seed)
    trainer = Trainer(init_highlighter_params(config, seed=seed, device="cuda"), config, tc, mesh=mesh,
                      loss_fn=token_loss)
    steps = []
    for i, batch in enumerate(batches):
        reset_counts()
        exchange.handoffs, exchange.handoff_s = 0, 0.0
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        loss = float(train_step(trainer.model, trainer.optimizer, trainer.batch_to_device(batch), token_loss)[0])
        torch.cuda.synchronize()
        steps.append(dict(seconds=time.perf_counter() - t0, loss=loss, grad_norm=trainer.optimizer.grad_norm,
                          launches=read_counts(), handoffs=exchange.handoffs, handoff_ms=exchange.handoff_s * 1e3))
        if i == 0:
            state = trainer.model.state_dict()  # a collective: the tree on rank 0
            if rank == 0:
                torch.save({k: v.detach().clone() for k, v in state.items()}, os.path.join(out_dir, "after1.pt"))
    resident = trainer.model.resident_bytes(trainer.optimizer.adamw.state)
    torch.save(dict(rank=rank, steps=steps, resident_gb=sum(r[k] for r in resident for k in ("params", "grads",
                    "optimizer_state")) / 1e9), os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def run_tp_processes(seed: int, card: str) -> dict:
    """Phase 7d: the mesh train step with its tp row across
    `TP_PROC_RANKS` processes on the card, step 1 held to a one-process
    dp = 1 × tp = 2 mesh and to the single-device step."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from verbatim_rag_tpu_torch.models import HashTokenizer, init_highlighter_params, modernbert_base_config
    from verbatim_rag_tpu_torch.models.config import TrainingConfig
    from verbatim_rag_tpu_torch.parallel import make_mesh
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.trainer import Trainer, train_step

    t_phase = time.perf_counter()
    config = modernbert_base_config()
    batches = tp_batches(seed, HashTokenizer(vocab_size=config.vocab_size))
    tc = TrainingConfig(batch_size=TP_PROC_BATCH, max_seq_length=TP_PROC_SEQ, seed=seed)
    refs = {}
    for name, mesh in (("single_device", None),
                       ("one_process_mesh", make_mesh(dp=1, tp=TP_PROC_RANKS, devices=[torch.device("cuda")] * 2))):
        trainer = Trainer(init_highlighter_params(config, seed=seed, device="cuda"), config, tc, mesh=mesh,
                          loss_fn=token_loss)
        loss = float(train_step(trainer.model, trainer.optimizer, trainer.batch_to_device(batches[0]), token_loss)[0])
        refs[name] = dict(loss=loss, grad_norm=trainer.optimizer.grad_norm,
                          params={k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()})
        del trainer
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
        t0 = time.perf_counter()
        mp.spawn(tp_process_worker, args=(free_port(), seed, batches, out_dir), nprocs=TP_PROC_RANKS, join=True)
        group_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(TP_PROC_RANKS)]
        after1 = torch.load(os.path.join(out_dir, "after1.pt"))
    layers = config.num_layers
    for r in ranks:
        for i, step in enumerate(r["steps"]):
            c = step["launches"]
            require(
                (c["flash_attention"], c["flash_bwd_dq"], c["flash_bwd_dkv"], c["flash_attention_partial"])
                == (layers, layers, layers, 0),
                f"tp_processes: rank {r['rank']} step {i + 1} launches {c}, expected {layers} of each flash kernel",
            )
        require(
            [(s["loss"], s["grad_norm"]) for s in r["steps"]] == [(s["loss"], s["grad_norm"]) for s in ranks[0]["steps"]],
            "tp_processes: the ranks report different losses or norms",
        )
    step1 = ranks[0]["steps"][0]
    held = {}
    for name, ref in refs.items():
        errors = tensor_errors(after1, ref["params"])
        worst = max(errors, key=errors.get)
        h = dict(
            loss=step1["loss"], ref_loss=ref["loss"], loss_bit_equal=step1["loss"] == ref["loss"],
            loss_of_limit=abs(step1["loss"] - ref["loss"]) / abs(ref["loss"]) / MESH_LOSS_RTOL,
            grad_norm=step1["grad_norm"], ref_grad_norm=ref["grad_norm"],
            norm_of_limit=abs(step1["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"] / MESH_GRAD_RTOL,
            param_worst_rel=errors[worst], param_worst_tensor=worst, param_of_limit=errors[worst] / MESH_PARAM_RTOL,
        )
        h["worst"] = max(h["loss_of_limit"], h["norm_of_limit"], h["param_of_limit"])
        require(h["worst"] <= 1.0, f"tp_processes: step 1 differs from the {name} step: {h}")
        held[name] = h
    launches = {k: sum(s["launches"][k] for r in ranks for s in r["steps"]) for k in kernel_counters()}
    result = dict(
        card=card, group="gloo, 2 ranks on one card: every hand-off staged through host memory",
        dp=1, tp=TP_PROC_RANKS, batch=TP_PROC_BATCH, seq=TP_PROC_SEQ, steps=TP_PROC_STEPS, layers=layers,
        heads_a_rank=config.num_heads // TP_PROC_RANKS, held=held,
        limits=dict(loss_rtol=MESH_LOSS_RTOL, grad_rtol=MESH_GRAD_RTOL, param_rtol=MESH_PARAM_RTOL),
        losses=[s["loss"] for s in ranks[0]["steps"]], equal_on_every_rank=True,
        step_s_by_rank=[[s["seconds"] for s in r["steps"]] for r in ranks],
        handoffs_a_step_by_rank=[[s["handoffs"] for s in r["steps"]] for r in ranks],
        handoff_ms_a_step_by_rank=[[s["handoff_ms"] for s in r["steps"]] for r in ranks],
        resident_gb_by_rank=[r["resident_gb"] for r in ranks], group_s_with_start=group_s,
        launches_by_rank={k: [sum(s["launches"][k] for s in r["steps"]) for r in ranks]
                          for k in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")},
        launches=launches, phase_s=time.perf_counter() - t_phase,
    )
    log("tp_processes", json.dumps(result))
    return result


def run_train_d32(seed: int, card: str) -> dict:
    """The MiniLM-width highlighter with flash on: trained through `Trainer`
    (the flash forward with lse and the FA2 backward at D = 32), step 1
    held to the plain backward with a planted fault; its checkpoint served
    by `ModelSpanExtractor(model_path=..., sp_mesh=...)` (every layer ring
    attention: the partial kernel at D = 32) and held to the single-device
    extractor; then `run_sp_backward` at S=512."""
    import shutil

    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.models import (
        HashTokenizer,
        ModelSpanExtractor,
        init_highlighter_params,
        minilm_config,
        select_spans_from_token_probs,
    )
    from verbatim_rag_tpu_torch.models.config import TrainingConfig
    from verbatim_rag_tpu_torch.models.tokenizer import bucket_length
    from verbatim_rag_tpu_torch.ops import flash_attention as fa
    from verbatim_rag_tpu_torch.parallel import make_mesh
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.token_dataset import TokenDatasetEncoder
    from verbatim_rag_tpu_torch.training.trainer import Trainer, train_step

    config = minilm_config(use_flash_attention=True)
    require(
        config.head_dim == 32 and config.position_embedding_type == "absolute" and config.use_flash_attention,
        f"train_d32: config {config}",
    )
    tokenizer = HashTokenizer(vocab_size=config.vocab_size)
    examples = train_examples((D32_STEPS + 1) * D32_BATCH, seed, tokenizer, D32_TOKENS)
    encoder = TokenDatasetEncoder(tokenizer, max_length=D32_SEQ, doc_stride=128)
    batches = list(encoder.iter_batches(examples, D32_BATCH))
    require(
        len(batches) >= D32_STEPS + 1 and all(b.input_ids.shape == (D32_BATCH, D32_SEQ) for b in batches),
        f"train_d32: batch shapes {[b.input_ids.shape for b in batches]}",
    )
    lengths = [int(n) for b in batches[:D32_STEPS] for n in b.attention_mask.sum(1)]
    require(len(set(lengths)) > 1, f"train_d32: rows not ragged: {lengths}")
    out_dir = ROOT / "build" / "chip_smoke_train_d32"
    shutil.rmtree(out_dir, ignore_errors=True)

    model = init_highlighter_params(config, seed=seed, device="cuda")
    tc = TrainingConfig(batch_size=D32_BATCH, max_seq_length=D32_SEQ, seed=seed)
    trainer = Trainer(model, config, tc, output_dir=str(out_dir), loss_fn=token_loss, tokenizer=tokenizer)

    # Step 1 against the same step with the plain backward, and with a
    # planted fault (both kernels with delta replaced by 0) that must fail.
    def delta_zero_bwd(q, k, v, lengths_, out, lse, g, window=None):
        return fa._launch_bwd(q, k, v, lengths_, lse, torch.zeros_like(lse), g.to(q.dtype).contiguous(), window)

    def grads_with(bwd):
        kept, fa.flash_attention_bwd_cuda = fa.flash_attention_bwd_cuda, bwd
        try:
            return step_grads(trainer, batches[0], token_loss)
        finally:
            fa.flash_attention_bwd_cuda = kept

    reset_counts()
    loss, grads = step_grads(trainer, batches[0], token_loss)
    step1_counts = read_counts()
    require(
        step1_counts["flash_bwd_dq_d32"] == config.num_layers and step1_counts["flash_bwd_dkv_d32"] == config.num_layers,
        f"train_d32: step 1 launches {step1_counts}",
    )
    ref_loss, ref_grads = grads_with(fa.flash_attention_bwd_reference)
    limits = dict(loss_rtol=D32_LOSS_RTOL, grad_rtol=D32_GRAD_RTOL)
    held = held_to_single(loss, grads, ref_loss, ref_grads, **limits)
    require(held["worst"] <= 1.0, f"train_d32: step 1 differs from the plain backward's: {held}")
    fault = held_to_single(*grads_with(delta_zero_bwd), ref_loss, ref_grads, **limits)
    require(fault["worst"] > 1.0, f"train_d32: planted fault 'delta replaced by 0' passes the check: {fault}")
    held["planted_fault_worst_of_limit"] = fault["worst"]
    log("train_d32 held", json.dumps(held))
    trainer.optimizer.zero_grad()
    del grads, ref_grads

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer.train(batches[:D32_STEPS], num_epochs=1)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = config.num_layers * D32_STEPS
    require(
        all(train_counts[k] == layers for k in (
            "flash_attention", "flash_attention_d32", "flash_bwd_dq", "flash_bwd_dq_d32",
            "flash_bwd_dkv", "flash_bwd_dkv_d32",
        )) and train_counts["flash_attention_partial"] == 0,
        f"train_d32: launches {train_counts}, expected {layers} of each flash kernel at D = 32",
    )
    require(trainer.oom_skips == 0 and len(trainer.steps) == D32_STEPS, f"train_d32: steps {trainer.steps}")
    require(
        all(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]) for st in trainer.steps),
        f"train_d32: a loss or gradient norm is not finite: {trainer.steps}",
    )
    step_s = [st["seconds"] for st in trainer.steps]
    losses = [st["loss"] for st in trainer.steps]
    grad_norms = [st["grad_norm"] for st in trainer.steps]
    log("train_d32 steps", json.dumps(dict(step_s=step_s, peak_memory_gb=peak_gb, launches=train_counts)))
    profile_batch = trainer.batch_to_device(batches[D32_STEPS])
    profile = device_profile(lambda: train_step(model, trainer.optimizer, profile_batch, token_loss), top=8)
    log("train_d32 profile", json.dumps(profile))
    del trainer, profile_batch

    # Serving sequence-parallel from the checkpoint: one pass of D32_SP_ROWS
    # contexts at S=512 in SP_SHARDS shards, every layer ring attention.
    final = out_dir / "final"
    mesh = make_mesh(dp=1, tp=SP_SHARDS, devices=[torch.device("cuda")] * SP_SHARDS)
    sp = ModelSpanExtractor(model_path=str(final), sp_mesh=mesh, device="cuda")
    single = ModelSpanExtractor(model_path=str(final), max_length=D32_SEQ, device="cuda")
    question = examples[0].question
    contexts = [ex.context for ex in examples[:D32_SP_ROWS]]
    plans = [sp._plan(question, c) for c in contexts]
    rows = [plan["rows"][0] for plan in plans]
    require(
        all(len(plan["rows"]) == 1 for plan in plans) and bucket_length(max(len(r) for r in rows)) == D32_SEQ,
        f"train_d32: SP rows {[len(r) for r in rows]} do not make one pass at S={D32_SEQ}",
    )
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    span_lists = sp.process_batch(question, contexts)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_counts = read_counts()
    expected = config.num_layers * SP_SHARDS**2
    require(
        serve_counts["flash_attention_partial"] == expected and serve_counts["flash_attention_partial_d32"] == expected
        and serve_counts["flash_attention"] == 0,
        f"train_d32 sp: launches {serve_counts}, expected {expected} partial at D = 32 and no forward launch",
    )
    ids = np.full((len(rows), D32_SEQ), sp.tokenizer.pad_id, np.int32)
    mask = np.zeros((len(rows), D32_SEQ), np.int32)
    for i, row in enumerate(rows):
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    sp_probs = sp._forward_probs(ids, mask)
    single_probs = single._forward_probs(ids, mask)
    probs_diff = float(np.abs(sp_probs - single_probs)[mask.astype(bool)].max())
    require(probs_diff <= SP_PROBS_ATOL, f"train_d32 sp: probabilities differ by {probs_diff}")
    near, equal = 0, 0
    for i, (plan, spans) in enumerate(zip(plans, span_lists)):
        starts = {a for a, _ in plan["offsets"]}
        ends = {b for _, b in plan["offsets"]}
        require(all(a in starts and b in ends for a, b in spans), "train_d32 sp: a span is off the token boundaries")
        start, length, tok_offset = plan["layout"][0]
        agg = single_probs[i, tok_offset : tok_offset + length]
        single_spans = select_spans_from_token_probs(
            agg, plan["offsets"], threshold=sp.threshold, min_span_chars=sp.min_span_chars,
            merge_gap_chars=sp.merge_gap_chars,
        )
        row_near = int((np.abs(agg - sp.threshold) <= SP_PROBS_ATOL).sum())
        require(
            spans == single_spans or row_near > 0,
            "train_d32 sp: spans differ from the single-device extractor's with no probability near the threshold",
        )
        near += row_near
        equal += spans == single_spans
    sp_serve = dict(
        rows=len(rows), seq=D32_SEQ, shards=SP_SHARDS, row_tokens=[len(r) for r in rows], seconds=serve_s,
        spans=sum(len(x) for x in span_lists), rows_with_spans_equal_single_device=equal,
        tokens_within_tol_of_threshold=near, probs_max_abs_diff_vs_single_device=probs_diff,
        launches=serve_counts,
    )
    log("train_d32 sp serve", json.dumps(sp_serve))
    del sp, single

    sp_train = run_sp_backward(model, seed, seq=D32_SEQ, live_tokens=D32_SP_LIVE, label="train_d32 sp backward")
    launches = {k: train_counts[k] + serve_counts[k] + sp_train["launches"][k] for k in train_counts}
    median_s = float(np.median(step_s[1:]))
    result = dict(
        card=card, config="minilm_config(use_flash_attention=True)", hidden=config.hidden_size,
        layers=config.num_layers, heads=config.num_heads, head_dim=config.head_dim, batch=D32_BATCH,
        seq=D32_SEQ, live_tokens_per_step=sum(lengths) / D32_STEPS, losses=losses, grad_norms=grad_norms,
        step_s=step_s,
        step_s_median_2_to_4=median_s, tokens_per_s=D32_BATCH * D32_SEQ / median_s,
        peak_memory_gb=peak_gb, train_s_with_checkpoint=train_s, idle_share=profile["idle_share"],
        limits=limits, held=held, worst_of_limit=held["worst"], sp_serve=sp_serve, sp_backward=sp_train,
        launches=launches,
    )
    log("train_d32", json.dumps(result))
    del model
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return result


CKPT_QUESTION = "How efficient are solar panels?"
CKPT_SENTENCE_TEXTS = 64
CKPT_RERANK_K = 50
#: The flash checks' bf16 limit (`FLASH_RTOL`), on probabilities and on the
#: cross-encoder's pooled state (as a share of each row's largest |value|).
CKPT_PROBS_ATOL = FLASH_RTOL
#: The largest share of a call's passage pairs that the flash scores may
#: order otherwise than the plain scores: about twice the worst of the 64
#: calls measured on an H100 (0.055, median 0.033; random weights score 50
#: passages within a few bf16 roundings of each other). Hiding the passages
#: from the kernel gives 1.0.
CKPT_DISCORDANT_MAX = 0.1


def predicted_forwards(extractor, pairs) -> int:
    """Forwards that `ModelSpanExtractor._process_pairs` makes for ``pairs``:
    rows padded to a power of two (then multiples of 512), scored in slices of
    at most 512 rows and `SLICE_TOKENS` tokens."""
    from verbatim_rag_tpu_torch.models.highlighter import SLICE_TOKENS
    from verbatim_rag_tpu_torch.models.tokenizer import bucket_length

    rows = [r for q, c in pairs for r in (extractor._plan(q, c) or {"rows": []})["rows"]]
    if not rows:
        return 0
    seq = min(bucket_length(max(len(r) for r in rows)), extractor.max_length)
    padded = next((b for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512) if b >= len(rows)),
                  -(-len(rows) // 512) * 512)
    step = max(1, min(512, SLICE_TOKENS // seq))
    return -(-padded // step)


def rows_ratio(got, expected) -> float:
    """Worst row of [B, H] vectors: max|got − expected| over H divided by
    FLASH_RTOL·max|expected| of the row plus half a bf16 ulp of it
    (`row_check`'s limit)."""
    import torch

    got, expected = torch.as_tensor(got).float(), torch.as_tensor(expected).float()
    return row_check((got - expected).abs().amax(dim=-1), expected.abs().amax(dim=-1),
                     torch.ones(len(got), dtype=torch.bool))[1]


def discordant_share(a, b) -> float:
    """Share of the pairs (i, j) that ``a`` orders otherwise than ``b`` (a
    tie in one and not in the other counts)."""
    import numpy as np

    da, db = np.sign(a[:, None] - a[None, :]), np.sign(b[:, None] - b[None, :])
    upper = np.triu(np.ones(da.shape, bool), 1)
    return float((da != db)[upper].mean())


def flash_on_layers(cross, question: str, texts) -> dict:
    """The flash forward on the q/k/v each of the cross-encoder's layers hands
    it for one scoring call, held to plain attention row by row
    (`row_check`), and the planted faults of `flash_faults` (on the first
    layer, the shortest row's mask dropped) failing the same check."""
    import torch

    from verbatim_rag_tpu_torch.models import encoder as encoder_module
    from verbatim_rag_tpu_torch.ops import flash_attention as fa

    captured = []

    def capture(q, k, v, lengths, window=None):
        captured.append((q, k, v, lengths, window))
        return fa.flash_attention(q, k, v, lengths, window)

    encoder_module.flash_attention = capture
    try:
        cross.pooled(question, texts)
    finally:
        encoder_module.flash_attention = fa.flash_attention
    require(len(captured) == cross.config.num_layers, f"checkpoints: {len(captured)} flash calls captured")
    worst, faults = 0.0, {}
    for layer, (q, k, v, lens, window) in enumerate(captured):
        seq = q.shape[1]
        live = torch.arange(seq, device=q.device)[None, :, None] < lens[:, None, None]
        live = live.expand(q.shape[:3])
        outs = {"kernel": fa.flash_attention_cuda(q, k, v, lens, window)}
        if layer == 0:
            require(bool((lens > 64).any()) and int(lens.min()) < seq,
                    f"checkpoints: lengths {lens.tolist()} leave a planted fault empty")
            for name, fault_lens in flash_faults(lens, seq, int(lens.argmin())).items():
                outs[name] = fa.flash_attention_cuda(q, k, v, fault_lens, window)
        ref = fa.attention_reference(q, k, v, lens, window)
        scale = ref.abs().amax(dim=-1)
        for name, out in outs.items():
            ratio = row_check((out.float() - ref).abs().amax(dim=-1), scale, live)[1]
            if name == "kernel":
                worst = max(worst, ratio)
            else:
                faults[name] = ratio
    require(worst <= 1.0, f"checkpoints: the D = 32 flash forward at {worst} of its limit on the layers' q/k/v")
    for name, ratio in faults.items():
        require(ratio > 1.0, f"checkpoints: {name} passes the check ({ratio} of the limit)")
    return dict(shape=list(captured[0][0].shape), layers=len(captured), worst_row_of_limit=worst,
                planted_faults_of_limit=faults)


def run_checkpoints(index, questions, final: Path, seed: int, card: str) -> dict:
    """Checkpoints in and out, the sentence extractor and the rerank stage
    (phase 7b). The main path runs between the reset and the read of the
    launch counts; the comparisons with the native checkpoint and with plain
    attention come after."""
    import asyncio
    import dataclasses
    import logging

    import numpy as np
    import torch

    from verbatim_rag_tpu_torch.engine import VerbatimIndex
    from verbatim_rag_tpu_torch.models import (
        JaxCrossEncoder,
        ModelSpanExtractor,
        minilm_config,
        token_relevance_probs,
    )
    from verbatim_rag_tpu_torch.models import encoder as encoder_module
    from verbatim_rag_tpu_torch.models.hf_convert import load_span_extractor
    from verbatim_rag_tpu_torch.models.sentence_extractor import SentenceModelExtractor
    from verbatim_rag_tpu_torch.models.tokenizer import HashTokenizer, train_wordpiece_tokenizer
    from verbatim_rag_tpu_torch.ops import flash_attention as fa
    from verbatim_rag_tpu_torch.rag import JaxReranker, StreamingRAG, VerbatimRAG
    from verbatim_rag_tpu_torch.training.model import init_qa_model_params
    from verbatim_rag_tpu_torch.training.trainer import Trainer
    from verbatim_rag_tpu_torch.utils.profiling import synchronize
    from verbatim_rag_tpu_torch.utils.upload_to_hub import jax_checkpoint_to_hf_dir

    class Result:
        def __init__(self, text):
            self.text = text

    t_phase = time.perf_counter()
    device = "cuda"
    work = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(work, ignore_errors=True)
    # The serve corpus repeats each file SERVE_REPEAT times: the rerank stage
    # runs over an index of one copy through the serve index's providers,
    # with k = rerank_k, so each call reranks distinct passages.
    t0 = time.perf_counter()
    docs = serve_corpus()
    rerank_index = VerbatimIndex(dense_provider=index.dense_provider, sparse_provider=index.sparse_provider)
    rerank_index.add_documents_bulk(docs[: len(docs) // SERVE_REPEAT])
    rerank_index_s = time.perf_counter() - t0
    n_chunks = rerank_index.inspect()["num_chunks"]
    distinct = list(dict.fromkeys(c.text for c in rerank_index.get_all_chunks(limit=n_chunks)))
    require(len(distinct) >= CKPT_RERANK_K, f"checkpoints: {len(distinct)} distinct chunks")
    texts = distinct[:CKPT_SENTENCE_TEXTS]

    # The train phase's checkpoint staged for the Hub, then its HF files alone
    # (config.json, model.safetensors, a tokenizer.json trained here) through
    # the HF branch of the loaders.
    t0 = time.perf_counter()
    jax_checkpoint_to_hf_dir(str(final), str(work / "staged"))
    stage_s = time.perf_counter() - t0
    hf_dir = work / "hf"
    hf_dir.mkdir(parents=True)
    for name in ("config.json", "model.safetensors"):
        shutil.copy(work / "staged" / name, hf_dir / name)
    train_wordpiece_tokenizer(hf_dir / "tokenizer.json", texts)
    t0 = time.perf_counter()
    served = load_span_extractor(str(hf_dir), device=device)
    load_s = time.perf_counter() - t0
    require(type(served).__name__ == "ModelSpanExtractor", f"checkpoints: HF dir served by {type(served)}")
    require(type(served.tokenizer).__name__ == "HFTokenizer", "checkpoints: the HF tokenizer was not loaded")
    config = served.config
    # A sentence-head checkpoint at the same width.
    sentence_model = init_qa_model_params(config, seed=seed, device=device)
    Trainer(sentence_model, config, tokenizer=HashTokenizer(config.vocab_size)).save_checkpoint(
        str(work / "sentence"))
    del sentence_model
    sentence = load_span_extractor(str(work / "sentence"), device=device)
    require(isinstance(sentence, SentenceModelExtractor), f"checkpoints: sentence dir served by {type(sentence)}")
    # The rerank stage: a MiniLM-width cross-encoder with flash on (D = 32),
    # each scoring call recorded.
    ce_config = minilm_config(use_flash_attention=True)
    cross = JaxCrossEncoder(config=ce_config, seed=seed, device=device)
    calls = []
    flash_score = cross.score

    def recorded_score(question, passages):
        before = fa.launches_d32
        t0 = time.perf_counter()
        scores = flash_score(question, passages)
        calls.append(dict(question=question, texts=list(passages), scores=scores,
                          ms=(time.perf_counter() - t0) * 1e3, launches=fa.launches_d32 - before))
        return scores

    cross.score = recorded_score
    reranker = JaxReranker(cross_encoder=cross, rerank_k=CKPT_RERANK_K)
    rag = VerbatimRAG(rerank_index, extractor=served, reranker=reranker, k=CKPT_RERANK_K)
    token_pairs = [(CKPT_QUESTION, t) for t in texts[:16]]
    forwards = predicted_forwards(served, token_pairs)
    warned = []
    handler = logging.Handler(level=logging.WARNING)
    handler.emit = lambda record: warned.append(record.getMessage())
    rag_loggers = [logging.getLogger(n) for n in ("verbatim_rag_tpu_torch.rag.core",
                                                  "verbatim_rag_tpu_torch.rag.streaming")]

    # -- the main path ------------------------------------------------------------------
    synchronize(device)
    reset_counts()
    t0 = time.perf_counter()
    spans = served.extract_spans(CKPT_QUESTION, [Result(t) for _, t in token_pairs])
    synchronize(device)
    extract_s = time.perf_counter() - t0
    extract_launches = fa.launches
    t0 = time.perf_counter()
    kept = sentence.extract_spans(CKPT_QUESTION, [Result(t) for t in texts])
    synchronize(device)
    sentence_s = time.perf_counter() - t0
    sentence_launches = fa.launches - extract_launches
    for lg in rag_loggers:
        lg.addHandler(handler)
    try:
        t0 = time.perf_counter()
        batch = rag.query_batch(questions)
        synchronize(device)
        batch_s = time.perf_counter() - t0
        single = asyncio.run(rag.query_async(questions[0]))
        events = StreamingRAG(rag).stream_query_sync(questions[1])
    finally:
        for lg in rag_loggers:
            lg.removeHandler(handler)
    counts = read_counts()

    # -- checks ---------------------------------------------------------------------------
    # Token checkpoint: the native checkpoint's weights and probabilities
    # exactly, launches as the layers and windows predict, spans verbatim.
    native = ModelSpanExtractor(model_path=str(final), device=device)
    state, reference = served.model.state_dict(), native.model.state_dict()
    # Layer 0's attention norm is Identity in ModernBERT: HF files omit it and
    # the loaders fill a unit norm (training's weight decay moved the native
    # one, which the forward never reads).
    skipped = {k for k in state if k.startswith("layers.0.attn_ln.")} if config.first_layer_no_attn_norm else set()
    differ = sorted(k for k in state.keys() - skipped if not torch.equal(state[k], reference[k]))
    require(state.keys() == reference.keys() and not differ,
            f"checkpoints: HF-loaded weights differ from the native checkpoint's: {differ[:8]}")
    row = served._plan(CKPT_QUESTION, " ".join(texts[:8]))["rows"][0]
    ids = torch.tensor([row], dtype=torch.int32, device=device)
    mask = torch.ones_like(ids)
    with torch.no_grad():
        probs_diff = float((token_relevance_probs(served.model, ids, mask)
                            - token_relevance_probs(native.model, ids, mask)).abs().max())
    del native
    require(probs_diff == 0.0, f"checkpoints: HF-loaded probabilities differ by {probs_diff}")
    require(all(s and s in text for text, ss in spans.items() for s in ss), "checkpoints: a span is not verbatim")
    token_check = dict(
        stage_s=stage_s, load_s=load_s, probs_max_diff=probs_diff, probe_tokens=len(row),
        extract_s=extract_s, extract_launches=extract_launches,
        predicted_launches=config.num_layers * forwards, spans=sum(len(s) for s in spans.values()),
    )
    log("checkpoints token", json.dumps(token_check))
    require(extract_launches == config.num_layers * forwards,
            f"checkpoints: {extract_launches} flash launches, {config.num_layers} layers x {forwards} forwards")

    # Sentence extractor: probabilities within the bf16 limit of the same
    # model through plain attention; kept sentences equal wherever no
    # probability lies within that limit of the threshold.
    plain_sentence = SentenceModelExtractor(
        params=sentence.model.state_dict(), config=dataclasses.replace(config, use_flash_attention=False),
        tokenizer=sentence.tokenizer, device=device,
    )
    sent_spans, sent_mask, flash_probs = sentence.sentence_probs(CKPT_QUESTION, texts)
    _, _, plain_probs = plain_sentence.sentence_probs(CKPT_QUESTION, texts)
    live = sent_mask > 0
    sentence_diff = float(np.abs(flash_probs - plain_probs)[live].max())
    require(sentence_diff <= CKPT_PROBS_ATOL,
            f"checkpoints: sentence probabilities {sentence_diff} from plain attention's")
    threshold = sentence.threshold
    clear = live & (np.abs(plain_probs - threshold) > CKPT_PROBS_ATOL)
    flipped = int((clear & ((flash_probs >= threshold) != (plain_probs >= threshold))).sum())
    require(flipped == 0, f"checkpoints: {flipped} kept sentences differ from plain attention's")
    for i, text in enumerate(texts):
        spans_i = sent_spans[i][: sentence.max_sentences]
        expected = [text[s:e] for j, (s, e) in enumerate(spans_i) if live[i, j] and flash_probs[i, j] >= threshold]
        require(kept[text] == expected, f"checkpoints: extract_spans kept other sentences of chunk {i}")
    n_kept = sum(len(v) for v in kept.values())
    require(0 < n_kept < int(live.sum()), f"checkpoints: {n_kept} of {int(live.sum())} sentences kept")
    sentence_check = dict(
        texts=len(texts), sentences=int(live.sum()), kept=n_kept, compared_sentences=int(clear.sum()),
        probs_max_diff=sentence_diff, seconds=sentence_s, launches=sentence_launches,
    )
    log("checkpoints sentence", json.dumps(sentence_check))
    require(sentence_launches == config.num_layers,
            f"checkpoints: the sentence extractor launched flash {sentence_launches} times")
    del sentence, plain_sentence

    # Rerank: no warning (the catch in `_apply_reranker` never fired); each
    # call got its question's 50 retrieved passages, all distinct, and the
    # response holds them in the order of the call's scores. Against the same
    # cross-encoder through plain attention: the kernel on the layers' own
    # q/k/v, the pooled state each score is read from (its dot with the score
    # weights sums terms that cancel) at the bf16 limit of each row, and the
    # passages' order; a planted fault that hides the passages from the
    # kernel must fail both.
    require(not warned, f"checkpoints: the RAG logged {warned}")
    require(len(calls) == len(questions) + 2, f"checkpoints: {len(calls)} rerank calls")
    batch_calls = calls[: len(questions)]
    plain_cross = JaxCrossEncoder(params=cross.model.state_dict(),
                                  config=dataclasses.replace(ce_config, use_flash_attention=False),
                                  device=device)
    retrieved = rerank_index.query_batch(questions, k=rag.k)
    pooled_worst, discordant, plain_pooled = 0.0, [], {}
    for call, response, results in zip(batch_calls, batch, retrieved):
        q, passages = call["question"], call["texts"]
        require(passages == [r.text for r in results] and len(set(passages)) == CKPT_RERANK_K,
                f"checkpoints: the reranker of {q!r} got other than its 50 distinct retrieved passages")
        by_score = [passages[i] for i in sorted(range(len(passages)), key=lambda i: -call["scores"][i])]
        require([d.content for d in response.documents] == by_score,
                f"checkpoints: the response to {q!r} is not in the order of its scores")
        plain_pooled[q] = plain_cross.pooled(q, passages)
        pooled_worst = max(pooled_worst, rows_ratio(cross.pooled(q, passages), plain_pooled[q]))
        discordant.append(discordant_share(call["scores"], plain_cross.score(q, passages)))
    require(pooled_worst <= 1.0, f"checkpoints: cross-encoder pooled state at {pooled_worst} of its limit")
    require(max(discordant) <= CKPT_DISCORDANT_MAX,
            f"checkpoints: flash scores order {max(discordant)} of a call's pairs otherwise than plain")
    for got, question in ((single.model_dump(), questions[0]), (events[-1]["data"], questions[1])):
        require(got == rag.query(question).model_dump(), f"checkpoints: async / stream answer of {question!r}")
    stages = [t["stage"] for t in events[-1]["timings"]]
    require(stages[:2] == ["retrieve", "rerank"], f"checkpoints: stream stages {stages}")
    d32 = [c["launches"] for c in calls]
    require(all(n == ce_config.num_layers for n in d32), f"checkpoints: cross-encoder flash launches {d32}")
    q0, p0 = batch_calls[0]["question"], batch_calls[0]["texts"]
    kernel_check = flash_on_layers(cross, q0, p0)
    # The planted fault: every key past the fourth hidden from the kernel.
    encoder_module.flash_attention = lambda q, k, v, lengths, window=None: fa.flash_attention(
        q, k, v, torch.clamp(lengths, max=4), window)
    try:
        fault_pooled = rows_ratio(cross.pooled(q0, p0), plain_pooled[q0])
        fault_discordant = discordant_share(flash_score(q0, p0), plain_cross.score(q0, p0))
    finally:
        encoder_module.flash_attention = fa.flash_attention
    require(fault_pooled > 1.0, f"checkpoints: the passages hidden, the pooled state passes ({fault_pooled})")
    require(fault_discordant > CKPT_DISCORDANT_MAX,
            f"checkpoints: the passages hidden, the order passes ({fault_discordant})")
    rerank_profile = device_profile(lambda: [reranker.rerank(q, r) for q, r in zip(questions, retrieved)])
    batch_ms = [c["ms"] for c in batch_calls]
    result = dict(
        card=card, token=token_check, sentence=sentence_check,
        rerank=dict(
            questions=len(questions), chunks=n_chunks, index_s=rerank_index_s, k=rag.k,
            rerank_k=CKPT_RERANK_K, batch_s=batch_s, batch_rerank_wall_s=sum(batch_ms) / 1e3,
            batch_rerank_ms_median=float(np.median(batch_ms)),
            stream_rerank_ms=next(t["elapsed_ms"] for t in events[-1]["timings"] if t["stage"] == "rerank"),
            kernel=kernel_check, pooled_worst_row_of_limit=pooled_worst,
            discordant_share_max=max(discordant), discordant_share_median=float(np.median(discordant)),
            fault_passages_hidden=dict(pooled_of_limit=fault_pooled, discordant_share=fault_discordant),
            cross_encoder_launches_d32=sum(d32), profile=rerank_profile,
        ),
        seconds=time.perf_counter() - t_phase, launches=counts,
    )
    log("checkpoints", json.dumps(result))
    require(counts["flash_attention_d32"] > 0 and counts["rescore"] > 0
            and counts["flash_attention"] > counts["flash_attention_d32"],
            f"checkpoints: launches {counts}")
    shutil.rmtree(work, ignore_errors=True)
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; this script runs only on a GPU\n")
        raise SystemExit(2)
    if not (ROOT / "verbatim_rag_tpu_torch" / "csrc").is_dir():
        sys.stderr.write("chip_smoke: run it from a checkout of the repository\n")
        raise SystemExit(3)
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import dataclasses

    from verbatim_rag_tpu_torch.models import ModelSpanExtractor
    from verbatim_rag_tpu_torch.ops import cuda_build

    card = gpu_name_and_limit()
    log("card:", card, "| torch", torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    build_logs = cuda_build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    build = check_build(build_logs)
    host_runtime = build_host_runtime()

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flash = check_flash(gen, 64)
    flash_d32 = check_flash(gen, 32)
    flash_bwd = check_flash_bwd(gen, 64)
    flash_bwd_d32 = check_flash_bwd(gen, 32)
    partial = check_flash_partial(gen, 64)
    partial_d32 = check_flash_partial(gen, 32)
    rescore = check_rescore(gen)
    rescore["bm25_width"] = check_rescore_bm25(gen)
    torch.cuda.empty_cache()
    section, bucket = check_tables(gen)
    section["three_arms"] = check_section_three_arms(gen)
    bucket_v1 = check_bucket_v1(gen)
    torch.cuda.empty_cache()
    wide = check_wide_tables(gen)
    section["wide"] = wide["section"]
    bucket["wide"] = wide["bucket_max_v2"]
    bucket_v1["wide"] = wide["bucket_max_v1"]

    extractor, flow = run_flow(args.seed, card)
    serving = ModelSpanExtractor(config=dataclasses.replace(extractor.config, num_layers=SERVE_LAYERS), seed=args.seed)
    serve, rag, singles = run_serve(serving, args.seed, card)
    http = run_http(rag, serving, singles, card)
    doc = run_doc(serving, args.seed, card)
    serve_index = rag.index
    del rag, singles, serving
    torch.cuda.empty_cache()
    bucket_ab = run_bucket_ab(gen, card)
    data = bench_data(args.seed)
    store = run_store(data, card)
    store_int8 = run_store_int8(data, card)
    ragged = run_ragged(data, card, gen, store_int8["batch_event_ms_median"])
    int4 = run_int4(data, card, args.seed)
    mesh = run_mesh(data, card, args.seed)
    processes = run_processes(args.seed, card)
    full_text = run_full_text(data, card, args.seed)
    del data
    torch.cuda.empty_cache()
    cli = run_cli(card)
    long_ctx = run_long(extractor, args.seed, card)
    long_sp = run_long_sp(extractor, args.seed, card)
    del extractor
    torch.cuda.empty_cache()
    sp_processes = run_sp_processes(args.seed, card, long_sp)
    train, train_batches = run_train(args.seed, card)
    train_mesh = run_train_mesh(train_batches, args.seed, card, train)
    del train_batches
    torch.cuda.empty_cache()
    tp_processes = run_tp_processes(args.seed, card)
    train_d32 = run_train_d32(args.seed, card)
    checkpoints = run_checkpoints(
        serve_index, serve_questions(), ROOT / "build" / "chip_smoke_train" / "final", args.seed, card
    )
    shutil.rmtree(ROOT / "build" / "chip_smoke_train", ignore_errors=True)
    del serve_index

    phases = (
        flow, serve, http, doc, bucket_ab, store, store_int8, ragged, int4, mesh, processes, full_text, cli,
        long_ctx, long_sp, sp_processes, train, train_mesh, tp_processes, train_d32, checkpoints,
    )
    by_program = mesh["launches_by_program"]
    per_shard = mesh["per_shard"]
    launches = {k: sum(p["launches"][k] for p in phases) for k in flow["launches"]}
    d32_bwd = launches["flash_bwd_dq_d32"] + launches["flash_bwd_dkv_d32"]
    for name in ("flash_bwd_dq_d32", "flash_bwd_dkv_d32", "flash_attention_partial_d32"):
        require(train_d32["launches"][name] > 0, f"train_d32: no {name} launch")
    kernels = [
        dict(
            name="flash_attention_fwd",
            route="cuda",
            source="verbatim_rag_tpu_torch/csrc/flash_attention.cu",
            replaces="verbatim_rag_tpu/ops/flash_attention.py:54",
            launches=launches["flash_attention"] - launches["flash_attention_d32"],
            registers=build.get("flash_fwd_wgmma_kernelILi64E", {}).get("registers"),
            train_mesh=train_mesh["kernels"]["flash_attention_fwd"],
            tp_processes=dict(launches_by_rank=tp_processes["launches_by_rank"]["flash_attention"]),
            **flash,
        ),
        dict(
            name="flash_attention_fwd_d32",
            route="cuda",
            source="verbatim_rag_tpu_torch/csrc/flash_attention.cu",
            replaces="verbatim_rag_tpu/ops/flash_attention.py:54",
            launches=launches["flash_attention_d32"],
            registers=build.get("flash_fwd_wgmma_kernelILi32E", {}).get("registers"),
            grid_split=ragged["grid"]["forward"],
            **flash_d32,
        ),
        dict(
            name="flash_attention_bwd",
            route="cuda",
            source="verbatim_rag_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="verbatim_rag_tpu/ops/flash_attention.py:245",
            replaces_dkv="verbatim_rag_tpu/ops/flash_attention.py:312",
            launches=launches["flash_bwd_dq"] + launches["flash_bwd_dkv"] - d32_bwd,
            launches_dq=launches["flash_bwd_dq"] - launches["flash_bwd_dq_d32"],
            launches_dkv=launches["flash_bwd_dkv"] - launches["flash_bwd_dkv_d32"],
            registers_dq=build.get("flash_bwd_dq_wgmma_kernelILi64E", {}).get("registers"),
            registers_dkv=build.get("flash_bwd_dkv_wgmma_kernelILi64E", {}).get("registers"),
            train_mesh=train_mesh["kernels"]["flash_attention_bwd"],
            tp_processes=dict(launches_by_rank=[
                dq + dkv for dq, dkv in zip(*(tp_processes["launches_by_rank"][k] for k in ("flash_bwd_dq", "flash_bwd_dkv")))
            ]),
            **flash_bwd,
        ),
        dict(
            name="flash_attention_bwd_d32",
            route="cuda",
            source="verbatim_rag_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="verbatim_rag_tpu/ops/flash_attention.py:245",
            replaces_dkv="verbatim_rag_tpu/ops/flash_attention.py:312",
            launches=d32_bwd,
            launches_dq=launches["flash_bwd_dq_d32"],
            launches_dkv=launches["flash_bwd_dkv_d32"],
            registers_dq=build.get("flash_bwd_dq_wgmma_kernelILi32E", {}).get("registers"),
            registers_dkv=build.get("flash_bwd_dkv_wgmma_kernelILi32E", {}).get("registers"),
            grid_split=ragged["grid"]["backward"],
            **flash_bwd_d32,
        ),
        dict(
            name="flash_attention_partial",
            route="cuda",
            source="verbatim_rag_tpu_torch/csrc/flash_attention.cu",
            replaces="verbatim_rag_tpu/ops/flash_attention.py:581",
            launches=launches["flash_attention_partial"] - launches["flash_attention_partial_d32"],
            registers=build.get("flash_partial_wgmma_kernelILi64E", {}).get("registers"),
            train_mesh=train_mesh["kernels"]["flash_attention_partial"],
            sp_processes=dict(launches_by_rank=sp_processes["partial_launches_by_rank"]),
            **partial,
        ),
        dict(
            name="flash_attention_partial_d32",
            route="cuda",
            source="verbatim_rag_tpu_torch/csrc/flash_attention.cu",
            replaces="verbatim_rag_tpu/ops/flash_attention.py:581",
            launches=launches["flash_attention_partial_d32"],
            registers=build.get("flash_partial_wgmma_kernelILi32E", {}).get("registers"),
            grid_split=ragged["grid"]["partial"],
            **partial_d32,
        ),
        dict(
            name="sparse_rescore",
            route="cuda",
            source="verbatim_rag_tpu_torch/csrc/rescore.cu",
            replaces="verbatim_rag_tpu/ops/rescore.py:41",
            launches=launches["rescore"],
            registers=build.get("rescore_kernel", {}).get("registers"),
            mesh=dict(
                launches=sum(c["rescore"] for c in by_program.values()), shards=MESH_SHARDS,
                shard_ms=per_shard["rescore_ms"], shard_plain_ms=per_shard["rescore_plain_ms"],
                shard_candidates=per_shard["candidates"],
            ),
            processes=dict(
                launches_by_rank=processes["launches_by_rank"]["rescore"], ranks=PROC_RANKS,
                positions_a_rank=PROC_POSITIONS,
            ),
            grid_split=ragged["grid"]["rescore"],
            **rescore,
        ),
        dict(
            name="section_tables",
            route="cuda",
            source="verbatim_rag_tpu_torch/csrc/section.cu",
            replaces="verbatim_rag_tpu/ops/section.py:106",
            launches=launches["section"],
            launches_streamed=launches["section_streamed"],
            registers_int8=build.get("section_wgmma_kernelILb1E", {}).get("registers"),
            registers_bf16=build.get("section_wgmma_kernelILb0E", {}).get("registers"),
            registers_f32=build.get("fma_walk_kernelILi0E", {}).get("registers"),
            registers_streamed_int8=build.get("section_streamed_kernelILb1E", {}).get("registers"),
            registers_streamed_bf16=build.get("section_streamed_kernelILb0E", {}).get("registers"),
            mesh=dict(
                launches=sum(c["section"] for c in by_program.values()), shards=MESH_SHARDS,
                shard_rows=per_shard["shard_rows"], shard_ms=per_shard["section_ms"],
                shard_plain_ms=per_shard["section_plain_ms"],
            ),
            processes=dict(
                launches_by_rank=processes["launches_by_rank"]["section"], ranks=PROC_RANKS,
                positions_a_rank=PROC_POSITIONS,
                batch_event_ms_median_by_rank=processes["programs"]["section"]["batch_event_ms_median_by_rank"],
            ),
            ragged=ragged["tables"]["section"],
            **section,
        ),
        dict(
            name="bucket_max_v2",
            route="cuda",
            source="verbatim_rag_tpu_torch/csrc/section.cu",
            replaces="verbatim_rag_tpu/ops/fused_topk.py:255",
            launches=launches["bucket_max_v2"],
            registers_int8=build.get("bucket_v2_wgmma_kernelILb1E", {}).get("registers"),
            registers_bf16=build.get("bucket_v2_wgmma_kernelILb0E", {}).get("registers"),
            registers_f32=build.get("fma_walk_kernelILi1E", {}).get("registers"),
            mesh=dict(
                launches=sum(c["bucket_max_v2"] for c in by_program.values()), shards=MESH_SHARDS,
                shard_rows=per_shard["shard_rows"], shard_ms=per_shard["bucket_max_v2_ms"],
                shard_plain_ms=per_shard["bucket_max_v2_plain_ms"],
            ),
            ragged=ragged["tables"]["bucket_max_v2"],
            **bucket,
        ),
        dict(
            name="bucket_max_v1",
            route="cuda",
            source="verbatim_rag_tpu_torch/csrc/section.cu",
            replaces="verbatim_rag_tpu/ops/fused_topk.py:42",
            launches=launches["bucket_max_v1"],
            registers=build.get("bucket_v1_wgmma_kernel", {}).get("registers"),
            registers_f32=build.get("fma_walk_kernelILi2E", {}).get("registers"),
            ab_overlap_k256={
                f"d{d}": {arm: bucket_ab[f"d{d}"][arm]["overlap"] for arm in ("v1", "v2_onedot")}
                for d in (384, 768)
            },
            ragged=ragged["tables"]["bucket_max_v1"],
            **bucket_v1,
        ),
    ]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']}: no launch on the main path")
    require(launches["flash_bwd_dq"] > 0 and launches["flash_bwd_dkv"] > 0, f"flash bwd launches {launches}")
    host_runtime["phases"] = {
        name: dict(
            scanner=p["scanner"], **{k: p[k] for k in ("profile_wall_ms", "kernel_ms", "idle_share")},
            **{k: p["host_scanner"][k] for k in ("texts", "tokenize_ms", "tokenize_python_ms", "analyze_ms",
                                                 "analyze_plain_ms")},
        )
        for name, p in (("long", long_ctx), ("serve", serve), ("full_text", full_text))
    }
    host_runtime["phases"]["full_text"].update(
        ingest_scanner=full_text["ingest_scanner"], ingest_analyzer_s=full_text["analyzer_s"]
    )
    log(json.dumps({"host_runtime": host_runtime}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
