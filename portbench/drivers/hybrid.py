"""Driver of hybrid retrieval at scale: ``DeviceVectorStore.query_batch``
(dense + sparse, top-k, RRF) over rows and query batches made from the seed
as ``chip_smoke.py::bench_data`` makes them.

One call is one query batch. The check compares, against the reference
(``reference/search.py``: float32 arithmetic on rows and queries rounded to
the configuration's storage type) over the same rows and queries:

- ``top_miss``: the share of the reference's top-k rows missing from the
  program's, over the sampled batches;
- ``order_miss``: the share of the reference's (query, position) hits the
  program does not return at that position with that fused score (within
  1e-6);
- ``unanswered``: queries of the sampled batches with fewer than k hits.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench.harness import common, gen
from portbench.reference.search import HybridReference


class Driver:
    """The hybrid cell: set-up, one batch a call, the check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans: common.Spans, store_args=None):
        self.cfg, self.traffic, self.seed, self.device, self.spans = cfg, traffic, seed, device, spans
        self.store_args = store_args or {}
        self.kept: dict[int, list] = {}

    def setup(self) -> None:
        from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

        c, t = self.cfg, self.traffic
        self.data = gen.bench_data(
            self.seed, c["rows"], c["dense_dim"], c["sparse_max_nnz"], c["sparse_vocab"],
            t["batch"], c["query_terms"],
        )
        self.batches = [self.data["queries"](i) for i in range(t["batches"])]
        args = dict(
            dense_dim=c["dense_dim"], sparse_vocab=c["sparse_vocab"], sparse_max_nnz=c["sparse_max_nnz"],
            dense_dtype=c["dense_dtype"], candidate_impl=c["candidate_impl"],
            projection_dim=c["projection_dim"], rescore_depth=c["rescore_depth"], device=self.device,
        )
        args.update(self.store_args)
        self.store = DeviceVectorStore(**args)
        d = self.data
        self.store.add_vectors([
            {"id": str(i), "dense": d["dense"][i], "sparse_arrays": (d["ids"][i], d["weights"][i])}
            for i in range(c["rows"])
        ])
        self.store.flush()
        self.sample = set(
            np.random.default_rng([self.seed, 3]).choice(
                t["check_from"], size=min(t["check_batches"], t["check_from"]), replace=False
            ).tolist()
        )

    def warm(self) -> None:
        self._query(self.batches[0])

    def _query(self, batch):
        q_dense, q_sparse, _ = batch
        return self.store.query_batch(
            dense_queries=q_dense, sparse_queries=q_sparse, top_k=self.cfg["top_k"],
            rrf_k=self.cfg["rrf_k"],
        )

    def call(self, i: int) -> tuple[int, int]:
        n = len(self.batches)
        out = self._query(self.batches[(1 + i) % n])
        if i in self.sample:
            self.kept[i] = out
        k, batch = self.cfg["top_k"], self.traffic["batch"]
        return batch, batch - len(out) + sum(1 for r in out if len(r) != k)

    def end_to_end(self, window_s: float, attempted: int) -> dict:
        return {"search_qps": attempted / window_s}

    def layer_record(self) -> dict:
        c = self.cfg
        flops = 2.0 * self.traffic["batch"] * c["rows"] * (c["dense_dim"] + c["projection_dim"])
        return {"candidate_flops_per_batch": flops}

    def release(self) -> None:
        self.store = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self):
        d, c = self.data, self.cfg
        dev = self.device
        return HybridReference(
            torch.from_numpy(d["dense"]).to(dev), torch.from_numpy(d["ids"]).to(dev),
            torch.from_numpy(d["weights"]).to(dev), c["sparse_vocab"], c["projection_dim"],
            storage=c["dense_dtype"],
        )

    def check(self, ref=None) -> dict:
        ref = ref or self.reference()
        k, n = self.cfg["top_k"], len(self.batches)
        want = missed = misplaced = unanswered = 0
        with torch.no_grad():
            for i, out in sorted(self.kept.items()):
                q_dense, (q_ids, q_w), _ = self.batches[(1 + i) % n]
                dev = self.device
                scores, rows = ref.search(
                    torch.from_numpy(q_dense).to(dev), torch.from_numpy(q_ids).to(dev),
                    torch.from_numpy(q_w).to(dev), k, self.cfg["rescore_depth"], self.cfg["rrf_k"],
                )
                for b in range(len(q_dense)):
                    got = [(int(h.id), h.score) for h in out[b]] if b < len(out) else []
                    exp = [(int(r), float(s)) for r, s in zip(rows[b], scores[b]) if r >= 0]
                    unanswered += int(len(got) != k)
                    want += len(exp)
                    missed += len({r for r, _ in exp} - {r for r, _ in got})
                    misplaced += len(exp) - sum(
                        1 for (r1, s1), (r2, s2) in zip(got, exp) if r1 == r2 and abs(s1 - s2) <= 1e-6
                    )
        return dict(
            top_miss=missed / max(want, 1),
            order_miss=misplaced / max(want, 1),
            unanswered=float(unanswered + (len(self.kept) == 0)),
        )
