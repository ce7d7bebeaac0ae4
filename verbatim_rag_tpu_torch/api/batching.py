"""Server-side micro-batching: coalesce concurrent queries into one dispatch.

The engine's throughput comes from batch parallelism — one fused device
program serves hundreds of queries (`bench.py`: ~9k QPS at batch 512 vs
~10–30 QPS if every HTTP request paid its own ~31 ms device round-trips).
This batcher turns concurrent `/api/query` requests into
`VerbatimRAG.query_batch` calls: a request waits at most ``max_wait_ms``
for companions (or until ``max_batch`` arrive), then the whole group runs
as one retrieval dispatch + one multi-question extraction forward.

Requests only batch with requests that share the same search parameters
(k, filter, hybrid_weights, rrf_k) — mixing them would change results.

The reference has no equivalent (its query path is strictly
one-question-per-call, `verbatim_rag/core.py:210-277`).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Any, Callable

logger = logging.getLogger(__name__)


def _params_key(params: dict[str, Any]) -> str:
    """Stable identity of the non-batchable search parameters."""
    return json.dumps(params, sort_keys=True, default=str)


class MicroBatcher:
    """Group concurrent payloads by parameter key and run them batched."""

    def __init__(
        self,
        run_batch: Callable[[list[str], dict[str, Any]], list[Any]],
        max_batch: int = 64,
        max_wait_ms: float = 4.0,
    ):
        #: run_batch(questions, params) -> one result per question (sync;
        #: executed in a worker thread).
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        #: Per parameter key: (question, future, submit time) in arrival order.
        self._queues: dict[str, list[tuple[str, asyncio.Future, float]]] = {}
        self._workers: dict[str, asyncio.Task] = {}
        self._lock = asyncio.Lock()
        #: batches dispatched / requests served (observability)
        self.batches = 0
        self.requests = 0
        #: Seconds the served requests waited from submit to dispatch: sum, max.
        self.queue_wait_s = 0.0
        self.queue_wait_max_s = 0.0

    async def submit(self, question: str, params: dict[str, Any]) -> Any:
        key = _params_key(params)
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        async with self._lock:
            self._queues.setdefault(key, []).append((question, future, time.perf_counter()))
            if key not in self._workers:
                # Detached worker: if THIS request's handler is cancelled
                # (client disconnect, shutdown) mid-batch, the rest of the
                # group still gets its results.
                self._workers[key] = asyncio.create_task(self._worker(key, params))
        return await future

    async def _worker(self, key: str, params: dict[str, Any]) -> None:
        """Drain the key's queue batch by batch until it runs dry.

        Adaptive batching falls out of the loop structure: while one batch
        runs on the device, new arrivals accumulate and form the next batch
        (size = arrival rate × service time, capped at max_batch) — a timer
        that flushed on a fixed cadence instead launched overlapping small
        batches under load.
        """
        try:
            await asyncio.sleep(self.max_wait_ms / 1000.0)  # gather companions
            while True:
                async with self._lock:
                    queue = self._queues.get(key, [])
                    batch, self._queues[key] = (
                        queue[: self.max_batch],
                        queue[self.max_batch :],
                    )
                    if not batch:
                        self._queues.pop(key, None)
                        return
                await self._run_one(batch, params)
        except BaseException:
            # Shutdown / hard interrupt: fail stranded waiters, not hang them.
            leftovers = self._queues.pop(key, [])
            for _q, future, _t in leftovers:
                if not future.done():
                    future.set_exception(RuntimeError("batcher shut down"))
            raise
        finally:
            # A dead worker left registered would strand every later submit.
            self._workers.pop(key, None)

    async def _run_one(self, batch, params: dict[str, Any]) -> None:
        dispatched = time.perf_counter()
        questions = [q for q, _, _ in batch]
        self.batches += 1
        self.requests += len(batch)
        waits = [dispatched - t for _, _, t in batch]
        self.queue_wait_s += sum(waits)
        self.queue_wait_max_s = max(self.queue_wait_max_s, *waits)
        try:
            results = await asyncio.to_thread(self.run_batch, questions, params)
            if len(results) != len(batch):
                raise RuntimeError(
                    f"run_batch returned {len(results)} results for {len(batch)} questions"
                )
            for (_q, future, _t), result in zip(batch, results):
                if not future.done():
                    future.set_result(result)
        except BaseException as exc:  # incl. CancelledError: never strand waiters
            logger.error("micro-batch of %d failed: %r", len(batch), exc)
            for _q, future, _t in batch:
                if not future.done():
                    future.set_exception(
                        exc if isinstance(exc, Exception) else RuntimeError(repr(exc))
                    )
            if not isinstance(exc, Exception):
                raise

    def stats(self) -> dict[str, float]:
        """Batches and requests so far, and how long a request waited from
        ``submit`` to its batch's dispatch: the mean and the longest, ms."""
        return {
            "batches": self.batches,
            "requests": self.requests,
            "avg_batch_size": self.requests / self.batches if self.batches else 0.0,
            "queue_wait_ms": 1e3 * self.queue_wait_s / self.requests if self.requests else 0.0,
            "queue_wait_max_ms": 1e3 * self.queue_wait_max_s,
        }
