"""HTTP API service (aiohttp; port of `verbatim_rag_tpu/api/app.py`).

The JAX server's wire contract —
GET  /api/documents, GET /api/status, GET /api/templates,
POST /api/query (micro-batched), POST /api/query_async (+ /api/query/async
alias), POST /api/transform/verbatim (stateless core transform),
POST /api/query/stream → NDJSON streaming with anti-buffering headers,
POST /api/debug/trace (`torch.profiler` start/stop) —
plus CORS and the static `frontend/` mount, served from the device that
``VERBATIM_FORCE_PLATFORM`` names (the card unless it says ``cpu``).

    python -m verbatim_rag_tpu_torch.api.app      # INDEX_PATH, API_PORT, ...
"""

from __future__ import annotations

import asyncio
import json
import logging
import tempfile
from typing import Any

from aiohttp import web

from . import dependencies as deps
from ..engine.filters import FilterExpressionError
from ..utils.profiling import DeviceTrace, counters, summary, trace_device_busy_ms

logger = logging.getLogger(__name__)


def _json_error(message: str, status: int = 400) -> web.Response:
    return web.json_response({"detail": message}, status=status)


def _validate_question(data: dict, max_len: int) -> str | None:
    question = (data or {}).get("question", "")
    if not isinstance(question, str) or not question.strip():
        return None
    if len(question) > max_len:
        return None
    return question.strip()


# -- handlers -----------------------------------------------------------------------


async def handle_status(request: web.Request) -> web.Response:
    ready, detail = await asyncio.to_thread(deps.check_system_ready)
    index = deps.get_index()
    stats = index.inspect()
    batcher = deps.get_batcher()
    if batcher is not None:
        stats["micro_batching"] = batcher.stats()
    return web.json_response({"status": "ok" if ready else "error", "detail": detail, **stats})


async def handle_documents(request: web.Request) -> web.Response:
    index = deps.get_index()
    return web.json_response({"documents": index.get_all_documents()})


async def handle_debug_trace(request: web.Request) -> web.Response:
    """POST /api/debug/trace {"action": "start"|"stop", "logdir": ...}.

    Device-profiling hooks for load benchmarks: a client brackets a load
    window with start/stop; "start" runs `torch.profiler` over the server's
    device and host threads, and "stop" writes the Chrome trace (kernels
    and the program's ``vrag.*`` spans on one timeline) into the logdir and
    returns {"module_wall_ms": ..., "spans": ..., "counters": ...}: the
    milliseconds the card was busy in the window (the union of its kernel
    intervals), independent of HTTP round trips, null on a CPU server,
    which has no device time; each span name's count, total and self ms
    (`profiling.summary`); and the program's counters.
    Debug-only surface: enabled by API_DEBUG_TRACE=1 (never in default
    deployments — a trace can be multi-MB per second of load)."""
    import os

    if os.environ.get("API_DEBUG_TRACE") != "1":
        return web.json_response({"error": "set API_DEBUG_TRACE=1"}, status=403)
    try:
        data = await request.json()
    except Exception:
        return web.json_response({"error": "invalid JSON body"}, status=400)
    action = data.get("action")

    if action == "start":
        logdir = data.get("logdir") or tempfile.mkdtemp(prefix="api_trace_")
        trace = DeviceTrace(logdir, deps.get_device())
        trace.start()
        request.app["trace"] = trace
        request.app["trace_logdir"] = logdir
        return web.json_response({"status": "tracing", "logdir": logdir})
    if action == "stop":
        trace = request.app.pop("trace")
        trace.stop()
        logdir = request.app.get("trace_logdir")
        wall = None
        if trace.device.type == "cuda":
            wall = round(trace_device_busy_ms(logdir), 3)
        return web.json_response({"status": "stopped", "logdir": logdir,
                                  "module_wall_ms": wall, "spans": summary(),
                                  "counters": counters()})
    return web.json_response({"error": "action must be start|stop"}, status=400)


async def handle_templates(request: web.Request) -> web.Response:
    tm = deps.get_template_manager()
    return web.json_response(tm.info())


_SEARCH_TYPES = {"dense", "sparse", "hybrid", "full_text"}


def _validate_search_type(data) -> web.Response | None:
    """400 on an unknown search_type BEFORE the query runs (the UI's ⚙
    panel sends it; a typo must not surface as a 500)."""
    st = data.get("search_type")
    if st is not None and st not in _SEARCH_TYPES:
        return _json_error(
            f"unknown search_type {st!r} (expected one of {sorted(_SEARCH_TYPES)})"
        )
    return None


async def handle_query(request: web.Request) -> web.Response:
    config = deps.get_config()
    try:
        data = await request.json()
    except Exception:
        return _json_error("invalid JSON body")
    question = _validate_question(data, config.max_question_length)
    if question is None:
        return _json_error(
            f"question must be a non-empty string of at most "
            f"{config.max_question_length} characters"
        )
    # to_thread: first-time construction (index load + model init) takes
    # seconds and shares a lock with the warmup thread — calling it inline
    # would freeze the event loop for every other connection.
    err = _validate_search_type(data)
    if err:
        return err
    rag = await asyncio.to_thread(deps.get_rag)
    params = {
        "k": data.get("k"),
        "filter": data.get("filter"),
        "hybrid_weights": data.get("hybrid_weights"),
        "rrf_k": data.get("rrf_k", 60),
        "search_params": data.get("search_params"),
        "search_type": data.get("search_type"),
        "template_mode": data.get("template_mode"),
    }
    try:
        batcher = deps.get_batcher()
        if batcher is not None:
            # Concurrent requests with the same params coalesce into ONE
            # batched retrieval dispatch + multi-question extraction forward.
            response = await batcher.submit(question, params)
        else:
            response = await asyncio.to_thread(
                rag.query,
                question,
                params["k"],
                params["filter"],
                params["hybrid_weights"],
                params["rrf_k"],
                params["search_params"],
                params["search_type"],
                params["template_mode"],
            )
    except FilterExpressionError as exc:
        return _json_error(f"invalid filter expression: {exc}", status=400)
    except Exception as exc:
        logger.exception("Query failed")
        return _json_error(f"query failed: {exc}", status=500)
    return web.json_response(response.model_dump())


async def handle_query_async(request: web.Request) -> web.Response:
    config = deps.get_config()
    try:
        data = await request.json()
    except Exception:
        return _json_error("invalid JSON body")
    question = _validate_question(data, config.max_question_length)
    if question is None:
        return _json_error("invalid question")
    err = _validate_search_type(data)
    if err:
        return err
    rag = await asyncio.to_thread(deps.get_rag)
    try:
        response = await rag.query_async(
            question,
            k=data.get("k"),
            filter=data.get("filter"),
            hybrid_weights=data.get("hybrid_weights"),
            rrf_k=data.get("rrf_k", 60),
            search_params=data.get("search_params"),
            search_type=data.get("search_type"),
            template_mode=data.get("template_mode"),
        )
    except FilterExpressionError as exc:
        return _json_error(f"invalid filter expression: {exc}", status=400)
    except Exception as exc:
        logger.exception("Async query failed")
        return _json_error(f"query failed: {exc}", status=500)
    return web.json_response(response.model_dump())


async def handle_transform(request: web.Request) -> web.Response:
    """Stateless core transform: context in the request, no index involved."""
    try:
        data = await request.json()
    except Exception:
        return _json_error("invalid JSON body")
    question = (data or {}).get("question", "")
    context = (data or {}).get("context") or (data or {}).get("sources") or []
    if not question or not context:
        return _json_error("need 'question' and 'context'")

    vt = await asyncio.to_thread(_get_transform)
    try:
        response = await vt.transform_async(question=question, context=context)
    except Exception as exc:
        logger.exception("Transform failed")
        return _json_error(f"transform failed: {exc}", status=500)
    return web.json_response(response.model_dump())


_transform_cache: tuple[Any, Any] | None = None  # (llm identity, VerbatimTransform)


def _get_transform():
    """Cached stateless transform pipeline.

    Building it per request re-initializes an entire encoder parameter tree
    on device (the offline extractor) — cache one instance like the other
    deps singletons, invalidating only if the LLM client identity changes.
    """
    global _transform_cache
    from verbatim_rag_tpu_torch.core.templates import TemplateManager
    from verbatim_rag_tpu_torch.core.transform import VerbatimTransform

    llm = deps.get_llm_client()
    if _transform_cache is not None and _transform_cache[0] is llm:
        return _transform_cache[1]
    vt = VerbatimTransform(
        llm_client=llm,
        extractor=None if llm else _offline_extractor(),
        template_manager=TemplateManager(
            llm_client=llm, default_mode="contextual" if llm else "static"
        ),
    )
    _transform_cache = (llm, vt)
    return vt


def _offline_extractor():
    from verbatim_rag_tpu_torch.models.highlighter import ModelSpanExtractor

    return ModelSpanExtractor(device=deps.get_device())


async def handle_query_stream(request: web.Request) -> web.StreamResponse:
    config = deps.get_config()
    try:
        data = await request.json()
    except Exception:
        return _json_error("invalid JSON body")
    question = _validate_question(data, config.max_question_length)
    if question is None:
        return _json_error("invalid question")
    err = _validate_search_type(data)
    if err:
        return err
    # Parse string filters BEFORE the stream starts: a client mistake must
    # surface as the same 400 the non-streaming routes return, not as a
    # mid-stream error event that a Retry would resubmit verbatim.
    if isinstance(data.get("filter"), str):
        from verbatim_rag_tpu_torch.engine.filters import parse_filter_expr

        try:
            parse_filter_expr(data["filter"])
        except FilterExpressionError as exc:
            return _json_error(f"invalid filter expression: {exc}", status=400)

    from verbatim_rag_tpu_torch.rag.streaming import StreamingRAG

    stream = StreamingRAG(await asyncio.to_thread(deps.get_rag))
    response = web.StreamResponse(
        status=200,
        headers={
            "Content-Type": "application/x-ndjson",
            "Cache-Control": "no-cache",
            "X-Accel-Buffering": "no",  # anti-buffering (parity: api/app.py:352-402)
            "Connection": "keep-alive",
            # CORS must be set BEFORE prepare() transmits the headers — the
            # middleware's post-handler update is a no-op on a prepared
            # stream, and a cross-origin frontend would block the NDJSON.
            **_cors_headers(request),
        },
    )
    await response.prepare(request)
    try:
        async for event in stream.stream_query(
            question,
            k=data.get("k"),
            filter=data.get("filter"),
            hybrid_weights=data.get("hybrid_weights"),
            rrf_k=data.get("rrf_k", 60),
            search_params=data.get("search_params"),
            search_type=data.get("search_type"),
            template_mode=data.get("template_mode"),
        ):
            await response.write((json.dumps(event) + "\n").encode())
    except Exception as exc:
        logger.exception("Streaming failed")
        await response.write(
            (json.dumps({"type": "error", "message": str(exc)}) + "\n").encode()
        )
    await response.write_eof()
    return response


# -- app factory ------------------------------------------------------------------------


def _cors_headers(request: web.Request) -> dict[str, str]:
    """Echo the request Origin when allowlisted (multi-origin configs would
    otherwise only ever emit the first origin, blocking the rest)."""
    origins = deps.get_config().cors_origins
    request_origin = request.headers.get("Origin")
    if not origins or "*" in origins:
        allow = "*"
    elif request_origin and request_origin in origins:
        allow = request_origin
    else:
        allow = origins[0]
    headers = {
        "Access-Control-Allow-Origin": allow,
        "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
        "Access-Control-Allow-Headers": "Content-Type, Authorization",
    }
    if allow != "*":
        # The ACAO value depends on the request Origin — shared caches must
        # not serve one origin's header to another.
        headers["Vary"] = "Origin"
    return headers


@web.middleware
async def cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        response = web.Response()
    else:
        try:
            response = await handler(request)
        except web.HTTPException as exc:
            # Error responses (404/405, handler-raised) must carry CORS
            # headers too, or browsers mask the real status from clients.
            exc.headers.update(_cors_headers(request))
            raise
    if not response.prepared:
        # Prepared streams set their CORS headers pre-prepare; updating an
        # already-transmitted header block would be a silent no-op.
        response.headers.update(_cors_headers(request))
    return response


async def _warmup_on_startup(app: web.Application) -> None:
    async def run():
        try:
            rag = await asyncio.to_thread(deps.get_rag)
            await asyncio.to_thread(rag.warmup)
            logger.info("warmup complete")
        except Exception as exc:
            logger.warning("startup warmup failed: %s", exc)

    # Fire and forget: the server accepts requests while compiles run.
    app["warmup_task"] = asyncio.create_task(run())


def create_app(static_dir: str | None = None, warmup: bool = True) -> web.Application:
    app = web.Application(middlewares=[cors_middleware])
    if warmup:
        app.on_startup.append(_warmup_on_startup)
    app.router.add_get("/api/status", handle_status)
    app.router.add_get("/api/documents", handle_documents)
    app.router.add_get("/api/templates", handle_templates)
    app.router.add_post("/api/query", handle_query)
    app.router.add_post("/api/query_async", handle_query_async)
    app.router.add_post("/api/query/async", handle_query_async)
    app.router.add_post("/api/transform/verbatim", handle_transform)
    app.router.add_post("/api/query/stream", handle_query_stream)
    app.router.add_post("/api/debug/trace", handle_debug_trace)
    if static_dir:
        app.router.add_static("/", static_dir, show_index=True)
    return app


def main() -> None:
    import os

    config = deps.get_config()
    logging.basicConfig(level=config.log_level)
    # Fails here, before the socket opens, on an unknown platform or with no GPU.
    logger.info("serving on %s", deps.get_device())
    frontend = os.path.join(os.path.dirname(__file__), "..", "..", "frontend")
    static_dir = frontend if os.path.isdir(frontend) else None
    web.run_app(create_app(static_dir=static_dir), host=config.host, port=config.port)


if __name__ == "__main__":
    main()
