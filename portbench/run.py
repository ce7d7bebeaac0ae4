"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration file, its traffic file (``traffic/<mix>.json``),
its limits (``limits/<cell>.json``) and its metrics are found by name from
``BENCHMARK.json``; the driver is ``drivers/<config's driver>.py`` and each
per-layer metric is read by ``metrics/<metric>.py``. The run builds the cell
from the seed, warms it up, drives it in a closed loop for ``--seconds``,
checks what the window produced against the plain reference and prints one
JSON line. ``--trace 1`` profiles the window and prints the per-layer
metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import time

START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))


def load_cell(workload: str) -> dict:
    """The cell's entries and files, by name from ``BENCHMARK.json``."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return dict(
        cell=cell,
        cfg=json.loads((ROOT / config["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((BENCH / "limits" / f"{workload}.json").read_text())["limits"],
        end_to_end=mine(spec["end_to_end"]),
        per_layer=mine(spec["per_layer"]),
    )


def load_metric(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Launches:
    """Records the flash forward's and the rescore's launches in the window
    (shapes, lengths, window, candidate rows) by wrapping the two entries
    the program calls them through; :meth:`close` puts them back."""

    def __init__(self):
        from verbatim_rag_tpu_torch.models import encoder
        from verbatim_rag_tpu_torch.ops import rescore

        self.flash, self.rescore = [], []
        self._saved = [(encoder, "flash_attention"), (rescore, "exact_rescore_dispatch")]
        self._saved = [(m, a, getattr(m, a)) for m, a in self._saved]
        flash, resc = self._saved[0][2], self._saved[1][2]

        def flash_attention(q, k, v, lengths, window=None):
            self.flash.append((tuple(q.shape), lengths, window))
            return flash(q, k, v, lengths, window)

        def exact_rescore_dispatch(cand, sp_ids, sp_w, q_ids, q_w):
            self.rescore.append((cand, sp_ids, sp_w, int(q_ids.shape[1])))
            return resc(cand, sp_ids, sp_w, q_ids, q_w)

        encoder.flash_attention = flash_attention
        rescore.exact_rescore_dispatch = exact_rescore_dispatch

    def close(self) -> None:
        for module, attr, fn in self._saved:
            setattr(module, attr, fn)


class FullCollections:
    """Milliseconds of the interpreter's generation-2 collections."""

    def __init__(self):
        self.ms, self.count, self._t = 0.0, 0, []
        gc.callbacks.append(self._on)

    def _on(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t.append(time.perf_counter())
        elif self._t:
            self.ms += (time.perf_counter() - self._t.pop()) * 1e3
            self.count += 1

    def close(self) -> None:
        gc.callbacks.remove(self._on)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda", cell=None,
             driver_args=None) -> dict:
    """One run: set-up, warm-up, the window, the check. ``cell`` replaces
    what :func:`load_cell` would read (the CPU tests pass small sizes)."""
    import numpy as np
    import torch

    from portbench.harness import common
    from portbench.harness.trace import Trace

    cell = cell or load_cell(workload)
    driver_mod = importlib.import_module(f"portbench.drivers.{cell['cfg']['driver']}")
    spans = common.Spans(device, timed=trace)
    driver = driver_mod.Driver(cell["cfg"], cell["traffic"], seed, device, spans, **(driver_args or {}))
    driver.setup()
    driver.warm()
    common.sync(device)
    launches = Launches() if trace else None
    collections = FullCollections()
    attempted = failed = 0
    latencies = []
    tracer = Trace(trace)
    try:
        with tracer:
            with tracer.window():
                t_start = time.perf_counter()
                setup_s = time.time() - START
                i = 0
                while True:
                    t0 = time.perf_counter()
                    a, f = driver.call(i)
                    t1 = time.perf_counter()
                    latencies.append((t1 - t0) * 1e3)
                    attempted, failed, i = attempted + a, failed + f, i + 1
                    if t1 - t_start >= seconds:
                        break
                window_s = t1 - t_start
    finally:
        if launches is not None:
            launches.close()
        collections.close()
    print(
        f"portbench: window {window_s:.3f} s, {i} calls, call ms median {np.median(latencies):.2f} "
        f"max {max(latencies):.2f}, {collections.count} full collections {collections.ms:.1f} ms",
        file=sys.stderr,
    )
    peak = int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0
    result = dict(correct=False, attempted=attempted, failed=failed, metrics={})
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    if trace:
        summary = tracer.summary()
        record = dict(
            window_s=window_s, busy_s=summary["busy_s"], ops=summary["ops"], spans=spans.ms,
            counts=spans.counts, calls=i, flash=launches.flash, rescore=launches.rescore,
            gc_full_ms=collections.ms, tracer=tracer, **driver.layer_record(),
        )
        for m in cell["per_layer"]:
            value = load_metric(m["name"]).read(record)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
        result["busy_s"], result["window_s"] = summary["busy_s"], window_s
        del record, summary
        launches.flash.clear()
        launches.rescore.clear()
    else:
        e2e = driver.end_to_end(window_s, attempted)
        e2e.update(
            search_p95_ms=float(np.percentile(latencies, 95)),
            device_peak_gb=peak / 1e9,
            setup_s=setup_s,
        )
        for m in cell["end_to_end"]:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": units[m["name"]]}
    result["memory_peak_bytes"] = peak
    driver.release()
    numbers = driver.check()
    result["correct"], result["checks"] = common.judge(numbers, cell["limits"])
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    import torch

    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); none or too few here", file=sys.stderr)
        return 2
    import verbatim_rag_tpu_torch

    if not Path(verbatim_rag_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"portbench: the program is not in this checkout ({ROOT})", file=sys.stderr)
        return 2

    from portbench.harness import common

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", cell)
    found = common.loaded_forbidden()
    if found:
        print(f"portbench: modules that may not be loaded are: {', '.join(found)}", file=sys.stderr)
        return 3
    info = common.device_info(chips)
    info["memory_peak_bytes"] = result.pop("memory_peak_bytes")
    if args.trace:
        info["busy_s"], info["window_s"] = result.pop("busy_s"), result.pop("window_s")
    checks = result.pop("checks")
    line = dict(result, device=info, checks=checks)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
