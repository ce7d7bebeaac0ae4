"""Readings from which a cell's limits are set: the compared numbers of the
program over many seeds (each a set-up and a short window) and of the
control over a few.

    python3 portbench/control.py --workload <name> --seeds 1 2 ... --control-seeds 1 2 3 \
        --seconds 2 [--vary-content] [--out control.json]

The control is one precision below the configuration's bf16 operands: for
the RAG cells the float32 reference with every matmul operand rounded
through float8 e4m3 (one scale a tensor) in the program's place; for the
hybrid cell the program's own int8 tier (dense and sketch rows int8, the
same exact-selection program). Each control's numbers go through the
harness's own comparison (``common.judge``) against the cell's limits, and
its ``correct`` is printed: it has to come out false. The benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))

from portbench import run  # noqa: E402
from portbench.harness import common  # noqa: E402

#: The hybrid cell's control: the store's int8 tier on the same program.
INT8_TIER = {"dense_dtype": "int8", "sketch_dtype": "int8", "candidate_impl": "xla"}


def program_readings(workload: str, seed: int, seconds: float, device, cell, vary_content=False) -> dict:
    """The program's compared numbers; with ``vary_content`` a RAG cell's
    corpus and weights come from the seed too, in place of the traffic's
    ``content_seed``."""
    t0 = time.time()
    args = {"content_seed": seed} if vary_content else None
    result = run.run_cell(workload, seed, seconds, False, device, cell, args)
    return dict(seed=seed, correct=result["correct"], attempted=result["attempted"],
                numbers={k: v["value"] for k, v in result["checks"].items()},
                seconds=time.time() - t0)


def control_readings(workload: str, seed: int, seconds: float, device, cell) -> dict:
    """The control's compared numbers and the ``correct`` that the harness's
    comparison gives them."""
    if cell["cfg"]["driver"] == "hybrid":
        result = run.run_cell(workload, seed, seconds, False, device, cell, {"store_args": INT8_TIER})
        numbers = {k: v["value"] for k, v in result["checks"].items()}
    else:
        from portbench.drivers.rag import Driver

        numbers = Driver(cell["cfg"], cell["traffic"], seed, device, common.Spans(device, False)).control()
    correct, _ = common.judge(numbers, cell["limits"])
    return dict(seed=seed, correct=correct, numbers=numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--vary-content", action="store_true",
                    help="RAG cells: the program's corpus and weights from each seed, not the traffic's content_seed")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    out = dict(workload=args.workload, program=[], control=[])
    for seed in args.seeds:
        out["program"].append(program_readings(args.workload, seed, args.seconds, "cuda", cell, args.vary_content))
        print(json.dumps(out["program"][-1]), flush=True)
    for seed in args.control_seeds:
        out["control"].append(control_readings(args.workload, seed, args.seconds, "cuda", cell))
        print(json.dumps(out["control"][-1]), flush=True)
    for name in cell["limits"]:
        lower = max((p["numbers"][name] for p in out["program"]), default=None)
        upper = min((c["numbers"][name] for c in out["control"]), default=None)
        print(f"{name}: program max {lower!r}, control min {upper!r}, limit {cell['limits'][name]!r}")
    for c in out["control"]:
        print(f"control seed {c['seed']}: correct {c['correct']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
