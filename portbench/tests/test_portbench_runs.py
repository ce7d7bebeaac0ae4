"""Whole runs in their own processes: each driver at a small size on the
CPU loads no module of JAX or of the JAX package; the command refuses to
run without a card; the control reads above the program, and the
harness's comparison judges it not correct."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import control
from portbench.tests import cells

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import run
from portbench.harness import common
from portbench.tests import cells
cell = {make}
result = run.run_cell(cell["cell"]["name"], 2**31 + 21, 0.5, False, "cpu", cell)
print(json.dumps(dict(correct=result["correct"], loaded=sorted(sys.modules), forbidden=common.loaded_forbidden())))
"""


@pytest.mark.parametrize("make", ["cells.tiny_hybrid()", "cells.tiny_rag('burst64')", "cells.tiny_rag('longdocs16')"])
def test_driver_process_loads_no_jax(make):
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT), make=make)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert line["forbidden"] == []
    tops = {name.split(".")[0] for name in line["loaded"]}
    assert not tops & {"jax", "jaxlib", "flax", "verbatim_rag_tpu"}
    assert "verbatim_rag_tpu_torch" in tops


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hybrid-1m-bf16.b512", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_rag_control_reads_above_the_program():
    cell = cells.tiny_rag()
    program = control.program_readings(cell["cell"]["name"], 2**31 + 31, 0.5, "cpu", cell)["numbers"]
    control_run = control.control_readings(cell["cell"]["name"], 2**31 + 31, 0.5, "cpu", cell)
    low = control_run["numbers"]
    for name in ("dense_gap", "splade_gap", "prob_gap", "retrieval_miss", "order_miss"):
        assert low[name] > 3 * program[name], (name, low[name], program[name])
    assert control_run["correct"] is False


def test_hybrid_control_reads_above_the_program():
    cell = cells.tiny_hybrid()
    program = control.program_readings(cell["cell"]["name"], 41, 0.5, "cpu", cell)["numbers"]
    control_run = control.control_readings(cell["cell"]["name"], 41, 0.5, "cpu", cell)
    low = control_run["numbers"]
    assert low["top_miss"] > program["top_miss"] and low["order_miss"] > program["order_miss"]
    assert control_run["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("make", ["hybrid", "burst64"])
def test_small_cells_on_the_card(cuda_device, make):
    from portbench import run

    cell = cells.tiny_hybrid() if make == "hybrid" else cells.tiny_rag(make)
    result = run.run_cell(cell["cell"]["name"], 2**31 + 51, 1.0, True, cuda_device, cell)
    assert result["correct"], result["checks"]
    assert result["busy_s"] > 0
