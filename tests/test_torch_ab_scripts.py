"""The port's A/B timing scripts on a machine without a GPU.

`scripts/torch_flash_ab.py` and `scripts/torch_table_ab.py` time kernels on
the card only: here each must refuse with exit code 2 and print no result.
The table script's ``--decompose`` variants are made by replacing exact
source text of the wgmma table walk (`table_walk`, which the section, v2 and
v1 kernels share); every pattern must still be found in it, or the variants
would silently time the unchanged kernels.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("script", ["torch_flash_ab.py", "torch_table_ab.py"])
def test_ab_script_refuses_without_a_gpu(script):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / script)], capture_output=True, text=True,
        timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == "" and "no CUDA device" in proc.stderr


def test_table_ab_variant_patterns_match_the_kernel_source():
    spec = importlib.util.spec_from_file_location("table_ab", ROOT / "scripts" / "torch_table_ab.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    source = (ROOT / "verbatim_rag_tpu_torch" / "csrc" / "section.cu").read_text()
    kernel = source[source.index("void table_walk(") : source.index("section_wgmma_kernel(const")]
    for name, subs in module.VARIANTS.items():
        for old in subs:
            assert old in kernel, name
