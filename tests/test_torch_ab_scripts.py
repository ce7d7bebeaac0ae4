"""The port's A/B timing scripts on a machine without a GPU.

`scripts/torch_flash_ab.py` and `scripts/torch_table_ab.py` time kernels on
the card only: here each must refuse with exit code 2 and print no result.
The table script's ``--decompose`` variants are made by replacing exact
source text of the wgmma table walk (`table_walk`, which the section, v2 and
v1 kernels share), of the float32 walk (`fma_walk_kernel`) and of the
rescore (its tile, blocks an SM and slot loads); every pattern must still
be found in its kernel, or the variants would silently time the unchanged
kernels.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("script", ["torch_flash_ab.py", "torch_table_ab.py", "torch_train_mesh_cards.py"])
def test_ab_script_refuses_without_a_gpu(script):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / script)], capture_output=True, text=True,
        timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == "" and "no CUDA device" in proc.stderr


def _table_ab():
    spec = importlib.util.spec_from_file_location("table_ab", ROOT / "scripts" / "torch_table_ab.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_table_ab_variant_patterns_match_the_kernel_source():
    module = _table_ab()
    source = (ROOT / "verbatim_rag_tpu_torch" / "csrc" / "section.cu").read_text()
    walks = (
        source[source.index("void table_walk(") : source.index("section_wgmma_kernel(const")],
        source[source.index("fma_walk_kernel(const") : source.index("struct FmaArgs")],
    )
    for name, subs in module.VARIANTS.items():
        # Each variant cuts both walks: every pattern is found once, in one of them.
        assert sum(old in walk for old in subs for walk in walks) == len(subs), name
        for walk in walks:
            assert sum(old in walk for old in subs) == len(subs) // 2, name
        for old in subs:
            assert source.count(old) == 1, name


def test_table_ab_rescore_variants_match_the_kernel_source():
    """Each rescore variant replaces text found once in `csrc/rescore.cu`
    (its tile, its blocks an SM, its slot loads) with something else."""
    module = _table_ab()
    source = (ROOT / "verbatim_rag_tpu_torch" / "csrc" / "rescore.cu").read_text()
    for name, subs in module.RESCORE_VARIANTS.items():
        for old, new in subs.items():
            assert source.count(old) == 1 and old != new, name
    assert {next(iter(subs)) for subs in module.RESCORE_VARIANTS.values()} == {
        module._TILE, module._BLOCKS, module._SLOT
    }
