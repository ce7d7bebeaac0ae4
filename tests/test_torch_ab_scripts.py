"""The port's A/B timing scripts on a machine without a GPU.

`scripts/torch_flash_ab.py` and `scripts/torch_table_ab.py` time kernels on
the card only: here each must refuse with exit code 2 and print no result.
The table script's ``--decompose`` variants are made by replacing exact
source text of the wgmma table walk (`table_walk`, which the section, v2 and
v1 kernels share), of the float32 walk (`fma_walk_kernel`) and of the
rescore (its tile, blocks an SM and slot loads); every pattern must still
be found in its kernel, or the variants would silently time the unchanged
kernels. `scripts/torch_sass_diff.py` compares two trees' SASS kernel by
kernel; its reading of a `cuobjdump -sass` listing is checked here on a
canned one.
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


#: Two kernels as `cuobjdump -sass` lists them (abridged).
_SASS = """
	code for sm_90a
		Function : _ZN43_GLOBAL__N__b2aa269b_10_section_cu_ce0ff00720section_wgmma_kernelILb1EEEvNS_10WalkParamsE
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
                                                                         /* 0x000fe40000000800 */
        /*0010*/              @!P0 BRA 0x120 ;                           /* 0x0000000000008947 */
        /*0020*/             @UP0 UTMALDG.2D [UR8], [UR4] ;              /* 0x00000008040075b4 */
        /*0030*/                   EXIT ;                                /* 0x000000000000794d */
		..........

		Function : _Z24bucket_v1_wgmma_kernel10WalkParams
        /*0000*/                   S2R R0, SR_TID.X ;                    /* 0x0000000000007919 */
        /*0010*/                   EXIT ;                                /* 0x000000000000794d */
"""


def test_sass_diff_reads_kernels_and_opcodes():
    spec = importlib.util.spec_from_file_location("sass_diff", ROOT / "scripts" / "torch_sass_diff.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    kernels = module.split_sass(_SASS)
    section = "_ZN43_GLOBAL__N__10_section_cu_ce0ff00720section_wgmma_kernelILb1EEEvNS_10WalkParamsE"
    assert list(kernels) == [section, "_Z24bucket_v1_wgmma_kernel10WalkParams"]  # the file's hash dropped
    assert module.opcodes(kernels[section]) == ["LDC", "BRA", "UTMALDG.2D", "EXIT"]
    assert module.opcodes(kernels["_Z24bucket_v1_wgmma_kernel10WalkParams"]) == ["S2R", "EXIT"]


def test_sass_diff_pairs_a_kernel_with_its_template_instance():
    """A kernel templated on the head dim in one tree is compared with the
    plain kernel of the other through ``--instance``; other names stay
    unpaired."""
    spec = importlib.util.spec_from_file_location("sass_diff", ROOT / "scripts" / "torch_sass_diff.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    # As `split_sass` leaves them: the namespace's hash dropped, its length
    # prefix (counted with the hash) kept.
    ns = "_ZN53_GLOBAL__N__22_flash_attention_bwd_cu_0a1b2c3d"
    plain = f"{ns}25flash_bwd_dq_wgmma_kernelE14CUtensorMap_stS0_S0_S0_PKfS2_PKiP13__nv_bfloat16iiif"
    d64 = f"{ns}25flash_bwd_dq_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_PKiP13__nv_bfloat16iiif"
    d32 = d64.replace("ILi64E", "ILi32E")
    base = {plain: ["a"], "_Z5otheri": ["b"]}
    tree = {d64: ["a"], d32: ["c"], "_Z5otheri": ["b"]}
    assert module.pair_instances(base, tree, "ILi64E") == {d64: plain}
    assert module.pair_instances(tree, base, "ILi64E") == {plain: d64}
    assert module.pair_instances(base, tree, "") == {}
