"""The build report of `chip_smoke.py`: registers, spills and SASS counts.

The GPU machine's `nvcc -Xptxas -v` log and `cuobjdump -sass` listing are
parsed into one line per kernel; the build phase fails when a bf16 flash
kernel spills, holds no wgmma (HGMMA) or TMA load (UTMALDG), or still holds
an mma.sync (HMMA). Here the parsers run on sample text and a stand-in
`cuobjdump`, so a change of format on the card's toolkit shows up as a test
failure rather than as a check that passes on nothing.
"""

from __future__ import annotations

import stat
import sys

import pytest

import chip_smoke
from verbatim_rag_tpu_torch.ops import cuda_build

NS = "_GLOBAL__N__a514531_18_flash_attention_cu_2c138979"
FWD = f"_ZN{len(NS)}{NS}22flash_fwd_wgmma_kernelE14CUtensorMap_stS0_S0_PKiP13__nv_bfloat16Pfiiif"
F32 = f"_ZN{len(NS)}{NS}16flash_fwd_kernelILb1EEEvPKfS2_S2_PKiPfS4_S4_S4_iiiiif"
PARTIAL = f"_ZN{len(NS)}{NS}24flash_partial_mma_kernelEPK13__nv_bfloat16S2_S2_PKiPfS4_S4_iiiif"

PTXAS_LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{F32}' for 'sm_90a'
ptxas info    : Function properties for {F32}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 155 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    48 bytes stack frame, 60 bytes spill stores, 64 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 48 bytes cumulative stack size
"""

SASS = f"""
	code for sm_90a
		Function : {FWD}
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], RZ, !UPT ;
        /*0120*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR16], R88 ;
		Function : {PARTIAL}
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""


@pytest.mark.parametrize(
    "mangled,name",
    [(FWD, "flash_fwd_wgmma_kernel"), (F32, "flash_fwd_kernelILb1E"),
     (PARTIAL, "flash_partial_mma_kernel"), ("_Z12plain_kerneli", "plain_kernel")],
)
def test_kernel_name_reads_length_prefixed_symbols(mangled, name):
    assert chip_smoke.kernel_name(mangled) == name


def test_ptxas_report_gives_registers_and_spills_per_kernel():
    assert chip_smoke.ptxas_report(PTXAS_LOG) == {
        "flash_fwd_kernelILb1E": {"registers": 155, "spill_bytes": 0},
        "flash_fwd_wgmma_kernel": {"registers": 168, "spill_bytes": 124},
    }


def test_sass_counts_with_a_stand_in_cuobjdump(tmp_path, monkeypatch):
    cuda_home = tmp_path / "cuda"
    (cuda_home / "bin").mkdir(parents=True)
    for tool, body in (
        ("nvcc", "import sys; sys.exit(1)\n"),
        ("cuobjdump", f"import sys; assert sys.argv[1] == '-sass'; print({SASS!r})\n"),
    ):
        path = cuda_home / "bin" / tool
        path.write_text(f"#!{sys.executable}\n{body}")
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(cuda_home))
    assert cuda_build._nvcc() == str(cuda_home / "bin" / "nvcc")
    counts = chip_smoke.sass_counts(tmp_path / "lib.so")
    assert counts == {
        "flash_fwd_wgmma_kernel": {"HGMMA": 2, "UTMALDG": 1, "HMMA": 0},
        "flash_partial_mma_kernel": {"HGMMA": 0, "UTMALDG": 0, "HMMA": 1},
    }
