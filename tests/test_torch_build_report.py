"""The build report of `chip_smoke.py`: registers, spills and SASS counts.

The GPU machine's `nvcc -Xptxas -v` log and `cuobjdump -sass` listing are
parsed into one line per kernel; the build phase fails when a wgmma kernel
(the bf16 flash forward, partial and backward; the table walk's section and
bucket-max v2 kernels on int8 and bf16 rows and its v1 kernel on bf16 rows)
spills, holds no wgmma (HGMMA, or IGMMA on int8) or TMA load (UTMALDG), or
still holds an mma.sync (HMMA, IMMA), and when any kernel of the section
library holds an mma.sync; and when the float32 table walk (its three
modes) holds a tensor-core instruction or no TMA load, or spills, or the
rescore kernel spills. Here the parsers and the
check run on sample text and a stand-in `cuobjdump`, so a change of format on
the card's toolkit shows up as a test failure rather than as a check that
passes on nothing.
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
PARTIAL_WGMMA = f"_ZN{len(NS)}{NS}26flash_partial_wgmma_kernelE14CUtensorMap_stS0_S0_PKiPfS3_S3_iiiif"
BWD = "_GLOBAL__N__9e1f20aa_22_flash_attention_bwd_cu_41c3d5e7"
BWD_DQ_D32 = f"_ZN{len(BWD)}{BWD}25flash_bwd_dq_wgmma_kernelILi32EEEv14CUtensorMap_stS0_S0_S0_PKfS2_PKiP13__nv_bfloat16iiif"
SEC = "_GLOBAL__N__7c2e91d4_10_section_cu_5b0e1a7d"
V2_INT8 = f"_ZN{len(SEC)}{SEC}22bucket_v2_wgmma_kernelILb1EEEv14CUtensorMap_stS0_PKfS3_PKhPfPiiiiiii"
V2_BF16 = f"_ZN{len(SEC)}{SEC}22bucket_v2_wgmma_kernelILb0EEEv14CUtensorMap_stS0_PKfS3_PKhPfPiiiiiii"
FMA_V1 = f"_ZN{len(SEC)}{SEC}15fma_walk_kernelILi2EEEvNS_9FmaParamsE"
RES = "_GLOBAL__N__3f0b2c11_10_rescore_cu_9d2e7a40"
RESCORE_I32 = f"_ZN{len(RES)}{RES}14rescore_kernelIifEEvPKiPKT_PKT0_S3_PKfPfixiiii"
RESCORE_I16 = f"_ZN{len(RES)}{RES}14rescore_kernelIstEEvPKiPKT_PKT0_S3_PKfPfixiiii"

PTXAS_LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{F32}' for 'sm_90a'
ptxas info    : Function properties for {F32}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 155 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    48 bytes stack frame, 60 bytes spill stores, 64 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 48 bytes cumulative stack size
ptxas info    : Compiling entry function '{V2_INT8}' for 'sm_90a'
ptxas info    : Function properties for {V2_INT8}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 156 registers, used 2 barriers, 464 bytes cmem[0]
"""

SASS = f"""
	code for sm_90a
		Function : {FWD}
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], RZ, !UPT ;
        /*0120*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR16], R88 ;
		Function : {PARTIAL}
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
		Function : {V2_INT8}
        /*0100*/                   UTMALDG.2D [UR8], [UR4] ;
        /*0110*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR12], RZ, !UPT ;
"""


@pytest.mark.parametrize(
    "mangled,name",
    [(FWD, "flash_fwd_wgmma_kernel"), (F32, "flash_fwd_kernelILb1E"),
     (PARTIAL, "flash_partial_mma_kernel"), ("_Z12plain_kerneli", "plain_kernel"),
     (PARTIAL_WGMMA, "flash_partial_wgmma_kernel"), (V2_INT8, "bucket_v2_wgmma_kernelILb1E"),
     (V2_BF16, "bucket_v2_wgmma_kernelILb0E"), (FMA_V1, "fma_walk_kernelILi2E"),
     (RESCORE_I32, "rescore_kernel"), (BWD_DQ_D32, "flash_bwd_dq_wgmma_kernelILi32E")],
)
def test_kernel_name_reads_length_prefixed_symbols(mangled, name):
    assert chip_smoke.kernel_name(mangled) == name


def test_ptxas_report_gives_registers_and_spills_per_kernel():
    assert chip_smoke.ptxas_report(PTXAS_LOG) == {
        "flash_fwd_kernelILb1E": {"registers": 155, "spill_bytes": 0},
        "flash_fwd_wgmma_kernel": {"registers": 168, "spill_bytes": 124},
        "bucket_v2_wgmma_kernelILb1E": {"registers": 156, "spill_bytes": 0},
    }


def test_ptxas_report_merges_the_instances_of_a_template():
    """The rescore's four slot-type instances share one name: the report
    keeps the most registers and the most spilled bytes of any of them."""
    log = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers\n"
        for name, regs, spill in ((RESCORE_I32, 40, 0), (RESCORE_I16, 56, 8), (RESCORE_I32, 48, 0))
    )
    assert chip_smoke.ptxas_report(log) == {"rescore_kernel": {"registers": 56, "spill_bytes": 16}}


def _stand_in_cuobjdump(tmp_path, monkeypatch, sass: str) -> None:
    cuda_home = tmp_path / "cuda"
    (cuda_home / "bin").mkdir(parents=True)
    for tool, body in (
        ("nvcc", "import sys; sys.exit(1)\n"),
        ("cuobjdump", f"import sys; assert sys.argv[1] == '-sass'; print({sass!r})\n"),
    ):
        path = cuda_home / "bin" / tool
        path.write_text(f"#!{sys.executable}\n{body}")
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(cuda_home))
    assert cuda_build._nvcc() == str(cuda_home / "bin" / "nvcc")


def test_sass_counts_with_a_stand_in_cuobjdump(tmp_path, monkeypatch):
    _stand_in_cuobjdump(tmp_path, monkeypatch, SASS)
    counts = chip_smoke.sass_counts(tmp_path / "lib.so")
    zero = dict.fromkeys(chip_smoke.SASS_OPS, 0)
    assert counts == {
        "flash_fwd_wgmma_kernel": {**zero, "HGMMA": 2, "UTMALDG": 1},
        "flash_partial_mma_kernel": {**zero, "HMMA": 1},
        "bucket_v2_wgmma_kernelILb1E": {**zero, "IGMMA": 1, "UTMALDG": 1},
    }


def _mangled(kernel: str) -> str:
    name, flag = kernel.split("IL") if "IL" in kernel else (kernel, "")
    return f"_ZN{len(SEC)}{SEC}{len(name)}{name}" + (f"IL{flag}" if flag else "") + "Ev"


def _wgmma_listing(mma_sync_in: str | None = None, fma_extra: str | None = None) -> str:
    """SASS of every kernel in `WGMMA_KERNELS`, each with a TMA load and a
    wgmma (IGMMA for the int8 v2 kernel), and of every `FMA_KERNELS` one,
    each with a TMA load and FFMAs; ``mma_sync_in`` also gets an IMMA, and
    the first float32 walk kernel ``fma_extra`` (an instruction line)."""
    lines = []
    for kernels in chip_smoke.WGMMA_KERNELS.values():
        for kernel in kernels:
            gmma = "IGMMA.64x128x32.S8.S8" if kernel.endswith("ILb1E") else "HGMMA.64x128x16.F32.BF16"
            lines += [f"\t\tFunction : {_mangled(kernel)}", "        UTMALDG.2D [UR8], [UR4] ;",
                      f"        {gmma} R24, gdesc[UR12], RZ, !UPT ;"]
            if kernel == mma_sync_in:
                lines.append("        IMMA.16832.S8.S8 R4, R8, R12, R4 ;")
    for i, kernel in enumerate(k for ks in chip_smoke.FMA_KERNELS.values() for k in ks):
        lines += [f"\t\tFunction : {_mangled(kernel)}", "        UTMALDG.2D [UR8], [UR4] ;",
                  "        FFMA R4, R8, R12, R4 ;"]
        if i == 0 and fma_extra:
            lines.append(f"        {fma_extra}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("mma_sync_in", [None, "bucket_v2_wgmma_kernelILb1E"])
def test_build_check_on_every_wgmma_kernel(tmp_path, monkeypatch, mma_sync_in):
    """The build check passes when every wgmma kernel, the int8 v2 kernel's
    IGMMA included, holds wgmma and TMA loads, and fails on an IMMA."""
    _stand_in_cuobjdump(tmp_path, monkeypatch, _wgmma_listing(mma_sync_in))
    if mma_sync_in is None:
        result = chip_smoke.check_build({})
        kernels = {**chip_smoke.WGMMA_KERNELS, **{"fma": chip_smoke.FMA_KERNELS["section"]}}
        assert set(result) == {k for ks in kernels.values() for k in ks}
        assert result["fma_walk_kernelILi0E"]["sass"]["UTMALDG"] == 1
        assert result["bucket_v2_wgmma_kernelILb1E"]["sass"]["IGMMA"] == 1
    else:
        with pytest.raises(SystemExit, match="mma.sync left"):
            chip_smoke.check_build({})


def test_build_check_refuses_mma_sync_anywhere_in_the_section_library(tmp_path, monkeypatch):
    """A kernel of the section library outside `WGMMA_KERNELS` and
    `FMA_KERNELS` that holds an mma.sync fails the build check too."""
    other = f"_ZN{len(SEC)}{SEC}12other_kernelEv"
    clean = _wgmma_listing() + f"\t\tFunction : {other}\n        FFMA R4, R8, R12, R4 ;\n"
    _stand_in_cuobjdump(tmp_path / "clean", monkeypatch, clean)
    assert "other_kernel" not in chip_smoke.check_build({})
    _stand_in_cuobjdump(tmp_path / "hmma", monkeypatch, clean + "        HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n")
    with pytest.raises(SystemExit, match="mma.sync left in the section library"):
        chip_smoke.check_build({})


@pytest.mark.parametrize(
    "extra,refusal",
    [
        ("HGMMA.64x128x8.F32.TF32 R24, gdesc[UR12], RZ, !UPT ;", "tensor-core instruction"),
        ("HMMA.1684.F32.TF32 R4, R8, R12, R4 ;", "mma.sync left in the section library"),
    ],
)
def test_build_check_refuses_tensor_cores_in_the_float32_walk(tmp_path, monkeypatch, extra, refusal):
    """The float32 walk must stay on the CUDA cores (never TF32): a wgmma or
    an mma.sync in it fails the build check."""
    _stand_in_cuobjdump(tmp_path, monkeypatch, _wgmma_listing(fma_extra=extra))
    with pytest.raises(SystemExit, match=refusal):
        chip_smoke.check_build({})


def test_build_check_refuses_a_float32_walk_without_tma_or_with_spills(tmp_path, monkeypatch):
    """The float32 walk takes its rows by TMA and spills nothing; the rescore
    kernel spills nothing either."""
    no_tma = _wgmma_listing().replace(
        f"Function : {_mangled('fma_walk_kernelILi1E')}\n        UTMALDG.2D [UR8], [UR4] ;\n",
        f"Function : {_mangled('fma_walk_kernelILi1E')}\n",
    )
    _stand_in_cuobjdump(tmp_path / "no_tma", monkeypatch, no_tma)
    with pytest.raises(SystemExit, match="no TMA load"):
        chip_smoke.check_build({})
    _stand_in_cuobjdump(tmp_path / "spill", monkeypatch, _wgmma_listing())
    for mangled in (FMA_V1, RESCORE_I16):
        log = (
            f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
            "ptxas info    : Used 168 registers\n"
        )
        with pytest.raises(SystemExit, match="spills"):
            chip_smoke.check_build({"section": log})
