"""Time the PyTorch port's bucket-table kernels of one source tree on the card.

    python3 scripts/torch_table_ab.py [--tree DIR] [--label NAME] [--seed 0]
        [--cases int8,bfloat16,float32,rescore] [--decompose]

Imports `verbatim_rag_tpu_torch` from DIR (default: the checkout holding this
script), builds its `csrc/section.cu` and `csrc/rescore.cu` into
DIR/build/kernels, and times the cases named by ``--cases`` (all four by
default), at B=512 queries:

- the section kernel on int8 and on bf16 rows at the int8 store's serving
  point (N=1,007,616 unit-norm rows, blocks of 8192; the dense arm d=384 and
  the sketch arm d=768 in one call, 1% of the rows masked);
- bucket-max v1 on bf16 rows at `chip_smoke.py`'s bucket_ab shapes
  (N=999,424 normal rows, d=384 and 768, every row live);
- controls: bucket-max v2 on the same int8 arms (one launch each) and on the
  same bf16 rows;
- float32 rows (the FMA walk): the section kernel at the serving point
  (both arms, as above), v1 and v2 at N=999,424 normal rows, d=384 and 768;
- the exact rescore at `chip_smoke.py`'s serving point (B=512, C=256,
  m=128, qm=32 over 1M rows), int32/float32 and int16/float16 slots, by
  CUDA events around calls (``ms``, as every case) and by its device time
  from `torch.profiler` (``device_ms``, with the records it rests on: the
  wrapper's host time comes close to the kernel's), also with the same
  candidates folded onto the first 16,384 rows, so that every row is in L2;
- yardsticks: the product alone, `torch._int_mm` (int8) or `torch.mm` (bf16,
  float32) of the prepared queries against the rows: the same products
  without the bucket reduction, so not the same function. The rescore has
  none.

Beside each time it prints the bound (the larger of the bytes the function
must move over 3.35 TB/s and its operations over 1,979 TOP/s int8 or 989
TFLOP/s bf16 or 67 TFLOP/s float32, as `chip_smoke.py` counts them). With
``--decompose`` (a tree whose int8 / bf16 tables run on the wgmma walk,
`table_walk`, and float32 tables on the TMA-fed FMA walk, `fma_walk_kernel`)
it also builds three variants of both walks from the tree's source and times
every case on them: without the row loads (the producer only signals),
without the per-position epilogue, and with neither, which says how much of
the time the stream, the products and the epilogue each hold; and the
rescore built with one of its design choices undone (`RESCORE_VARIANTS`:
tiles of 32, 128 and 256 candidates a block instead of 64, 6 blocks an SM
instead of 8, predicated slot loads), as ``device_ms_<variant>``. Prints
one JSON line; needs one GPU.

An A/B of two trees in one call, on one card, as for `torch_flash_ab.py`:

    git archive <parent> | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 scripts/torch_table_ab.py --tree $t; done
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

#: Text substitutions that make the decomposition variants of the wgmma walk
#: (`table_walk` in `csrc/section.cu`, shared by section, v2 and v1).
_EPILOGUE = "    {  // Position p's epilogue on the drained accumulator."
_LOAD = """          mbar_arrive_expect_tx(&full[s], stage_bytes);
          tma_load_rows(stage, &arm.x_map, &full[s], c * kChunk, static_cast<int>(row0));
          if (streamed)
            tma_load_rows(stage + kWalkStageBytes, &arm.q_map, &full[s], c * kChunk, q0);"""
#: Without the epilogue, one accumulator value is still read: products whose
#: results nothing reads are dead code that ptxas may drop.
_NO_EPILOGUE = (
    "    if (acc[0] == static_cast<Acc>(-12345)) arm.out[0] = 0.f;\n"
    "    if (p < 0) {"
)
#: The same cuts of the float32 walk (`fma_walk_kernel`): the producer
#: signals each stage without copying rows or queries into it, and the
#: per-position epilogue (mask, fold or lane reduction) is skipped.
_FMA_EPILOGUE = "    {  // Position p's epilogue: the mask, then the fold (section, v2) or reduction (v1)."
_FMA_LOAD = """          mbar_arrive_expect_tx(&full[s], kFmaStageBytes);
          tma_load_rows(stage, &arm.x_map, &full[s], c * 32, row0);
          tma_load_rows(stage + kFmaHalfStage, &arm.q_map, &full[s], c * 32, q0);"""
#: Every accumulator is read (a sum), or the compiler drops the FMAs of the
#: ones nothing reads.
_FMA_NO_EPILOGUE = (
    "    float sink = 0.f;\n"
    "#pragma unroll\n"
    "    for (int a = 0; a < 64; ++a) sink += acc[a / 8][a % 8];\n"
    "    if (sink == -12345.f) arm.out[0] = 0.f;\n"
    "    if (p < 0) {"
)
_FMA_NO_LOAD = "          (void)stage;\n          mbar_arrive(&full[s]);"
_WALK_NO_LOAD = "          (void)stage;\n          (void)streamed;\n          mbar_arrive(&full[s]);"
VARIANTS = {
    "no_row_loads": {_LOAD: _WALK_NO_LOAD, _FMA_LOAD: _FMA_NO_LOAD},
    "no_epilogue": {_EPILOGUE: _NO_EPILOGUE, _FMA_EPILOGUE: _FMA_NO_EPILOGUE},
    "products_only": {
        _LOAD: _WALK_NO_LOAD, _EPILOGUE: _NO_EPILOGUE,
        _FMA_LOAD: _FMA_NO_LOAD, _FMA_EPILOGUE: _FMA_NO_EPILOGUE,
    },
}
#: Variants of the rescore (`csrc/rescore.cu`) that undo one design choice
#: each: other tiles than its 64 candidates a block; 6 blocks an SM (40
#: registers) instead of 8 (32 registers); a lane's slot loads predicated on
#: the row's end instead of repeating its last slot.
_TILE = "constexpr int kTile = 64;"
_BLOCKS = "__global__ void __launch_bounds__(kThreads, 8)"
_SLOT = """            const int s = min(s0 + 32 * i, m - 1);
            const bool live = rows[u] >= 0;  // uniform across the warp"""
RESCORE_VARIANTS = {
    **{f"tile_{t}": {_TILE: f"constexpr int kTile = {t};"} for t in (32, 128, 256)},
    "six_blocks": {_BLOCKS: "__global__ void __launch_bounds__(kThreads, 6)"},
    "predicated_slots": {_SLOT: """            const int s = s0 + 32 * i;
            const bool live = rows[u] >= 0 && s < m;"""},
}


def _smoke():
    """`chip_smoke.py` of this checkout, for its timing, bound and input helpers."""
    spec = importlib.util.spec_from_file_location("_chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_variants(tree: Path, cuda_build, kernel: str, variants: dict) -> dict:
    """``{name: ctypes library}`` of ``variants`` (name → substitutions),
    compiled in parallel from the tree's `csrc/<kernel>.cu` (the first match
    of each pattern is replaced, every pattern must be found)."""
    csrc = tree / "verbatim_rag_tpu_torch" / "csrc"
    source = (csrc / f"{kernel}.cu").read_text()
    out = tree / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in variants.items():
        text = source
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"torch_table_ab: {name}: the {kernel} source has changed")
            text = text.replace(old, new, 1)
        src = csrc / f"_variant_{name}.cu"  # beside hopper.cuh, which it includes
        src.write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), src)
    libs = {}
    for name, (proc, src) in jobs.items():
        log, _ = proc.communicate()
        src.unlink()
        if proc.returncode:
            raise SystemExit(f"torch_table_ab: variant {name} failed to build:\n{log[-2000:]}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(HERE))
    parser.add_argument("--label", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cases", default="int8,bfloat16,float32,rescore")
    parser.add_argument("--decompose", action="store_true")
    args = parser.parse_args()
    cases = set(args.cases.split(","))
    if not cases <= {"int8", "bfloat16", "float32", "rescore"}:
        raise SystemExit(f"torch_table_ab: unknown cases {sorted(cases)}")

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("torch_table_ab: no CUDA device\n")
        raise SystemExit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    tree = Path(args.tree).resolve()
    os.environ["VERBATIM_TORCH_BUILD_DIR"] = str(tree / "build" / "kernels")
    sys.path.insert(0, str(tree))
    from verbatim_rag_tpu_torch.ops import cuda_build
    from verbatim_rag_tpu_torch.ops import fused_topk as ft
    from verbatim_rag_tpu_torch.ops import rescore as rs
    from verbatim_rag_tpu_torch.ops import section as sec

    assert Path(ft.__file__).resolve().is_relative_to(tree), ft.__file__
    smoke = _smoke()
    cuda_build.build_all(("section", "rescore"))
    tables = cases & {"int8", "bfloat16", "float32"}
    variants = build_variants(tree, cuda_build, "section", VARIANTS) if args.decompose and tables else {}
    rescore_variants = {}
    if args.decompose and "rescore" in cases:
        rescore_variants = build_variants(tree, cuda_build, "rescore", RESCORE_VARIANTS)
    load = cuda_build.load

    def timed(fn, reps=10):
        return smoke.cuda_ms(fn, reps=reps)

    def variant_times(fn):
        times = {}
        for name, lib in variants.items():
            cuda_build.load = lambda _name, lib=lib: lib
            try:
                times[name] = timed(fn)
            finally:
                cuda_build.load = load
        return times

    batch = 512
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = dict(tree=args.label or str(tree), card=smoke.gpu_name_and_limit(), cases=[])

    def case(kernel, fn, ops, moved, peak, products=None, **info):
        b_ms, b_by = smoke.bound(moved, ops, peak)
        result["cases"].append(dict(
            kernel=kernel, **info, ms=timed(fn),
            products_ms=None if products is None else timed(products, reps=5),
            bound_ms=b_ms, bound_by=b_by, **variant_times(fn),
        ))

    # The serving point: section over both arms (measured), v2 per arm (control).
    n, block = 123 * 8192, 8192
    for dtype in ("int8", "bfloat16", "float32"):
        if dtype not in cases:
            continue
        arms, mask = smoke.table_arms(gen, n, batch, dtype)
        corpora, queries, scales = zip(*arms)
        scales = scales if dtype == "int8" else (None, None)
        peak = {"int8": smoke.PEAK_INT8_OPS, "bfloat16": smoke.PEAK_BF16_FLOPS}.get(dtype, smoke.PEAK_FP32_OPS)
        product = torch._int_mm if dtype == "int8" else torch.mm
        prepared = [ft.prepare_queries(q, c)[0] for c, q in zip(corpora, queries)]
        case(
            "section_tables",
            lambda: sec.section_tables_cuda(corpora, queries, mask, scales, block),
            sum(2.0 * batch * n * c.shape[1] for c in corpora),
            smoke.table_bytes(arms, n, batch, n // block * 128, 4), peak,
            products=lambda: [product(p, c.t()) for p, c in zip(prepared, corpora)],
            dtype=dtype, n=n, d=[c.shape[1] for c in corpora],
        )
        if dtype == "int8":
            for arm, (c, q, s), qi in zip(("dense", "sketch"), arms, prepared):
                case(
                    "bucket_max_v2", lambda: ft.matmul_bucket_max_v2_cuda(c, q, mask, s),
                    2.0 * batch * n * c.shape[1],
                    smoke.table_bytes([(c, q, s)], n, batch, n // block * 128, 8), peak,
                    products=lambda: torch._int_mm(qi, c.t()), dtype=dtype, arm=arm, n=n,
                    d=c.shape[1],
                )
        del arms, corpora, queries, scales, mask, prepared
        torch.cuda.empty_cache()

    # bucket_ab's shapes: v1 (measured), v2 (control for bf16, measured for
    # float32).
    n = smoke.AB_ROWS
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        if name not in cases:
            continue
        peak = smoke.PEAK_BF16_FLOPS if dtype == torch.bfloat16 else smoke.PEAK_FP32_OPS
        elt = 2 if dtype == torch.bfloat16 else 4
        for d in (384, 768):
            c = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
            q = torch.randn(batch, d, generator=gen, device="cuda")
            q = q / q.norm(dim=1, keepdim=True)
            mask = torch.ones(n, dtype=torch.bool, device="cuda")
            qc = q.to(dtype)
            width = n // ft.choose_block_rows(n) * 128
            v1_ms, v1_by = smoke.v1_bound(n, batch, d, dtype)
            result["cases"].append(dict(
                kernel="bucket_max_v1", dtype=name, n=n, d=d,
                ms=timed(lambda: ft.matmul_bucket_max_cuda(c, q, mask)),
                products_ms=timed(lambda: torch.mm(qc, c.t()), reps=5), bound_ms=v1_ms,
                bound_by=v1_by, **variant_times(lambda: ft.matmul_bucket_max_cuda(c, q, mask)),
            ))
            case(
                "bucket_max_v2", lambda: ft.matmul_bucket_max_v2_cuda(c, q, mask),
                2.0 * batch * n * d, n * d * elt + batch * d * 4 + n + batch * width * 8, peak,
                products=(lambda: torch.mm(qc, c.t())) if dtype == torch.float32 else None,
                dtype=name, n=n, d=d,
            )
            del c, q, qc, mask
            torch.cuda.empty_cache()

    if "rescore" in cases:
        cand, ids, w, q_ids, q_w = smoke.rescore_inputs(gen)
        m, qm = ids.shape[1], q_ids.shape[1]
        for slots, (ids_s, w_s) in (("int32_float32", (ids, w)), ("int16_float16", (ids.to(torch.int16), w.to(torch.float16)))):
            b_ms, b_by = smoke.rescore_bound(cand, m, qm, ids_s.element_size() + w_s.element_size())

            def device_ms(c=cand, ids_s=ids_s, w_s=w_s):
                fn = lambda: rs.exact_rescore_cuda(c, ids_s, w_s, q_ids, q_w)  # noqa: E731
                return smoke.kernel_device_ms(fn, 20, "rescore_kernel")

            row = dict(
                kernel="sparse_rescore", slots=slots,
                ms=timed(lambda: rs.exact_rescore_cuda(cand, ids_s, w_s, q_ids, q_w), reps=20),
                bound_ms=b_ms, bound_by=b_by,
            )
            row["device_ms"], row["device_records"] = device_ms()
            # The same candidates folded onto the first 16,384 rows (16 MB of
            # int32 / float32 slots): every row in L2, so the time left is
            # the kernel's own work, not the gather from DRAM.
            row["device_ms_rows_in_l2"] = device_ms(c=torch.where(cand >= 0, cand % 16384, cand))[0]
            for name, lib in rescore_variants.items():
                cuda_build.load = lambda _name, lib=lib: lib
                try:
                    row[f"device_ms_{name}"] = device_ms()[0]
                finally:
                    cuda_build.load = load
            result["cases"].append(row)
        del cand, ids, w, q_ids, q_w
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
