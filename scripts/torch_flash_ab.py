"""Time the PyTorch port's bf16 flash-attention kernels of one source tree on the card.

    python3 scripts/torch_flash_ab.py [--tree DIR] [--label NAME] [--seed 0]

Imports `verbatim_rag_tpu_torch` from DIR (default: the checkout holding this
script), builds its flash kernels into DIR/build/kernels, and times them at
ModernBERT-base heads (B=8, H=12, D=64, bf16) with the ragged lengths of
`chip_smoke.py` (a zero-length row included): the forward at S=8192 and the
backward (dq + dk/dv) at S=4096 and 8192, each global and with window 128;
and the ring step's partial at long_sp's block shape (B=1, Sq=Sk=6144, a row
of 22,830 tokens) at k_offset 0 (every key live), 18432 (4,398 live keys)
and 24576 (a dead block); then the forward at head dim 32 at the neural
providers' shape (B=64, S=256, H=12, global, `chip_smoke.flash_lengths`),
by events and by its device time from `torch.profiler` (a call is about as
short as its wrapper's host time). Beside each time it prints the bound (the larger of
the bytes over 3.35 TB/s and the least FLOP over 989 TFLOP/s, as
`chip_smoke.py` counts them), the backward's FLOP in the dq + dk/dv split
(14·D a live pair and head against the least 10·D), and the time of
`scaled_dot_product_attention` (forward, or its backward) on the same inputs
with the equivalent boolean mask; for the partial also
`aten::_scaled_dot_product_efficient_attention` with its logsumexp, the key
mask as bias ((o, lse): what (numer, m, l) holds, up to a per-row rescale).
Prints one JSON line; needs one GPU.

An A/B of two trees in one call, on one card: unpack the parent commit into a
git-ignored directory and run the script in turns,

    git archive <parent> | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 scripts/torch_flash_ab.py --tree $t; done
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _smoke():
    """`chip_smoke.py` of this checkout, for its timing and bound helpers."""
    spec = importlib.util.spec_from_file_location("_chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(HERE))
    parser.add_argument("--label", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.stderr.write("torch_flash_ab: no CUDA device\n")
        raise SystemExit(2)
    tree = Path(args.tree).resolve()
    os.environ["VERBATIM_TORCH_BUILD_DIR"] = str(tree / "build" / "kernels")
    sys.path.insert(0, str(tree))
    from verbatim_rag_tpu_torch.ops import cuda_build
    from verbatim_rag_tpu_torch.ops import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(tree), fa.__file__
    smoke = _smoke()
    cuda_build.build_all(("flash_attention", "flash_attention_bwd"))

    B, H, D = 8, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = dict(tree=args.label or str(tree), card=smoke.gpu_name_and_limit(), cases=[])
    for seq, kinds in ((4096, ("bwd",)), (8192, ("fwd", "bwd"))):
        lengths = [seq, 0, seq // 2 + 3, 17, seq - 1, seq // 3, 1, seq]
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q, k, v, g = (
            torch.randn(B, seq, H, D, generator=gen, device="cuda", dtype=torch.bfloat16)
            for _ in range(4)
        )
        for window in (None, 128):
            pairs = smoke.attention_pairs(lengths, seq, window)
            mask = smoke.sdpa_mask(lens, seq, window)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            if "fwd" in kinds:
                ms = smoke.cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, lens, window), reps=10)
                with torch.no_grad():
                    library_ms = smoke.cuda_ms(
                        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=5
                    )
                b_ms, b_by = smoke.bound(
                    4 * B * seq * H * D * 2 + 4 * B, 4 * H * D * pairs, smoke.PEAK_BF16_FLOPS
                )
                result["cases"].append(dict(
                    kernel="fwd", seq=seq, window=window, ms=ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=library_ms, share_of_bound=b_ms / ms,
                ))
            if "bwd" in kinds:
                out, lse = fa.flash_attention_lse_cuda(q, k, v, lens, window)
                delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
                dq_ms = smoke.cuda_ms(
                    lambda: fa._launch_bwd(q, k, v, lens, lse, delta, g, window, ("dq",)), reps=10
                )
                dkv_ms = smoke.cuda_ms(
                    lambda: fa._launch_bwd(q, k, v, lens, lse, delta, g, window, ("dkv",)), reps=10
                )
                o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
                go = g.transpose(1, 2).contiguous()
                library_ms = smoke.cuda_ms(
                    lambda: torch.autograd.grad(o, (qt, kt, vt), go, retain_graph=True), reps=5
                )
                b_ms, b_by = smoke.bound(
                    7 * B * seq * H * D * 2 + 2 * B * H * seq * 4 + 4 * B, 10 * H * D * pairs,
                    smoke.PEAK_BF16_FLOPS,
                )
                ms = dq_ms + dkv_ms
                result["cases"].append(dict(
                    kernel="bwd", seq=seq, window=window, ms=ms, dq_ms=dq_ms, dkv_ms=dkv_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, share_of_bound=b_ms / ms,
                    least_gflop=10 * H * D * pairs / 1e9, split_gflop=14 * H * D * pairs / 1e9,
                ))
                del out, lse, delta, o, go
            del qt, kt, vt, mask
        del q, k, v, g
        torch.cuda.empty_cache()

    # The partial: one KV block of a 4-shard ring over one 22,830-token row.
    seq, length = 6144, 22830
    lens = torch.tensor([length], dtype=torch.int32, device="cuda")
    q, k, v = (
        torch.randn(1, seq, H, D, generator=gen, device="cuda", dtype=torch.bfloat16)
        for _ in range(3)
    )
    for k_offset in (0, 3 * seq, 4 * seq):
        live_keys = max(0, min(seq, length - k_offset))
        ms = smoke.cuda_ms(lambda: fa.flash_attention_partial_cuda(q, k, v, lens, k_offset), reps=20)
        b_ms, b_by = smoke.bound(
            3 * seq * H * D * 2 + seq * H * D * 4 + 2 * H * seq * 4 + 4,
            4 * H * D * seq * live_keys, smoke.PEAK_BF16_FLOPS,
        )
        case = dict(
            kernel="partial", seq_q=seq, seq_k=seq, k_offset=k_offset, live_keys=live_keys, ms=ms,
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
        )
        if live_keys:
            live = torch.arange(seq, device="cuda") < live_keys
            mask = live[None, None, None, :].expand(1, 1, seq, seq)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            with torch.no_grad():
                case["sdpa_ms"] = smoke.cuda_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=10
                )
                case["library_ms"], case["library_note"] = smoke.efficient_attention_ms(qt, kt, vt, live)
            del qt, kt, vt, mask
        result["cases"].append(case)
    del q, k, v

    # The forward at head dim 32: the providers' encode batch.
    B32, S32 = 64, 256
    lengths = smoke.flash_lengths(B32, S32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn(B32, S32, H, 32, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3))

    def forward_d32():
        return fa.flash_attention_cuda(q, k, v, lens, None)

    q_rows, kv_rows = smoke.attention_rows(lengths, S32)
    b_ms, b_by = smoke.bound(
        (q_rows + 2 * kv_rows + B32 * S32) * H * 32 * 2 + 4 * B32,
        4 * H * 32 * smoke.attention_pairs(lengths, S32, None), smoke.PEAK_BF16_FLOPS,
    )
    device_ms, records = smoke.kernel_device_ms(forward_d32, 10, "flash_fwd_wgmma_kernel<32>")
    result["cases"].append(dict(
        kernel="fwd_d32", batch=B32, seq=S32, ms=smoke.cuda_ms(forward_d32, reps=50),
        device_ms=device_ms, device_records=records, bound_ms=b_ms, bound_by=b_by,
    ))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
