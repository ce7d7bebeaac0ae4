"""% of the card's bf16 peak that the two candidate products make:
2·B·N·(dense + sketch width) FLOPs a batch, counted from the shapes."""

from portbench.harness.roofline import PEAK_BF16_FLOPS


def read(rec):
    per_batch = rec.get("candidate_flops_per_batch")
    return 100.0 * per_batch * rec["calls"] / (rec["window_s"] * PEAK_BF16_FLOPS) if per_batch else None
