"""Device ops: retrieval scoring, fusion, sequence-parallel attention, and the
hand-written CUDA kernels (flash attention and its ring-step partial, exact
sparse rescore, section and bucket tables) with their plain PyTorch twins.

As in the JAX package, the name ``ring_attention`` here is the function; the
module is ``sys.modules["verbatim_rag_tpu_torch.ops.ring_attention"]``.
"""

from .flash_attention import flash_attention_partial
from .ring_attention import halo_attention, ring_attention, shard_sequence

__all__ = ["flash_attention_partial", "halo_attention", "ring_attention", "shard_sequence"]
