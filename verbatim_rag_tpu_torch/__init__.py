"""verbatim_rag_tpu_torch — the PyTorch/CUDA port of verbatim_rag_tpu.

The same offline extractive-RAG path as the JAX package (ingest → hybrid
retrieval → neural span extraction → cited answer), written in PyTorch, with
the TPU's Pallas kernels replaced by CUDA kernels written for Hopper
(`csrc/`). Every entry point takes ``device=None``, meaning ``cuda``; with no
GPU it raises unless the caller passes ``device="cpu"``.
"""

__version__ = "0.5.2"
