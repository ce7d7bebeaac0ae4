"""Device ops: retrieval scoring, fusion, and the hand-written CUDA kernels
(flash attention, exact sparse rescore) with their plain PyTorch twins."""
