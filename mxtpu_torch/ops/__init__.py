"""mxtpu_torch.ops — operators with hand-written CUDA kernels: flash
attention forward (K1) and dequant-attention decode (K5)."""
