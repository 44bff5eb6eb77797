"""mxtpu_torch.ops — operators with hand-written CUDA kernels: flash
attention forward (K1) and backward (K2, K3, K4), and dequant-attention
decode (K5); the optimizer-update ops as plain tensor functions."""
