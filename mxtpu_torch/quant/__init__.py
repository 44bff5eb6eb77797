"""mxtpu_torch.quant — the int8/fp8 KV cache and the quantized serving
step."""
