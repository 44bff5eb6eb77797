#!/usr/bin/env python3
"""Chip smoke for mxtpu_torch: builds the port's CUDA kernels and drives its
main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without a result line:

1. the card's name and power limit (``nvidia-smi``); build both kernels
   with ``nvcc`` (one process per source, in parallel);
2. K1 (flash-attention forward) against its plain PyTorch version on the
   card at the forward's shapes (B=4, H=12, T=1024, D=64, causal) in f32
   and bf16, plus ragged and wide-head shapes: error, kernel, plain and
   ``scaled_dot_product_attention`` times, and the bound;
3. K5 (dequant decode) against its plain version at the engine's decode
   shape (S=8, H=12, TOT=1024, D=64) with ragged cursors, int8 and fp8;
4. forward: ``transformer_lm("base", vocab_size=50257)`` (GPT-2 124M
   dimensions) scores a (4, 1024) batch; K1 must launch;
5. serving: ``ServingEngine(that model, slots=8, quant="int8_kv")`` answers
   8 greedy requests (prompts of 64-700 tokens, 128 new tokens each);
   K5 must launch on every layer of every step; then the same requests
   again under ``torch.profiler`` for the device's busy share;
6. card against CPU: at base width with 2 layers, the same weights on the
   card and on the CPU give the same greedy tokens for 2 requests of 32
   new tokens (int8 and fp8 KV), and forward logits that agree.

Launch counts are set to 0 just before phases 4 and 5 and read just after.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Weights are random, from fixed seeds.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense) used for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def timed_ms(torch, fn, iters, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_k1(torch, attention):
    """K1 against its plain version; returns the main-path record (f32,
    causal, the forward's shape)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [  # (label, B, H, T, Tk, D, dtype, causal, out tol, timed)
        ("f32 causal", 4, 12, 1024, 1024, 64, torch.float32, True, 1e-4, True),
        ("bf16 causal", 4, 12, 1024, 1024, 64, torch.bfloat16, True, 1e-2,
         True),
        ("f32 causal ragged T=1000", 4, 12, 1000, 1000, 64, torch.float32,
         True, 1e-4, False),
        ("f32 full T=1000 Tk=1021", 2, 4, 1000, 1021, 64, torch.float32,
         False, 1e-4, False),
        ("f32 causal D=256", 1, 2, 200, 200, 256, torch.float32, True, 1e-4,
         False),
        ("bf16 full D=40", 2, 3, 77, 130, 40, torch.bfloat16, False, 1e-2,
         False),
    ]
    main = None
    for label, B, H, T, Tk, D, dt, causal, tol, do_time in cases:
        q = torch.randn(B, H, T, D, device=dev, generator=g).to(dt)
        k = torch.randn(B, H, Tk, D, device=dev, generator=g).to(dt)
        v = torch.randn(B, H, Tk, D, device=dev, generator=g).to(dt)
        scale = 1.0 / math.sqrt(D)
        out, lse = attention.flash_fwd(q, k, v, causal, scale)
        ref, ref_lse = attention._chunk_reference_lse(q, k, v, causal, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        check(math.isfinite(err) and err <= tol and lse_err <= 1e-4,
              f"K1 {label}: out err {err} (tol {tol}), lse err {lse_err} "
              f"(tol 1e-4)")
        line = (f"K1 {label} B{B} H{H} T{T} Tk{Tk} D{D}: max_abs_err out "
                f"{err:.3e} (tol {tol:g}) lse {lse_err:.3e} (tol 1e-4)")
        if not do_time:
            print(line, flush=True)
            continue
        ms = timed_ms(torch, lambda: attention.flash_fwd(q, k, v, causal,
                                                        scale), 20)
        plain_ms = timed_ms(torch, lambda: attention._chunk_reference_lse(
            q, k, v, causal, scale), 10)
        lib_ms = timed_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale), 20)
        elem = q.element_size()
        nbytes = (2 * B * H * T * D + 2 * B * H * Tk * D) * elem \
            + B * H * T * 4
        pairs = T * (T + 1) // 2 if causal else T * Tk    # causal: T == Tk
        flops = 4.0 * B * H * pairs * D
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[str(dt).replace("torch.", "")] * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{line}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{flops:.3e} flops, {nbytes} bytes)", flush=True)
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=lib_ms)
    return main


def phase_k5(torch, quant_attention, kv_quant):
    """K5 against its plain version; returns the main-path record (int8
    cache, the engine's decode shape)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    cases = [  # (label, S, H, TOT, D, mode, timed)
        ("int8", 8, 12, 1024, 64, "int8", True),
        ("fp8", 8, 12, 1024, 64, "fp8", True),
        ("int8 D=40 TOT=96", 3, 2, 96, 40, "int8", False),
        ("fp8 D=40 TOT=32", 2, 3, 32, 40, "fp8", False),
    ]
    main = None
    for label, S, H, TOT, D, mode, do_time in cases:
        q = torch.randn(S, H, D, device=dev, generator=g)
        kd, ks = kv_quant.quantize_rows(
            torch.randn(S, H, TOT, D, device=dev, generator=g), mode)
        vd, vs = kv_quant.quantize_rows(
            torch.randn(S, H, TOT, D, device=dev, generator=g), mode)
        # ragged cursors: first row, last row, and spread between
        pc = torch.randint(0, TOT, (S,), device=dev, generator=g,
                           dtype=torch.int32)
        pc[0], pc[-1] = 0, TOT - 1
        scale = 1.0 / math.sqrt(D)
        out = quant_attention.dequant_decode(q, kd, ks, vd, vs, pc, scale)
        ref = quant_attention._decode_plain(q, kd, ks, vd, vs, pc, scale)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-5 * max(ref.abs().max().item(), 1.0)
        check(math.isfinite(err) and err <= tol,
              f"K5 {label}: err {err} (tol {tol})")
        line = (f"K5 {label} S{S} H{H} TOT{TOT} D{D} pc={pc.tolist()}: "
                f"max_abs_err {err:.3e} (tol {tol:.3e})")
        if not do_time:
            print(line, flush=True)
            continue
        ms = timed_ms(torch, lambda: quant_attention.dequant_decode(
            q, kd, ks, vd, vs, pc, scale), 200)
        plain_ms = timed_ms(torch, lambda: quant_attention._decode_plain(
            q, kd, ks, vd, vs, pc, scale), 50)
        rows = int((pc.long() + 1).sum().item()) * H
        nbytes = 2 * rows * (D * kd.element_size() + 4) \
            + 2 * S * H * D * 4 + S * 4
        flops = 4.0 * rows * D
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["float32"] * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{line}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library none, bound {bound_ms:.5f} ms ({bound_by}: {nbytes} "
              f"bytes)", flush=True)
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None)
    return main


def phase_forward(torch, lm, attention, counts):
    model = lm.transformer_lm("base", vocab_size=50257)   # device None: card
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, 50257, (4, 1024), device="cuda", generator=g)
    counts(0)
    with torch.inference_mode():
        t0 = time.monotonic()
        logits = model(tokens)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    launches = attention.flash_fwd.launches
    check(tuple(logits.shape) == (4, 1024, 50257),
          f"forward logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "forward logits not finite")
    check(launches > 0, "the forward launched no flash_fwd kernel")
    del logits
    with torch.inference_mode():
        steady = timed_ms(torch, lambda: model(tokens), 5, warmup=1)
    print(f"forward base (4, 1024): logits finite, {wall * 1e3:.1f} ms "
          f"first call, {steady:.2f} ms steady; flash_fwd launches "
          f"{launches} (one forward)", flush=True)
    return model, launches


def serving_prompts(torch):
    lens = [64, 100, 170, 250, 333, 480, 600, 700]
    g = torch.Generator().manual_seed(4)
    return [torch.randint(0, 50257, (n,), generator=g).tolist()
            for n in lens]


def phase_serving(torch, model, serving, quant_attention, counts):
    prompts = serving_prompts(torch)
    counts(0)
    t0 = time.monotonic()
    with serving.ServingEngine(model, slots=8, quant="int8_kv") as eng:
        reqs = [eng.submit(p, 128) for p in prompts]
        outs = [r.result(timeout=900) for r in reqs]
        stats = eng.stats()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = quant_attention.dequant_decode.launches
    for r, o in zip(reqs, outs):
        check(r.state == serving.DONE and len(o) == 128,
              f"request {r.id}: state {r.state}, {len(o)} tokens")
    check(launches > 0, "serving launched no dequant_decode kernel")
    L = len(model.blocks)
    check(launches % L == 0, f"{launches} dequant_decode launches is not a "
          f"multiple of the {L} layers: a step skipped the kernel")
    ttft = sorted((r.t_first_token - r.t_submit) * 1e3 for r in reqs)
    print(f"serving base int8_kv slots=8: 8 requests x 128 tokens in "
          f"{wall:.2f} s = {8 * 128 / wall:.1f} tokens/s; TTFT ms median "
          f"{ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f}; dequant_decode "
          f"launches {launches} ({launches // L} steps x {L} layers); "
          f"kv_dtype {stats['kv_dtype']}, "
          f"kv_bytes_resident {stats['kv_bytes_resident']}, prefills "
          f"{stats.get('prefills')}, prefill_chunks "
          f"{stats.get('prefill_chunks')}, decode_steps "
          f"{stats.get('decode_steps')}", flush=True)
    return launches


def phase_profile(torch, model, serving):
    """Where the serving time goes: two of the burst's requests (prompts of
    170 and 250 tokens, 128 new) again under ``torch.profiler`` (device
    activity only; the profiler's processing grows with the kernel count,
    so the window is kept short), reporting the device's busy share of the
    run's wall time and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile
    prompts = serving_prompts(torch)[2:4]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        with serving.ServingEngine(model, slots=8, quant="int8_kv") as eng:
            for r in [eng.submit(p, 128) for p in prompts]:
                r.result(timeout=900)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        print("profile: the profiler recorded no device time", flush=True)
        return
    print(f"profile serving (2 x 128, profiler on): wall {wall_us / 1e3:.1f} "
          f"ms, device busy {busy / 1e3:.1f} ms = {busy / wall_us:.3f} of "
          f"wall, idle {1 - busy / wall_us:.3f}", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / busy:.3f} of device time, {us / 1e3:.1f} ms: "
              f"{name[:110]}", flush=True)


def phase_card_vs_cpu(torch, lm, serving):
    cpu = lm.transformer_lm("base", vocab_size=50257, num_layers=2,
                            device="cpu", seed=5)
    gpu = lm.transformer_lm("base", vocab_size=50257, num_layers=2, seed=6)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, 50257, (n,), generator=g).tolist()
               for n in (40, 90)]
    with torch.inference_mode():
        toks = torch.tensor([prompts[1][:64]])
        lc = cpu(toks)
        lg = gpu(toks.cuda()).cpu()
    ferr = (lc - lg).abs().max().item()
    check(ferr <= 1e-3, f"forward logits card vs CPU differ by {ferr}")
    for quant in ("int8_kv", "fp8_kv"):
        outs = {}
        for name, net, dev in (("cuda", gpu, None), ("cpu", cpu, "cpu")):
            with serving.ServingEngine(net, slots=2, quant=quant,
                                       device=dev) as eng:
                reqs = [eng.submit(p, 32) for p in prompts]
                outs[name] = [r.result(timeout=600) for r in reqs]
        for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
            if a == b:
                continue
            j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
            with torch.inference_mode():
                ctx = torch.tensor([prompts[i] + b[:j]])
                top = torch.topk(cpu(ctx)[0, -1], 2).values
            raise SmokeFailure(
                f"{quant} request {i}: card and CPU greedy tokens diverge "
                f"at new token {j} ({a[j]} vs {b[j]}); CPU fp32 forward "
                f"top-2 logit margin there {float(top[0] - top[1]):.3e}")
    print(f"card vs CPU, base width 2 layers: forward logits max diff "
          f"{ferr:.3e} (tol 1e-3); greedy tokens equal for 2 requests x 32, "
          f"int8_kv and fp8_kv", flush=True)


def run():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke runs on the card only")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from mxtpu_torch import _build
    except ImportError as e:
        raise SmokeFailure(f"mxtpu_torch not found beside {__file__}: {e}")
    from mxtpu_torch.gluon.model_zoo import transformer as lm
    from mxtpu_torch.ops import attention, quant_attention
    from mxtpu_torch.quant import kv_quant
    from mxtpu_torch import serving

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.monotonic()
    built = _build.build_all()
    print(f"built {sorted(built)} in {time.monotonic() - t0:.1f} s "
          f"(nvcc per kernel: "
          f"{ {k: round(v, 1) for k, v in built.items()} })", flush=True)
    for name in _build.SOURCES:
        for ln in _build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {name}: {ln.strip()}", flush=True)

    def counts(n):
        attention.flash_fwd.launches = n
        quant_attention.dequant_decode.launches = n

    def timed_phase(name, fn, *args):
        t = time.monotonic()
        out = fn(*args)
        print(f"[{name}: {time.monotonic() - t:.1f} s]", flush=True)
        return out

    k1 = timed_phase("K1 checks", phase_k1, torch, attention)
    k5 = timed_phase("K5 checks", phase_k5, torch, quant_attention, kv_quant)
    model, k1_launches = timed_phase("forward", phase_forward, torch, lm,
                                     attention, counts)
    k5_launches = timed_phase("serving", phase_serving, torch, model,
                              serving, quant_attention, counts)
    timed_phase("profile", phase_profile, torch, model, serving)
    del model
    torch.cuda.empty_cache()
    timed_phase("card vs CPU", phase_card_vs_cpu, torch, lm, serving)

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="mxtpu_torch/csrc/flash_fwd.cu",
             replaces="mxtpu/ops/attention.py:133", launches=k1_launches,
             **k1),
        dict(name="dequant_decode", route="cuda",
             source="mxtpu_torch/csrc/dequant_decode.cu",
             replaces="mxtpu/ops/quant_attention.py:99",
             launches=k5_launches, **k5),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> int:
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
