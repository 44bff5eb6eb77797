#!/usr/bin/env python3
"""Chip smoke for mxtpu_torch: builds the port's CUDA kernels and drives its
main paths on one NVIDIA GPU: serving and training.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without a result line:

1. the card's name and power limit (``nvidia-smi``); build every kernel
   with ``nvcc`` (one process per source, in parallel);
2. K1 (flash-attention forward) against its plain PyTorch version on the
   card at the forward's shapes (B=4, H=12, T=1024, D=64, causal) in f32
   and bf16, at the training shape (B=8, H=16, T=1024, D=64, causal,
   bf16), plus ragged and wide-head shapes: error, kernel, plain and
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
   new tokens (int8 and fp8 KV), and forward logits that agree;
7. K2, K3 and K4 (flash-attention backward) against the plain backward on
   the card at the training shape (B=8, H=16, T=1024, D=64, causal) in
   bf16 and f32, and at ragged shapes (T=1000, T != Tk, D=40, 128, 256),
   with an lse cotangent and with bf16 lse/Delta rows: kernel, plain and
   ``scaled_dot_product_attention``-backward times, and the bounds; then
   K2 + K3 timed against K4 on a small grid and without the causal mask;
8. training: ``transformer_lm("flagship", vocab_size=16384)`` in bf16
   (d1024, L8, H16) takes 1 + 24 Adam steps on one fixed (32, 1024) batch
   through ``DataParallelTrainer(micro_batches=4)``; the loss must fall by
   0.3 (the learning gate of the JAX package's benchmark) and K1, K2 and
   K3 must launch once per layer, micro-batch and step; then one step
   under ``torch.profiler``;
9. the fused backward: 3 steps of the same run with the split pair, then 3
   under ``MXTPU_FLASH_BWD=fused``; K4 must launch, and the losses and
   the trained weights equal the split run's bit for bit;
10. training card against CPU: base width, 2 layers, f32, B=4, T=256; the
    first batch's gradients, the losses of 3 Adam steps and the weights
    after them agree.

Launch counts are set to 0 just before phases 4, 5, 8 and 9 (its fused
run) and read just after. The line before the last is the kernels' JSON
record, with one K1 record for each path it runs on; the last line is
``{"ok": true, "device": {...}}``. Weights are random, from fixed
seeds.
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


def _bound(flops, nbytes, dtype):
    """(bound ms, what bounds it) on the H100's data-sheet peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_k1(torch, attention):
    """K1 against its plain version; returns the record of each main path
    by name: ``forward`` (f32, causal, the scoring forward's shape) and
    ``train`` (bf16, causal, one training micro-batch)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    # record: the main path the case stands for ("" timed only, None
    # checked only)
    cases = [  # (label, B, H, T, Tk, D, dtype, causal, out tol, record)
        ("f32 causal", 4, 12, 1024, 1024, 64, f32, True, 1e-4, "forward"),
        ("bf16 causal", 4, 12, 1024, 1024, 64, bf16, True, 1e-2, ""),
        ("bf16 causal, training shape", 8, 16, 1024, 1024, 64, bf16, True,
         1e-2, "train"),
        ("f32 causal ragged T=1000", 4, 12, 1000, 1000, 64, f32, True, 1e-4,
         None),
        ("f32 full T=1000 Tk=1021", 2, 4, 1000, 1021, 64, f32, False, 1e-4,
         None),
        ("f32 causal D=256", 1, 2, 200, 200, 256, f32, True, 1e-4, None),
        ("bf16 full D=40", 2, 3, 77, 130, 40, bf16, False, 1e-2, None),
    ]
    recs = {}
    for label, B, H, T, Tk, D, dt, causal, tol, record in cases:
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
        if record is None:
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
        bound_ms, bound_by = _bound(flops, nbytes,
                                    str(dt).replace("torch.", ""))
        print(f"{line}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{flops:.3e} flops, {nbytes} bytes)", flush=True)
        if record:
            recs[record] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=lib_ms)
    return recs


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
        bound_ms, bound_by = _bound(flops, nbytes, "float32")
        print(f"{line}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library none, bound {bound_ms:.5f} ms ({bound_by}: {nbytes} "
              f"bytes)", flush=True)
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None)
    return main


def phase_bwd(torch, attention):
    """K2, K3 and K4 against the plain backward; returns the main-path
    records (bf16, causal, the training shape) by kernel name."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (label, B, H, T, Tk, D, dtype, causal, dlse, bf16 rows, timed)
        ("bf16 causal", 8, 16, 1024, 1024, 64, bf16, True, False, False,
         True),
        ("f32 causal", 8, 16, 1024, 1024, 64, f32, True, False, False, True),
        ("f32 causal dlse T=1000", 2, 4, 1000, 1000, 64, f32, True, True,
         False, False),
        ("f32 full dlse T=1000 Tk=1021", 2, 4, 1000, 1021, 64, f32, False,
         True, False, False),
        ("f32 causal T=200 Tk=333", 2, 3, 200, 333, 64, f32, True, True,
         False, False),
        ("f32 causal T=333 Tk=200", 2, 3, 333, 200, 64, f32, True, False,
         False, False),
        ("bf16 full D=40", 2, 3, 77, 130, 40, bf16, False, True, False,
         False),
        ("f32 causal D=40", 2, 3, 150, 150, 40, f32, True, False, False,
         False),
        ("f32 causal D=128", 1, 4, 300, 300, 128, f32, True, True, False,
         False),
        ("f32 causal D=256", 1, 2, 200, 200, 256, f32, True, True, False,
         False),
        ("f32 causal bf16 rows", 2, 4, 512, 512, 64, f32, True, True, True,
         False),
        # at this size cuBLAS sums the plain version's products in another
        # order than the kernels (at the sizes above it uses their order)
        ("f32 causal T=64", 1, 1, 64, 64, 64, f32, True, False, False,
         False),
    ]
    main = None
    for (label, B, H, T, Tk, D, dt, causal, with_dlse, bf16_rows,
         do_time) in cases:
        q, dout = (torch.randn(B, H, T, D, device=dev, generator=g).to(dt)
                   for _ in range(2))
        k, v = (torch.randn(B, H, Tk, D, device=dev, generator=g).to(dt)
                for _ in range(2))
        dlse = torch.randn(B, H, T, device=dev, generator=g) \
            if with_dlse else None
        scale = 1.0 / math.sqrt(D)
        out, lse = attention.flash_fwd(q, k, v, causal, scale)
        os.environ["MXTPU_FLASH_LSE"] = "bf16" if bf16_rows else ""
        try:
            rows = attention._bwd_rows(out, lse, dout, dlse)
        finally:
            os.environ.pop("MXTPU_FLASH_LSE")
        args = (q, k, v, dout) + rows + (causal, scale)
        ref = attention._flash_bwd_plain(*args)
        split = (attention.flash_bwd_dq(*args),) + \
            attention.flash_bwd_dkv(*args)
        fused = attention.flash_bwd_fused(*args) if T == Tk else None
        torch.cuda.synchronize()
        tol_rel = 1e-4 if dt == f32 else 2e-2
        errs = {}
        for kern, outs in (("K2", split[:1]), ("K3", split[1:]),
                           ("K4", fused)):
            if outs is None:
                continue
            refs = ref[:1] if kern == "K2" else ref[1:] if kern == "K3" \
                else ref
            err = max((o.float() - r.float()).abs().max().item()
                      for o, r in zip(outs, refs))
            tol = tol_rel * max(max(r.float().abs().max().item()
                                    for r in refs), 1.0)
            check(math.isfinite(err) and err <= tol,
                  f"{kern} {label}: err {err} (tol {tol})")
            errs[kern] = (err, tol)
        same = "n/a (T != Tk)" if fused is None else str(all(
            torch.equal(a, b) for a, b in zip(split, fused)))
        line = (f"K2/K3/K4 {label} B{B} H{H} T{T} Tk{Tk} D{D}: max_abs_err "
                + ", ".join(f"{kk} {e:.3e} (tol {t:.3e})"
                            for kk, (e, t) in errs.items())
                + f"; K4 bit-equal to K2+K3: {same}")
        if not do_time:
            print(line, flush=True)
            continue
        ms = {"K2": timed_ms(torch, lambda: attention.flash_bwd_dq(*args),
                             10),
              "K3": timed_ms(torch, lambda: attention.flash_bwd_dkv(*args),
                             10),
              "K4": timed_ms(torch, lambda: attention.flash_bwd_fused(
                  *args), 10)}
        plain_ms = timed_ms(torch, lambda: attention._flash_bwd_plain(*args),
                            3, warmup=1)
        qs, ks, vs = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                           scale=scale).backward(dout)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                               scale=scale)

        lib_ms = timed_ms(torch, sdpa_fwd_bwd, 10) - \
            timed_ms(torch, sdpa_fwd, 10)
        BH, elem = B * H, q.element_size()
        pairs = sum(min(i + 1, Tk) for i in range(T)) if causal else T * Tk
        in_bytes = BH * (2 * T + 2 * Tk) * D * elem \
            + 2 * BH * T * rows[0].element_size()
        q_bytes, kv_bytes = BH * T * D * elem, 2 * BH * Tk * D * elem
        # products of T x Tk x D the function needs: dq S, dP, dS K; dk, dv
        # S, dP, dS^T q, P^T dO; all three S, dP, dq, dk, dv (K4 runs K2's
        # body and K3's, 7 products, 7/5 of what it needs)
        work = {"K2": (3, in_bytes + q_bytes), "K3": (4, in_bytes + kv_bytes),
                "K4": (5, in_bytes + q_bytes + kv_bytes)}
        recs = {}
        for kern, (products, nbytes) in work.items():
            flops = 2.0 * products * BH * pairs * D
            bound_ms, bound_by = _bound(flops, nbytes,
                                        str(dt).replace("torch.", ""))
            recs[kern] = dict(max_abs_err=errs[kern][0], ms=ms[kern],
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=lib_ms)
            line += (f"; {kern} {ms[kern]:.4f} ms, bound {bound_ms:.4f} ms "
                     f"({bound_by}: {flops:.3e} flops, {nbytes} bytes)")
        print(f"{line}; plain backward {plain_ms:.4f} ms, sdpa backward "
              f"{lib_ms:.4f} ms", flush=True)
        if main is None:
            main = recs
    split_vs_fused(torch, attention, g)
    return main


def split_vs_fused(torch, attention, g):
    """Times the split pair (K2 then K3) against K4 at self-attention
    shapes off the training one: a small grid (B*H = 4), and no causal
    mask."""
    dev = torch.device("cuda")
    for B, H, causal in ((1, 4, True), (1, 4, False), (8, 16, False)):
        T, D = 1024, 64
        q, k, v, dout = (torch.randn(B, H, T, D, device=dev, generator=g)
                         .to(torch.bfloat16) for _ in range(4))
        scale = 1.0 / math.sqrt(D)
        out, lse = attention.flash_fwd(q, k, v, causal, scale)
        args = (q, k, v, dout) + attention._bwd_rows(out, lse, dout, None) \
            + (causal, scale)
        split_ms = timed_ms(torch, lambda: (attention.flash_bwd_dq(*args),
                                            attention.flash_bwd_dkv(*args)),
                            10)
        fused_ms = timed_ms(torch, lambda: attention.flash_bwd_fused(*args),
                            10)
        print(f"split vs fused, bf16 {'causal' if causal else 'full'} B{B} "
              f"H{H} T{T} D{D}: K2 + K3 {split_ms:.4f} ms, K4 "
              f"{fused_ms:.4f} ms", flush=True)


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


class SeqLoss:
    """``SoftmaxCrossEntropyLoss`` over (B*T, V), as the JAX package's
    benchmark wraps it."""

    def __init__(self, loss_mod):
        self.ce = loss_mod.SoftmaxCrossEntropyLoss()

    def __call__(self, logits, y):
        b, t, v = logits.shape
        return self.ce(logits.reshape(b * t, v), y.reshape(b * t))


TRAIN = dict(B=32, T=1024, micro_batches=4, vocab=16384, steps=24)


def _flagship(lm):
    return lm.transformer_lm("flagship", vocab_size=TRAIN["vocab"],
                             seed=10).cast("bfloat16")


def _train_batch(torch):
    import numpy as np
    rs = np.random.RandomState(0)
    B, T, V = TRAIN["B"], TRAIN["T"], TRAIN["vocab"]
    x = rs.randint(0, V, (B, T)).astype(np.int32)
    y = rs.randint(0, V, (B, T)).astype(np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def phase_train(torch, lm, attention, optimizer, loss_mod, parallel, counts):
    """The flagship in bf16 memorises one batch (the JAX package's training
    benchmark); returns the launch counts."""
    model = _flagship(lm)
    L, K = len(model.blocks), TRAIN["micro_batches"]
    B, T, steps = TRAIN["B"], TRAIN["T"], TRAIN["steps"]
    x, y = _train_batch(torch)
    dpt = parallel.DataParallelTrainer(model, SeqLoss(loss_mod),
                                       optimizer.Adam(learning_rate=3e-4),
                                       micro_batches=K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts(0)
    t0 = time.monotonic()
    losses = [dpt.step_async(x, y)]
    loss_start = float(losses[0])
    first_s = time.monotonic() - t0
    t0 = time.monotonic()
    for _ in range(steps):
        losses.append(dpt.step_async(x, y))
    loss_end = float(losses[-1])             # one readback syncs the chain
    dt = time.monotonic() - t0
    launches = dict(K1=attention.flash_fwd.launches,
                    K2=attention.flash_bwd_dq.launches,
                    K3=attention.flash_bwd_dkv.launches,
                    K4=attention.flash_bwd_fused.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    want = L * K * (steps + 1)
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(launches["K1"] == launches["K2"] == launches["K3"] == want
          and launches["K4"] == 0,
          f"launches {launches}: want K1 = K2 = K3 = {want} (layers "
          f"{L} x micro-batches {K} x steps {steps + 1}), K4 = 0")
    check(loss_end < loss_start - 0.3,
          f"learning gate: loss {loss_start:.4f} -> {loss_end:.4f} (must "
          f"fall by 0.3)")
    step_ms = dt / steps * 1e3
    tok_s = steps * B * T / dt
    V, U, H = TRAIN["vocab"], model._units, model.blocks[0].attn._heads
    p_dense = sum(p.numel() for n, p in model.named_parameters()
                  if "embed" not in n) + V * U      # + the tied head
    pairs = T * (T + 1) // 2
    attn_flops = 3 * 4 * B * H * pairs * (U // H) * L   # fwd + 2x bwd
    flops = 6 * p_dense * B * T + attn_flops
    print(f"train flagship bf16 d{U} L{L} H{H} B{B} T{T} x{K} Adam(3e-4): "
          f"loss {loss_start:.4f} -> {loss_end:.4f} over 1 + {steps} steps "
          f"(gate: fall by 0.3; uniform floor {math.log(V):.2f}); first "
          f"step {first_s:.2f} s; {step_ms:.2f} ms/step, {tok_s:.1f} "
          f"tokens/s; max_memory_allocated {peak} bytes; launches "
          f"{launches} (= {L} x {K} x {steps + 1}); model flops/step "
          f"{flops:.4e} (6*P*tokens, P={p_dense}, + attention "
          f"{attn_flops:.4e}) = {flops / (step_ms / 1e3) / 1e12:.1f} "
          f"TFLOP/s = {flops / (step_ms / 1e3) / PEAK_FLOPS['bfloat16']:.4f} "
          f"of the 989 TFLOP/s bf16 peak", flush=True)
    print(f"  losses {[round(v, 4) for v in losses]}", flush=True)
    profile_step(torch, dpt, x, y)
    return launches


def profile_step(torch, dpt, x, y):
    """One training step under ``torch.profiler`` (device activity): its
    device-busy share of the wall and its top device operations."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        dpt.step(x, y)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        print("profile train: the profiler recorded no device time",
              flush=True)
        return
    print(f"profile train (1 step, profiler on): wall {wall_us / 1e3:.1f} "
          f"ms, device busy {busy / 1e3:.1f} ms = {busy / wall_us:.3f} of "
          f"wall, idle {1 - busy / wall_us:.3f}", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / busy:.3f} of device time, {us / 1e3:.1f} ms: "
              f"{name[:110]}", flush=True)


def _max_diff(torch, a, b):
    """Largest absolute difference over two lists of tensors, in f32 on
    the CPU."""
    return max((x.detach().float().cpu() - y.detach().float().cpu()).abs()
               .max().item() for x, y in zip(a, b))


def phase_fused(torch, lm, attention, optimizer, loss_mod, parallel, counts):
    """3 steps of the training run with the split pair, then 3 from the same
    weights under ``MXTPU_FLASH_BWD=fused``: K4 replaces K2 + K3, and the
    losses and the trained weights equal the split run's bit for bit (K4
    computes K2's and K3's outputs with their tiles, in their order)."""
    L, K = 0, TRAIN["micro_batches"]
    x, y = _train_batch(torch)
    runs = {}
    for mode in ("split", "fused"):
        model = _flagship(lm)
        L = len(model.blocks)
        dpt = parallel.DataParallelTrainer(model, SeqLoss(loss_mod),
                                           optimizer.Adam(learning_rate=3e-4),
                                           micro_batches=K)
        if mode == "fused":
            os.environ["MXTPU_FLASH_BWD"] = "fused"
            counts(0)
        try:
            losses = [float(v) for v in
                      [dpt.step_async(x, y) for _ in range(3)]]
            launches = dict(K2=attention.flash_bwd_dq.launches,
                            K3=attention.flash_bwd_dkv.launches,
                            K4=attention.flash_bwd_fused.launches)
        finally:
            os.environ.pop("MXTPU_FLASH_BWD", None)
        runs[mode] = (losses, [p.detach().clone()
                               for p in model.parameters()])
        del model, dpt
        torch.cuda.empty_cache()
    check(launches["K4"] == L * K * 3 and launches["K2"] == 0 and
          launches["K3"] == 0, f"fused launches {launches}, want K4 = "
          f"{L * K * 3} and no K2/K3")
    (split_losses, split_w), (losses, w) = runs["split"], runs["fused"]
    ldiff = max(abs(a - b) for a, b in zip(losses, split_losses))
    wdiff = _max_diff(torch, w, split_w)
    check(ldiff == 0 and wdiff == 0,
          f"fused losses {losses} vs split {split_losses}: diff {ldiff}; "
          f"weights after 3 steps differ by {wdiff} (both must be 0)")
    print(f"fused backward: 3 steps, losses {losses} vs split "
          f"{split_losses}, max diff {ldiff:.3e}; weights after 3 steps max "
          f"diff {wdiff:.3e} (both must be 0); launches {launches}",
          flush=True)
    return launches["K4"]


def phase_train_card_vs_cpu(torch, lm, optimizer, loss_mod, parallel):
    """The same weights and batches train on the card and on the CPU (f32,
    base width, 2 layers, B=4, T=256): the gradients of the first batch,
    the losses of 3 Adam steps and the weights after them agree."""
    import numpy as np
    cpu = lm.transformer_lm("base", vocab_size=16384, num_layers=2,
                            device="cpu", seed=11)
    gpu = lm.transformer_lm("base", vocab_size=16384, num_layers=2, seed=12)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(9)
    batches = [(rs.randint(0, 16384, (4, 256)).astype(np.int32),
                rs.randint(0, 16384, (4, 256)).astype(np.float32))
               for _ in range(3)]
    grads, losses, weights = {}, {}, {}
    for name, net, dev in (("cuda", gpu, "cuda"), ("cpu", cpu, "cpu")):
        x, y = (torch.from_numpy(a).to(dev) for a in batches[0])
        grads[name] = torch.autograd.grad(
            SeqLoss(loss_mod)(net(x), y).float().mean(),
            list(net.parameters()))
        dpt = parallel.DataParallelTrainer(
            net, SeqLoss(loss_mod), optimizer.Adam(learning_rate=1e-3),
            micro_batches=2, device=None if dev == "cuda" else dev)
        losses[name] = [dpt.step(x, y) for x, y in batches]
        weights[name] = dict(net.named_parameters())
    # each gradient against its own largest entry, floored at 1e-3 of the
    # model's: the key bias's gradient is 0 (softmax ignores a shift shared
    # by a row's logits), so both sides hold rounding noise there
    floor = 1e-3 * max(b.abs().max().item() for b in grads["cpu"])
    gdiff, gname = max(((a.cpu() - b).abs().max().item() / max(
        b.abs().max().item(), floor), n) for n, a, b in zip(
        weights["cpu"], grads["cuda"], grads["cpu"]))
    ldiff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    # Adam's first step, lr * g / (|g| + 3.2e-7), magnifies the rounding of
    # gradient entries near 3.2e-7
    wdiffs = sorted(((_max_diff(torch, [w], [weights["cpu"][n]]), n)
                     for n, w in weights["cuda"].items()), reverse=True)
    wdiff = wdiffs[0][0]
    gtol, ltol, wtol = 5e-5, 1e-5, 5e-5
    check(gdiff <= gtol and ldiff <= ltol and wdiff <= wtol,
          f"training card vs CPU: first-batch gradients differ by {gdiff} of "
          f"their largest entry (tol {gtol}), losses card {losses['cuda']} "
          f"vs CPU {losses['cpu']} by {ldiff} (tol {ltol}), weights after 3 "
          f"steps by {wdiffs[:3]} (tol {wtol})")
    print(f"train card vs CPU, base width 2 layers f32 B4 T256 x2: "
          f"first-batch gradients max diff {gdiff:.3e} of each tensor's "
          f"largest entry, in {gname} (tol {gtol:g}); 3 Adam steps, losses "
          f"card {losses['cuda']} CPU {losses['cpu']}, max diff "
          f"{ldiff:.3e} (tol {ltol:g}); weights max diff (tol {wtol:g}) "
          + ", ".join(f"{d:.3e} in {n}" for d, n in wdiffs[:3]), flush=True)


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
    from mxtpu_torch import optimizer, parallel, serving
    from mxtpu_torch.gluon import loss as loss_mod

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
        for fn in (attention.flash_fwd, attention.flash_bwd_dq,
                   attention.flash_bwd_dkv, attention.flash_bwd_fused,
                   quant_attention.dequant_decode):
            fn.launches = n

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
    bwd = timed_phase("K2/K3/K4 checks", phase_bwd, torch, attention)
    train_launches = timed_phase("train", phase_train, torch, lm, attention,
                                 optimizer, loss_mod, parallel, counts)
    torch.cuda.empty_cache()
    k4_launches = timed_phase("fused", phase_fused, torch, lm, attention,
                              optimizer, loss_mod, parallel, counts)
    torch.cuda.empty_cache()
    timed_phase("train card vs CPU", phase_train_card_vs_cpu, torch, lm,
                optimizer, loss_mod, parallel)
    print(f"K1 launches: forward {k1_launches}, training "
          f"{train_launches['K1']}", flush=True)

    bwd_src = "mxtpu_torch/csrc/flash_bwd.cu"
    # K1 runs on two paths at two shapes and dtypes: one record each
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="mxtpu_torch/csrc/flash_fwd.cu",
             replaces="mxtpu/ops/attention.py:133", path="forward",
             launches=k1_launches, **k1["forward"]),
        dict(name="flash_fwd", route="cuda",
             source="mxtpu_torch/csrc/flash_fwd.cu",
             replaces="mxtpu/ops/attention.py:133", path="train",
             launches=train_launches["K1"], **k1["train"]),
        dict(name="flash_bwd_dq", route="cuda", source=bwd_src,
             replaces="mxtpu/ops/attention.py:182", path="train",
             launches=train_launches["K2"], **bwd["K2"]),
        dict(name="flash_bwd_dkv", route="cuda", source=bwd_src,
             replaces="mxtpu/ops/attention.py:220", path="train",
             launches=train_launches["K3"], **bwd["K3"]),
        dict(name="flash_bwd_fused", route="cuda", source=bwd_src,
             replaces="mxtpu/ops/attention.py:262",
             path="train, MXTPU_FLASH_BWD=fused", launches=k4_launches,
             **bwd["K4"]),
        dict(name="dequant_decode", route="cuda",
             source="mxtpu_torch/csrc/dequant_decode.cu",
             replaces="mxtpu/ops/quant_attention.py:99", path="serving",
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
