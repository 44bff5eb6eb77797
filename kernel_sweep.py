#!/usr/bin/env python3
"""Sweep of the attention kernels on one NVIDIA GPU, route by route: K1
(``flash_fwd``), K2 (``flash_bwd_dq``), K3 (``flash_bwd_dkv``) and K4
(``flash_bwd_fused``) over ragged, causal, T != Tk, wide-head and training
shapes, each against its plain PyTorch version; the timed shapes also
against ``scaled_dot_product_attention`` (its forward for K1, its backward
for K2, K3 and K4). K4 is also held bit for bit against K2 + K3 and timed
beside them. The sm90 kinds (``fwd``, ``dq``, ``bwd``, ``fused``) run the
tensor-core route in bf16; the simt kinds (``simt-fwd``, ``simt-dq``,
``simt-bwd``, ``simt-fused``) run the CUDA-core route in f32 at D = 40,
64, 128 and 256 and in bf16 at the head dims the tensor-core route
refuses (D = 36, 100 and 256). The ``decode`` kind runs K5
(``dequant_decode``) over slots S = 1, 8, 32, buckets TOT = 32 to 2048,
head dims D = 40 to 512, int8 and fp8 caches, q in f32 and bf16 and
ragged cursors, against its plain version; its timed cases on a CUDA graph
(``chip_smoke.graph_ms``) beside the launch floor and the byte bound.

    python3 kernel_sweep.py build [simt]             # registers, spills, SASS
    python3 kernel_sweep.py drive fwd bwd dq fused   # faults isolated
    python3 kernel_sweep.py drive simt-fwd simt-dq simt-bwd simt-fused
    python3 kernel_sweep.py build && python3 kernel_sweep.py drive decode

``drive`` runs the cases of each kind in a child process and, when a case
faults (a kernel fault poisons the process's CUDA context), starts a new
child at the next case, so one run names every faulting case. Tolerances
are ``chip_smoke.py``'s: K1 out 1e-4 in f32 and 1e-2 in bf16, lse 1e-4;
K2-K4 1e-4 x max(|ref|, 1) in f32 and 2e-2 x max(|ref|, 1) in bf16; K5
1e-5 x max(|ref|, 1) (bf16 q: plus half a bf16 step of each output). Every
case must take its kind's route. ``fused`` takes the shapes with T == Tk.
The last line is ``TOTAL FAILS n``; the exit code is 1 if n > 0.
"""

import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

F32, BF = "float32", "bfloat16"
# (B, H, T, Tk, D, causal, dtype, timed)
FWD = [(1, 1, 128, 128, 64, False, BF, False),
       (1, 1, 128, 128, 64, True, BF, False),
       (2, 3, 77, 130, 40, False, BF, False),
       (1, 2, 300, 300, 128, True, BF, False),
       (4, 12, 1000, 1000, 64, True, BF, False),
       (2, 4, 1000, 1021, 64, False, BF, False),
       (2, 2, 256, 256, 128, True, BF, False),
       (2, 2, 333, 200, 64, True, BF, False),
       (4, 12, 1024, 1024, 64, True, BF, True),
       (8, 16, 1024, 1024, 64, True, BF, True),
       (8, 16, 1024, 1024, 128, True, BF, True)]
SIMT_FWD = [(2, 3, 77, 130, 40, False, F32, False),
            (1, 2, 300, 300, 40, True, F32, False),
            (4, 12, 1000, 1000, 64, True, F32, False),
            (2, 4, 1000, 1021, 64, False, F32, False),
            (2, 3, 333, 200, 64, True, F32, False),
            (2, 3, 200, 333, 64, True, F32, False),
            (1, 4, 300, 300, 128, True, F32, False),
            (2, 2, 256, 256, 128, False, F32, False),
            (1, 2, 200, 200, 256, True, F32, False),
            (1, 2, 77, 130, 256, False, F32, False),
            (2, 3, 77, 130, 36, False, BF, False),
            (2, 4, 1000, 1021, 36, True, BF, False),
            (1, 2, 200, 200, 256, True, BF, False),
            (1, 2, 333, 200, 256, True, BF, False),
            (1, 2, 300, 300, 100, True, BF, False),
            (4, 12, 1024, 1024, 64, True, F32, True),
            (4, 12, 1024, 1024, 128, True, F32, True),
            (4, 12, 1024, 1024, 256, True, F32, True),
            (4, 12, 1024, 1024, 36, True, BF, True),
            (4, 12, 1024, 1024, 256, True, BF, True)]
# (B, H, T, Tk, D, causal, bf16 lse/Delta rows, dtype, timed)
BWD = [(1, 1, 128, 128, 64, False, False, BF, False),
       (1, 1, 128, 128, 64, True, False, BF, False),
       (2, 3, 128, 130, 40, False, False, BF, False),
       (2, 3, 77, 130, 40, False, False, BF, False),
       (2, 3, 77, 77, 40, True, True, BF, False),
       (2, 4, 1000, 1021, 40, True, False, BF, False),
       (1, 4, 300, 300, 128, True, False, BF, False),
       (1, 4, 200, 333, 128, True, False, BF, False),
       (1, 4, 333, 200, 128, False, True, BF, False),
       (2, 3, 200, 333, 64, True, False, BF, False),
       (2, 3, 333, 200, 64, True, False, BF, False),
       (2, 4, 512, 512, 64, True, True, BF, False),
       (1, 2, 256, 256, 128, False, True, BF, False),
       (8, 16, 1024, 1024, 64, True, False, BF, True),
       (8, 16, 1024, 1024, 128, True, False, BF, True)]
SIMT_BWD = [(2, 3, 77, 130, 40, False, False, F32, False),
            (2, 3, 150, 150, 40, True, True, F32, False),
            (2, 4, 1000, 1021, 64, True, False, F32, False),
            (2, 4, 1000, 1000, 64, True, False, F32, False),
            (2, 3, 200, 333, 64, True, False, F32, False),
            (2, 3, 333, 200, 64, False, True, F32, False),
            (2, 4, 512, 512, 64, True, True, F32, False),
            (1, 4, 300, 300, 128, True, False, F32, False),
            (1, 4, 200, 333, 128, True, False, F32, False),
            (1, 2, 200, 200, 256, True, True, F32, False),
            (1, 2, 130, 77, 256, False, False, F32, False),
            (2, 3, 77, 130, 36, False, False, BF, False),
            (2, 3, 150, 150, 36, True, True, BF, False),
            (1, 2, 200, 200, 256, True, False, BF, False),
            (1, 2, 200, 333, 256, True, True, BF, False),
            (1, 2, 333, 333, 100, False, False, BF, False),
            (8, 16, 1024, 1024, 64, True, False, F32, True),
            (4, 12, 1024, 1024, 128, True, False, F32, True),
            (4, 12, 1024, 1024, 36, True, False, BF, True),
            (4, 12, 1024, 1024, 256, True, False, BF, True)]
# K5: (S, H, TOT, D, cache, q dtype, cursors, timed); cursors as
# chip_smoke.k5_cursors: ragged (0, TOT - 1 and between), last (TOT - 1),
# early (every cursor in chunk 0 of a split cache; also read by the next
# kernel of a CUDA graph)
DECODE = [(1, 12, 32, 64, "int8", F32, "last", False),
          (1, 12, 96, 40, "fp8", BF, "last", False),
          (1, 12, 256, 128, "int8", BF, "last", False),
          (1, 12, 1024, 256, "fp8", F32, "last", False),
          (1, 12, 2048, 512, "int8", F32, "last", False),
          (8, 12, 32, 40, "int8", F32, "ragged", False),
          (8, 12, 96, 512, "fp8", BF, "ragged", False),
          (8, 12, 256, 256, "int8", F32, "ragged", False),
          (8, 16, 1024, 128, "fp8", BF, "ragged", False),
          (8, 12, 2048, 64, "fp8", F32, "ragged", False),
          (32, 12, 32, 512, "fp8", F32, "ragged", False),
          (32, 12, 96, 64, "int8", BF, "ragged", False),
          (32, 12, 256, 40, "fp8", F32, "ragged", False),
          (32, 12, 1024, 256, "int8", BF, "ragged", False),
          (32, 4, 2048, 128, "int8", F32, "ragged", False),
          (1, 12, 704, 64, "int8", F32, "early", False),
          (1, 12, 2048, 512, "fp8", BF, "early", False),
          (8, 12, 1024, 64, "fp8", BF, "early", False),
          (8, 12, 2048, 40, "int8", F32, "early", False),
          (1, 12, 704, 64, "int8", F32, "last", True),
          (1, 12, 704, 64, "fp8", F32, "last", True),
          (1, 12, 2048, 64, "int8", F32, "last", True),
          (8, 12, 1024, 64, "int8", F32, "ragged", True),
          (8, 12, 1024, 64, "int8", BF, "ragged", True),
          (8, 12, 2048, 64, "int8", F32, "last", True),
          (8, 16, 1024, 128, "int8", F32, "last", True),
          (32, 12, 1024, 64, "fp8", F32, "last", True),
          (8, 12, 1024, 512, "int8", F32, "ragged", True)]
NAMES = {"sm90": ("flash_fwd_sm90", "flash_bwd_sm90", "dequant_decode"),
         "simt": ("flash_fwd", "flash_bwd")}
# backward kind: (kernel, wrapper, indices of (dq, dk, dv) it returns)
BWD_KINDS = {"dq": ("K2", "flash_bwd_dq", (0,)),
             "bwd": ("K3", "flash_bwd_dkv", (1, 2)),
             "fused": ("K4", "flash_bwd_fused", (0, 1, 2))}


def timed(torch, fn, iters=20):
    """Mean device time of ``fn`` (CUDA events, after 3 warm-up calls)."""
    for _ in range(3):
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


def build(route):
    from mxtpu_torch import _build
    names = NAMES[route]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.time()
    print(_build.build_all(names), time.time() - t0, flush=True)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    for name in names:
        for ln in _build.build_log(name).splitlines():
            if any(w in ln for w in ("registers", "spill", "arning",
                                     "Function properties")):
                print(name, ln.strip()[:200])
        if route == "sm90":
            sass = subprocess.run([cuobjdump, "-sass",
                                   _build.lib_path(name)],
                                  capture_output=True, text=True).stdout
            print(name, "HGMMA", sass.count("HGMMA"), "UTMALDG",
                  sass.count("UTMALDG"), "LDGSTS", sass.count("LDGSTS"),
                  flush=True)


def took_route(fn, n0, route):
    """Whether ``fn`` launched once since its counts were ``n0`` (launches,
    sm90 launches), on ``route``."""
    return (fn.launches - n0[0], fn.sm90_launches - n0[1]) == (
        1, int(route == "sm90"))


def fwd_case(torch, A, F, case, g, route):
    B, H, T, Tk, D, causal, dtype, do_time = case
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    q = torch.randn(B, H, T, D, device=dev, generator=g).to(dt)
    k = torch.randn(B, H, Tk, D, device=dev, generator=g).to(dt)
    v = torch.randn(B, H, Tk, D, device=dev, generator=g).to(dt)
    sc = 1 / math.sqrt(D)
    fn = A.flash_fwd
    n0 = (fn.launches, fn.sm90_launches)
    out, lse = fn(q, k, v, causal, sc)
    ref, ref_lse = A._chunk_reference_lse(q, k, v, causal, sc)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lerr = (lse - ref_lse).abs().max().item()
    tol = 1e-4 if dt == torch.float32 else 1e-2
    ok = err <= tol and lerr <= 1e-4 and took_route(fn, n0, route)
    line = (f"K1 {route} {dtype} B{B} H{H} T{T} Tk{Tk} D{D} causal={causal}"
            f": err {err:.3e} (tol {tol:g}) lse {lerr:.3e} "
            f"{'OK' if ok else 'FAIL'}")
    if do_time:
        ms = timed(torch, lambda: fn(q, k, v, causal, sc))
        lib = timed(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=sc))
        line += f"; kernel {ms:.4f} ms sdpa {lib:.4f} ms ratio {ms / lib:.2f}"
    return ok, line


def bwd_case(torch, A, F, case, g, kind, route):
    B, H, T, Tk, D, causal, rows_bf16, dtype, do_time = case
    kern, wrapper, which = BWD_KINDS[kind]
    fn = getattr(A, wrapper)
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    q, do = (torch.randn(B, H, T, D, device=dev, generator=g).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, H, Tk, D, device=dev, generator=g).to(dt)
            for _ in range(2))
    dlse = torch.randn(B, H, T, device=dev, generator=g)
    sc = 1 / math.sqrt(D)
    out, lse = A._chunk_reference_lse(q, k, v, causal, sc)
    os.environ["MXTPU_FLASH_LSE"] = "bf16" if rows_bf16 else ""
    rows = A._bwd_rows(out, lse, do, dlse)
    os.environ.pop("MXTPU_FLASH_LSE")
    args = (q, k, v, do) + rows + (causal, sc)
    ref = A._flash_bwd_plain(*args)
    n0 = (fn.launches, fn.sm90_launches)
    outs = fn(*args)
    outs = (outs,) if kind == "dq" else outs
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else 2e-2
    errs = [((o.float() - ref[i].float()).abs().max().item(),
             tol * max(ref[i].float().abs().max().item(), 1.0))
            for o, i in zip(outs, which)]
    ok = all(e <= t for e, t in errs) and took_route(fn, n0, route)
    line = (f"{kern} {route} {dtype} B{B} H{H} T{T} Tk{Tk} D{D} causal="
            f"{causal} rows_bf16={rows_bf16}: "
            + ", ".join(f"{e:.3e}/{t:.3e}" for e, t in errs))
    if kind == "fused":
        split = (A.flash_bwd_dq(*args),) + A.flash_bwd_dkv(*args)
        same = all(torch.equal(a, b) for a, b in zip(outs, split))
        ok = ok and same
        line += ("; bit-equal to K2 + K3" if same
                 else "; DIFFERS from K2 + K3")
    line += " OK" if ok else " FAIL"
    if do_time:
        ms = timed(torch, lambda: fn(*args), 10)
        qs, ks, vs = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))

        def fwd_bwd():
            F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                           scale=sc).backward(do)

        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                               scale=sc)

        lib = timed(torch, fwd_bwd, 10) - timed(torch, fwd, 10)
        line += (f"; kernel {ms:.4f} ms sdpa bwd {lib:.4f} ms ratio "
                 f"{ms / lib:.2f}")
        if kind == "fused":
            split_ms = timed(torch, lambda: (A.flash_bwd_dq(*args),
                                             A.flash_bwd_dkv(*args)), 10)
            line += (f"; K2 + K3 {split_ms:.4f} ms, K4 / (K2 + K3) "
                     f"{ms / split_ms:.3f}")
    return ok, line


def decode_case(torch, case, g):
    """One K5 case against its plain version; a timed case also on a CUDA
    graph, cycling through enough caches (at most 12, one a layer) that
    the bytes read between two reads of one exceed the 50 MB L2 where 12
    do."""
    import chip_smoke as cs
    from mxtpu_torch.ops import quant_attention as qa
    from mxtpu_torch.quant import kv_quant
    S, H, TOT, D, mode, dtype, how, do_time = case
    q = torch.randn(S, H, D, device="cuda", generator=g).to(
        getattr(torch, dtype))
    one = 2 * S * H * TOT * (D + 4)
    n = min(cs.K5_CACHES, max(2, -(-100_000_000 // one))) \
        if do_time or how == "early" else 1
    caches = cs.k5_caches(torch, kv_quant, g, S, H, TOT, D, mode, n)
    C = qa._card_chunk(q.device, S, H, TOT, D)
    pc = cs.k5_cursors(torch, g, S, TOT, how, C)
    sc = 1 / math.sqrt(D)
    n0 = qa.dequant_decode.launches
    out = qa.dequant_decode(q, *caches[0], pc, sc)
    ref = qa._decode_plain(q.float(), *caches[0], pc, sc)
    torch.cuda.synchronize()
    err = cs.k5_error(torch, out, ref)
    tol = 1e-5 * max(ref.abs().max().item(), 1.0)
    ok = err <= tol and qa.dequant_decode.launches - n0 == 1 \
        and out.dtype == q.dtype
    if how == "early":
        err = max(err, cs.k5_followed(torch, qa, q, caches, pc, sc))
        ok = ok and TOT > C and err <= tol
    line = (f"K5 {mode} q {dtype} S{S} H{H} TOT{TOT} D{D} pc={pc.tolist()} "
            f"C{C} blocks {S * H * -(-TOT // C)}: err {err:.3e} (tol "
            f"{tol:.3e}) {'OK' if ok else 'FAIL'}")
    if do_time:
        turn = [0]

        def call():
            turn[0] += 1
            return qa.dequant_decode(q, *caches[turn[0] % n], pc, sc)

        ms = cs.graph_ms(torch, call, 10 * n)
        floor = cs.launch_floor_ms(torch, 10 * n)
        nbytes, rows = cs.k5_bytes(pc, H, TOT, D, q)
        bound, _ = cs._bound(4.0 * rows * D, nbytes, "float32")
        line += (f"; kernel {ms:.5f} ms (graph, {n} caches of "
                 f"{one / 1e6:.1f} MB), launch floor {floor:.5f} ms, bound "
                 f"{bound:.5f} ms, kernel / bound {ms / bound:.2f}")
    return ok, line


def split_kind(kind):
    """``(route, kind)``: ``simt-dq`` is the dq kind on the simt route."""
    return ("simt", kind[5:]) if kind.startswith("simt-") else ("sm90",
                                                                 kind)


def cases_of(kind):
    """The cases of one kind: K4 takes only self-attention (T == Tk)."""
    if kind == "decode":
        return DECODE
    route, base = split_kind(kind)
    if base == "fwd":
        return SIMT_FWD if route == "simt" else FWD
    cases = SIMT_BWD if route == "simt" else BWD
    return [c for c in cases if base != "fused" or c[2] == c[3]]


def run(kind, start):
    """Cases of one kind from index ``start``, printing ``DONE i`` after
    each and ``FAILS n`` at the end."""
    import torch
    import torch.nn.functional as F
    from mxtpu_torch.ops import attention as A
    route, base = split_kind(kind)
    cases = cases_of(kind)
    fails = 0
    for idx in range(start, len(cases)):
        g = torch.Generator(device="cuda").manual_seed(idx)
        if kind == "decode":
            ok, line = decode_case(torch, cases[idx], g)
        elif base == "fwd":
            ok, line = fwd_case(torch, A, F, cases[idx], g, route)
        else:
            ok, line = bwd_case(torch, A, F, cases[idx], g, base, route)
        fails += not ok
        print(line, flush=True)
        print(f"DONE {idx}", flush=True)
    print(f"FAILS {fails}", flush=True)


def drive(kinds):
    total = 0
    for kind in kinds:
        n, start = len(cases_of(kind)), 0
        while start < n:
            p = subprocess.run([sys.executable, __file__, kind, str(start)],
                               capture_output=True, text=True, timeout=300)
            print(p.stdout, end="")
            done = [int(ln.split()[1]) for ln in p.stdout.splitlines()
                    if ln.startswith("DONE")]
            finished = "FAILS" in p.stdout
            if p.returncode != 0 or not finished:
                print(f"CRASH in {kind} case "
                      f"{done[-1] + 1 if done else start}: rc "
                      f"{p.returncode}\n{p.stderr[-1500:]}", flush=True)
                total += 1
            total += sum(int(ln.split()[1]) for ln in p.stdout.splitlines()
                         if ln.startswith("FAILS"))
            start = (done[-1] + 1 if done else start) + (0 if finished
                                                         else 1)
    print("TOTAL FAILS", total)
    return total


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    if sys.argv[1] == "build":
        build(sys.argv[2] if len(sys.argv) > 2 else "sm90")
    elif sys.argv[1] == "drive":
        sys.exit(1 if drive(sys.argv[2:]) else 0)
    else:
        run(sys.argv[1], int(sys.argv[2]))
