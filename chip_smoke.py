#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``p2pfl_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each on its own printed lines:

1. env: the card (``nvidia-smi``), torch / CUDA / nvcc versions, and the
   kernels' build from ``p2pfl_tpu_torch/csrc`` (time and ptxas report).
2. kernels: each Hopper kernel against its plain PyTorch version on the
   card at the main path's shapes (bf16 [8, 1024, 8, 64] causal; the eval
   forward at [16, 1024, 8, 64]) plus a ragged S=1000, a non-causal and an
   f32 case; bf16 outputs must lie within one bf16 ulp of the plain
   version's, f32 ones within the JAX package's f32 tolerances. Then each
   kernel's time (CUDA events over many launches after a warm-up), its
   plain version's time, the library's time as a yardstick (never called by
   the port: ``F.scaled_dot_product_attention`` for the forwards, the aten
   flash-attention backward for the dq and dk/dv pair) and its bound: the
   larger of FLOPs / 989 TFLOP/s and bytes / 3.35 TB/s (H100 SXM bf16 dense
   and HBM peaks), FLOPs counted over the causal lower triangle.
3. slice: ``MeshSimulation(task="lm")`` at the full-width LM configuration
   (8 nodes, committee 4, 64 sequences of 1024 tokens per node, vocab 8192,
   4 layers, 8 heads, width 512, batch 8, Adam lr 3e-4) for 3 rounds after a
   warm-up round on copied state; s/round, test loss (finite and falling),
   peak device memory, and each kernel's launches in that run, which must
   equal the per-round counts times the 4 rounds driven.

``--profile`` adds a fourth phase: one more round under ``torch.profiler``,
printing device time by kernel class and the device's busy share.

Any failed check exits 1 without the result lines. On success the last
three lines are the card's name and power limit, one JSON object with a row
per kernel, and ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside it, the script exits 1 and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3

# Full-width LM configuration (bench.py's --lm-mfu arm).
NODES, COMMITTEE, SEQS, SEQ_LEN, VOCAB = 8, 4, 64, 1024, 8192
LAYERS, HEADS, EMBED, BATCH, LR, ROUNDS = 4, 8, 512, 8, 3e-4, 3
N_PARAMS = 20_990_976
EVAL_SEQS = 16

KERNEL_ROWS = {  # name -> (replaced TPU kernel body, launches per round on the slice)
    "flash_fwd": ("p2pfl_tpu/ops/attention.py:183", LAYERS * (SEQS // BATCH) * COMMITTEE),
    "flash_fwd_no_lse": ("p2pfl_tpu/ops/attention.py:243", LAYERS),
    "flash_bwd_dq": ("p2pfl_tpu/ops/attention.py:326", LAYERS * (SEQS // BATCH) * COMMITTEE),
    "flash_bwd_dkv": ("p2pfl_tpu/ops/attention.py:370", LAYERS * (SEQS // BATCH) * COMMITTEE),
}
SOURCE = "p2pfl_tpu_torch/csrc/flash_attn.cu"


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, ref, what: str, atol: float, bf16_ulps: int = 0) -> float:
    """Max |got - ref|; fails unless every element is within atol plus
    ``bf16_ulps`` bf16 ulps of ``ref`` (the ulp of ``ref``'s own binade)."""
    import torch

    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    diff = (got - ref).abs()
    _, exp = torch.frexp(ref)  # ref = m * 2**exp with 0.5 <= |m| < 1
    ulp = torch.where(ref == 0, torch.zeros_like(ref), torch.ldexp(torch.ones_like(ref), exp - 8))
    ok = bool((diff <= atol + bf16_ulps * ulp).all())
    err = float(diff.max())
    tol = f"atol {atol:g}"
    if bf16_ulps:  # the largest share of the ulp allowance that an element uses
        used = ((diff - atol).clamp(min=0) / torch.where(ulp > 0, ulp, torch.ones_like(ulp))).max()
        tol += f" + {bf16_ulps} bf16 ulp (worst element uses {float(used):.2f} ulp)"
    print(f"  {what}: max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
    check(ok, f"{what} disagrees with its plain version (max_abs_err {err:.3e})")
    return err


def bound(name: str, b: int, s: int, h: int, d: int, causal: bool, esize: int) -> tuple:
    """(bound_ms, bound_by): FLOPs of the products (causal: lower triangle, as
    bench.py counts) over the bf16 peak vs bytes (each input read once, each
    output written once) over the HBM rate."""
    tri = 0.5 if causal else 1.0
    full = b * h * s * s * d  # one S x S x D product is 2 * full FLOPs
    tensor = b * s * h * d * esize
    rows = b * h * s * 4
    flops, nbytes = {
        "flash_fwd": (4 * full * tri, 4 * tensor + rows),
        "flash_fwd_no_lse": (4 * full * tri, 4 * tensor),
        "flash_bwd_dq": (6 * full * tri, 5 * tensor + 2 * rows),
        "flash_bwd_dkv": (8 * full * tri, 6 * tensor + 2 * rows),
    }[name]
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_env() -> str:
    import torch
    from p2pfl_tpu_torch.ops import _kernels

    card = nvidia_smi()
    print(f"[env] nvidia-smi: {card}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    nvcc = subprocess.run([_kernels._find_nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    print(f"[env] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    t0 = time.monotonic()
    path, log = _kernels.build()
    print(f"[env] built {path.name} in {time.monotonic() - t0:.1f} s")
    # One line per compiled kernel from the -Xptxas -v report.
    entry = None
    for line in log.splitlines():
        m = re.search(r"(flash_fwd_kernel|flash_bwd_dq_kernel|flash_bwd_dkv_kernel)I(13__nv_bfloat16|f)Li(\d+)E(?:Lb(\d)E)?", line)
        if m:
            entry = f"{m[1]}<{'bf16' if m[2] != 'f' else 'f32'}, D={m[3]}{', lse=' + m[4] if m[4] else ''}>"
        elif entry and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line)[1]
        elif entry and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            print(f"[env] ptxas {entry}: {regs} registers, {spill} bytes spilled")
            entry = None
    return card


def phase_kernels() -> dict:
    """Returns {name: row} with max_abs_err, ms, plain_ms, library_ms, bound."""
    import torch
    import torch.nn.functional as F
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def inputs(b, s, dtype=torch.bfloat16):
        return [torch.randn((b, s, HEADS, EMBED // HEADS), generator=gen).to(dev, dtype) for _ in range(4)]

    # Kernel and plain version both compute in f32 and differ only in the
    # order of their sums: a bf16 output may sit one bf16 ulp from the plain
    # one (rounding two nearly equal f32 values), and no further; 1e-6 covers
    # values so near zero that the f32 sums' own rounding shows. f32 outputs
    # are held to the JAX package's f32 tolerances (forward 1e-5, gradients
    # 1e-4), lse to 1e-5 in every case.
    tols = {torch.bfloat16: ({"atol": 1e-6, "bf16_ulps": 1},) * 2,
            torch.float32: ({"atol": 1e-5}, {"atol": 1e-4})}
    rows: dict = {}
    cases = ((SEQ_LEN, True, torch.bfloat16), (1000, True, torch.bfloat16),
             (SEQ_LEN, False, torch.bfloat16), (SEQ_LEN, True, torch.float32))
    for s, causal, dtype in cases:
        main = (s, causal, dtype) == cases[0]
        print(f"[kernels] B={BATCH} S={s} H={HEADS} D={EMBED // HEADS} {str(dtype)[6:]} causal={causal}")
        fwd_tol, grad_tol = tols[dtype]
        q, k, v, g = inputs(BATCH, s, dtype)
        out, lse = _kernels.flash_fwd(q, k, v, causal, True)
        out_p, lse_p = att.plain_flash_forward(q, k, v, causal)
        e_fwd = max(max_err(out, out_p, "flash_fwd out", **fwd_tol),
                    max_err(lse, lse_p, "flash_fwd lse", atol=1e-5))
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = _kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal)
        dk, dv = _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
        dq_p = att.plain_flash_backward_dq(q, k, v, g, lse, delta, causal)
        dk_p, dv_p = att.plain_flash_backward_dkv(q, k, v, g, lse, delta, causal)
        e_dq = max_err(dq, dq_p, "flash_bwd_dq dq", **grad_tol)
        e_dkv = max(max_err(dk, dk_p, "flash_bwd_dkv dk", **grad_tol),
                    max_err(dv, dv_p, "flash_bwd_dkv dv", **grad_tol))
        if not main:
            continue
        # Library yardsticks on the same inputs, never called by the port: the
        # SDPA forward, and the one aten call that computes the backward pair's
        # function, (dq, dk, dv) from (dO, q, k, v, out, lse), fed the outputs
        # of its own forward.
        qh, kh, vh, gh = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True), 20)
            fa = torch.ops.aten._scaled_dot_product_flash_attention(qh, kh, vh, 0.0, True, False)
            o_l, lse_l, cq, ck, mq, mk, seed, offset = fa[:8]

            def lib_bwd():
                return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                    gh, qh, kh, vh, o_l, lse_l, cq, ck, mq, mk, 0.0, True, seed, offset)

            dq_l = lib_bwd()[0]
            sdpa_bwd = time_ms(lib_bwd, 20)
        print(f"[kernels] library backward's dq against the kernel's: max_abs_err "
              f"{float((dq_l.transpose(1, 2).float() - dq.float()).abs().max()):.3e} (information only)")
        timings = {
            "flash_fwd": (lambda: _kernels.flash_fwd(q, k, v, True, True),
                          lambda: att.plain_flash_forward(q, k, v, True), sdpa_fwd, e_fwd),
            "flash_bwd_dq": (lambda: _kernels.flash_bwd_dq(q, k, v, g, lse, delta, True),
                             lambda: att.plain_flash_backward_dq(q, k, v, g, lse, delta, True), sdpa_bwd, e_dq),
            "flash_bwd_dkv": (lambda: _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, True),
                              lambda: att.plain_flash_backward_dkv(q, k, v, g, lse, delta, True), sdpa_bwd, e_dkv),
        }
        for name, (kern, plain, lib_ms, err) in timings.items():
            b_ms, b_by = bound(name, BATCH, s, HEADS, EMBED // HEADS, True, 2)
            rows[name] = {"max_abs_err": err, "ms": time_ms(kern, 20), "plain_ms": time_ms(plain, 5),
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        print(f"[kernels] library (not used by the port): sdpa forward {sdpa_fwd:.4f} ms, flash backward "
              f"(dq, dk, dv in one call; the library_ms of both backward rows) {sdpa_bwd:.4f} ms; port dq + dk/dv "
              f"{rows['flash_bwd_dq']['ms'] + rows['flash_bwd_dkv']['ms']:.4f} ms")

    # The eval forward (no logsumexp) at its own shape on the slice.
    print(f"[kernels] B={EVAL_SEQS} S={SEQ_LEN} H={HEADS} D={EMBED // HEADS} bfloat16 causal=True (no lse)")
    q, k, v, _ = inputs(EVAL_SEQS, SEQ_LEN)
    out, none = _kernels.flash_fwd(q, k, v, True, False)
    check(none is None, "the no-lse forward returned an lse")
    out_p, _ = att.plain_flash_forward(q, k, v, True)
    err = max_err(out, out_p, "flash_fwd_no_lse out", **tols[torch.bfloat16][0])
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    with torch.no_grad():
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True), 20)
    b_ms, b_by = bound("flash_fwd_no_lse", EVAL_SEQS, SEQ_LEN, HEADS, EMBED // HEADS, True, 2)
    rows["flash_fwd_no_lse"] = {
        "max_abs_err": err, "ms": time_ms(lambda: _kernels.flash_fwd(q, k, v, True, False), 20),
        "plain_ms": time_ms(lambda: att.plain_flash_forward(q, k, v, True), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
    }
    for name, r in rows.items():
        print(f"[kernels] {name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%} of it); plain {r['plain_ms']:.4f} ms (not a yardstick); "
              f"library {r['library_ms']:.4f} ms")
    return rows


def phase_slice() -> dict:
    import numpy as np
    import torch
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.models.transformer import TransformerLM, transformer_lm_model
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                                 embed_dim=EMBED, attention_kind="flash", device="cuda")
    n_params = sum(p.numel() for p in model.params.values())
    print(f"[slice] TransformerLM {LAYERS}L/{EMBED}d/{HEADS}h vocab {VOCAB}: {n_params} params")
    check(n_params == N_PARAMS, f"expected {N_PARAMS} params, got {n_params}")

    # Reference on a small input: the flash path against dense attention.
    with torch.device("meta"):
        dense = TransformerLM(vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                              embed_dim=EMBED, attention_kind="dense")
    toks = torch.randint(0, VOCAB, (2, 256), generator=torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        got = model.apply(model.params, toks)
        ref = ModelHandle(model.params, dense).apply(model.params, toks)
    check(got.shape == (2, 256, VOCAB), f"logits shape {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    print(f"[slice] flash vs dense logits on [2, 256]: max_abs_err={err:.3e} tol 6e-2")
    check(bool(torch.isfinite(got).all()) and err <= 6e-2, "flash logits disagree with dense attention")

    # Synthetic tokens as bench.py's --lm-mfu arm makes them.
    rng = np.random.default_rng(5)
    starts = rng.integers(0, VOCAB, size=(NODES, SEQS, 1))
    x = ((starts + np.arange(SEQ_LEN)[None, None, :]) % VOCAB).astype(np.int32)
    y = np.zeros((NODES, SEQS), np.int32)
    mask = np.ones((NODES, SEQS), np.float32)
    xt = ((rng.integers(0, VOCAB, size=(EVAL_SEQS, 1)) + np.arange(SEQ_LEN)) % VOCAB).astype(np.int32)
    sim = MeshSimulation(model, (x, y, mask), test_data=(xt, None), train_set_size=COMMITTEE,
                         batch_size=BATCH, lr=LR, seed=1, task="lm", device="cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    res = sim.run(rounds=ROUNDS, epochs=1, warmup=True)
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    print(f"[slice] {ROUNDS} rounds: {res.seconds_per_round:.4f} s/round "
          f"({res.seconds_total:.3f} s, host clock ending in torch.cuda.synchronize())")
    print(f"[slice] test loss per round: {res.test_loss}")
    print(f"[slice] test token accuracy per round: {res.test_acc}")
    print(f"[slice] committees: {res.committees.tolist()}")
    print(f"[slice] max_memory_allocated: {peak} bytes ({peak / 2**30:.2f} GiB)")
    print(f"[slice] kernels: {json.dumps(launches)}")
    check(all(np.isfinite(res.test_loss)), "non-finite test loss")
    check(res.test_loss[-1] < res.test_loss[0], "test loss did not fall over the rounds")
    for name, (_, per_round) in KERNEL_ROWS.items():
        # run() drives the warm-up round and then the timed rounds.
        check(launches[name] > 0, f"{name} was never launched on the main path")
        check(launches[name] == per_round * (ROUNDS + 1),
              f"{name}: {launches[name]} launches, expected {per_round} per round x {ROUNDS + 1} "
              f"(warm-up + {ROUNDS})")
    return launches, sim


def phase_profile(sim) -> None:
    """One more round under torch.profiler: device time by kernel class, the
    round's wall time under the profiler, and the device's busy share of it
    (an upper bound on idle, since tracing slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        sim.run(rounds=1, warmup=False)
        wall_us = (time.monotonic() - t0) * 1e6
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:  # older layouts attach kernels to the CPU op that launched them
        kernels = [(k.name, k.duration) for e in prof.events() for k in getattr(e, "kernels", [])]
    check(bool(kernels), "the profiler recorded no CUDA kernel")
    classes: dict = {}
    by_name: dict = {}
    for name, us in kernels:
        low = name.lower()
        cls = ("flash kernels (this port)" if "flash_" in low and "kernel" in low
               else "GEMM (cuBLAS)" if any(t in low for t in ("gemm", "cutlass", "nvjet", "xmma", "cublas"))
               else "memcpy/memset" if "memcpy" in low or "memset" in low
               else "elementwise/reduction/other")
        classes[cls] = classes.get(cls, 0.0) + us
        by_name[name] = by_name.get(name, 0.0) + us
    busy = sum(classes.values())
    print(f"[profile] one round under torch.profiler: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({busy / wall_us:.1%}), {len(kernels)} kernel launches")
    for cls, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {cls}: {us / 1e3:.1f} ms ({us / busy:.1%} of device time)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile]   top: {us / 1e3:8.2f} ms  {name[:110]}")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on the card", file=sys.stderr)
        return 1
    try:
        import p2pfl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the p2pfl_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = phase_env()
        rows = phase_kernels()
        launches, sim = phase_slice()
        if "--profile" in sys.argv[1:]:
            phase_profile(sim)
    except Exception as e:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    table = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": launches[name], **rows[name]}
        for name, (replaces, _) in KERNEL_ROWS.items()
    ]
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
