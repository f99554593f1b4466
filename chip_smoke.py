#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``p2pfl_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each on its own printed lines:

1. env: the card (``nvidia-smi``), torch / CUDA / nvcc versions, and the
   kernels' build from ``p2pfl_tpu_torch/csrc`` (time and ptxas report:
   registers and spills of each kernel; the tensor-core forward, backward
   and carry kernels must not spill, and no bf16 instance of a CUDA-core
   kernel may be compiled), and the count of ``HGMMA`` (wgmma)
   instructions in each tensor-core kernel from ``cuobjdump -sass`` (each
   must have some).
2. kernels: each Hopper kernel against its plain PyTorch version on the
   card at the main paths' shapes (bf16 [8, 1024, 8, 64] causal; the eval
   forward at [16, 1024, 8, 64]) plus a ragged S=1000, a non-causal, causal
   S=1 and S=129 (one partial q tile; one full tile and a row) and an f32
   case; the bf16 forward's output must lie within 1e-6 + 1 bf16 ulp +
   2^-15 of its row's weighted mass sum_j (p_j / l) |v_j| of the plain
   version's (it splits P into two bf16 halves for the tensor cores), the
   bf16 gradients within 1e-6 + 1 bf16 ulp + 2^-15 of their weighted mass
   (``plain_flash_grad_mass``: scale |dS| @ |K|, scale |dS|^T @ |Q|,
   P^T @ |dO|, with dS's own f32 rounding floor beside |dS|; the backward
   splits dS, dS^T and P^T alike), f32 outputs
   within the JAX package's f32 tolerances, lse within 1e-5; the forward
   without lse must equal the one with it bit for bit. Then each
   kernel's time (CUDA events over many launches after a warm-up), its
   plain version's time, the library's time as a yardstick (never called by
   the port: ``aten._scaled_dot_product_flash_attention``, which also returns
   the logsumexp, for the forward with lse; ``F.scaled_dot_product_attention``
   for the one without; the aten
   flash-attention backward for the dq and dk/dv pair) and its bound: the
   larger of FLOPs / 989 TFLOP/s and bytes / 3.35 TB/s (H100 SXM bf16 dense
   and HBM peaks), FLOPs counted over the causal lower triangle.
   The ring's carry kernel at its chunk shape [2, 1024, 8, 64]: the
   diagonal fold into a fresh carry (shard 7 of 8), a past fold into that
   carry, a wholly future fold (the carry must come back bit-identical), a
   fold whose diagonal crosses a key tile (kv_offset = q_offset - 100), a
   ragged non-causal 1000 x 1000 fold, diagonal and past folds of chunks
   of 129 and 1, and f32; m to 1e-5 (bf16; f32 1e-6), l to
   1e-5 + 1e-5 |ref|, acc to that plus 1e-6 l (its rounding scales with the
   row's weight mass) plus, for bf16 (P split into two bf16 halves),
   2^-15 of the fold's mass exp(S - m_new) @ |V|
   (``plain_flash_chunk_mass``); the past fold's finalized bf16 output
   within one bf16 ulp (+ 2^-15 mass / l for bf16). No PyTorch call folds
   a chunk into an unnormalized carry, so its row has no library time;
   SDPA on the same chunk is printed for information.
3. slice: ``MeshSimulation(task="lm")`` at the full-width LM configuration
   (8 nodes, committee 4, 64 sequences of 1024 tokens per node, vocab 8192,
   4 layers, 8 heads, width 512, batch 8, Adam lr 3e-4) for 3 rounds after a
   warm-up round on copied state; s/round, test loss (finite and falling),
   peak device memory, and each kernel's launches in that run, which must
   equal the per-round counts times the 4 rounds driven.
4. ring: the same LM with ``attention_kind="ring_flash"`` over a sequence of
   8192 tokens sharded on a virtual ``"seq"`` axis of 8. Its logits on a
   [2, 2048] input against the flash model's (6e-2); then
   ``make_sequence_parallel_train_step`` (batch 2, Adam lr 3e-4), one
   warm-up step and 4 timed steps: s/step, the loss of every step (finite
   and falling), peak device memory, and exactly 144 carry launches per
   step (4 layers x 36 folds).

``--profile`` adds one more slice round and one more ring train step, each
under ``torch.profiler``, printing device time by kernel class and the
device's busy share.

Any failed check exits 1 without the result lines. On success the last
three lines are the card's name and power limit, one JSON object with a row
per kernel, and ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside it, the script exits 1 and prints no result.
"""

from __future__ import annotations

import gc
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

SOURCE_FWD = "p2pfl_tpu_torch/csrc/flash_fwd_sm90.cu"  # the bf16 forward (slice) and carry fold (ring)
SOURCE_BWD = "p2pfl_tpu_torch/csrc/flash_bwd_sm90.cu"  # the bf16 backward pair the slice runs
KERNEL_ROWS = {  # name -> (replaced TPU kernel body, launches per round on the slice, source)
    "flash_fwd": ("p2pfl_tpu/ops/attention.py:183", LAYERS * (SEQS // BATCH) * COMMITTEE, SOURCE_FWD),
    "flash_fwd_no_lse": ("p2pfl_tpu/ops/attention.py:243", LAYERS, SOURCE_FWD),
    "flash_bwd_dq": ("p2pfl_tpu/ops/attention.py:326", LAYERS * (SEQS // BATCH) * COMMITTEE, SOURCE_BWD),
    "flash_bwd_dkv": ("p2pfl_tpu/ops/attention.py:370", LAYERS * (SEQS // BATCH) * COMMITTEE, SOURCE_BWD),
}

# Sequence-parallel (ring) configuration: the same model over 8192 tokens
# in 8 shards of 1024 (the tutorial's length, the JAX tests' largest ring).
RING_SHARDS, RING_SEQ, RING_BATCH, RING_STEPS = 8, 8192, 2, 4
RING_SHARD = RING_SEQ // RING_SHARDS
RING_FOLDS = LAYERS * RING_SHARDS * (RING_SHARDS + 1) // 2  # carry launches per forward
RING_KERNEL_ROWS = {  # name -> (replaced TPU kernel body, launches per train step on the ring, source)
    "flash_carry": ("p2pfl_tpu/ops/attention.py:485", RING_FOLDS, SOURCE_FWD),
}


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
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls. A
    device-side sleep holds the stream first, long enough that every call is
    queued before the first one runs, so a kernel shorter than its host-side
    launch is timed by the device and not by the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0  # host and device time of one call
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.0, 2 * iters * one + 1e-3) * 2e9))  # cycles, at most ~1 s at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, ref, what: str, atol: float, bf16_ulps: int = 0, mass=None) -> float:
    """Max |got - ref|; fails unless every element is within atol plus
    ``bf16_ulps`` bf16 ulps of ``ref`` (the ulp of ``ref``'s own binade),
    plus ``2^-15 * mass`` where a weighted mass is given (the bf16 forward:
    ``mass = (P / l) @ |V|``; the bf16 gradients: ``plain_flash_grad_mass``;
    both from the plain side)."""
    import torch

    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    diff = (got - ref).abs()
    _, exp = torch.frexp(ref)  # ref = m * 2**exp with 0.5 <= |m| < 1
    ulp = torch.where(ref == 0, torch.zeros_like(ref), torch.ldexp(torch.ones_like(ref), exp - 8))
    room = 2.0**-15 * mass if mass is not None else torch.zeros_like(ref)
    ok = bool((diff <= atol + bf16_ulps * ulp + room).all())
    err = float(diff.max())
    tol = f"atol {atol:g}"
    if bf16_ulps:  # the largest share of the ulp allowance that an element uses
        used = ((diff - atol).clamp(min=0) / torch.where(ulp > 0, ulp, torch.ones_like(ulp))).max()
        tol += f" + {bf16_ulps} bf16 ulp (worst element uses {float(used):.2f} ulp)"
    if mass is not None:  # the largest share of the mass term that an element needs beyond atol + ulps
        past = (diff - atol - bf16_ulps * ulp).clamp(min=0)
        used = (past / torch.where(room > 0, room, torch.ones_like(room))).max()
        tol += f" + 2^-15 mass (worst element uses {float(used):.3f} of it)"
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
    entry, seen = None, []
    for line in log.splitlines():
        m = re.search(r"(flash_fwd_kernel|flash_bwd_dq_kernel|flash_bwd_dkv_kernel|flash_carry_kernel)"
                      r"I(13__nv_bfloat16|f)Li(\d+)E(?:Lb(\d)E)?", line)
        m90 = re.search(r"flash_fwd_sm90_kernelILb(\d)E", line)
        mb90 = re.search(r"(flash_bwd_dq_sm90_kernel|flash_bwd_dkv_sm90_kernel|flash_carry_sm90_kernel)", line)
        if m:
            entry = f"{m[1]}<{'bf16' if m[2] != 'f' else 'f32'}, D={m[3]}{', lse=' + m[4] if m[4] else ''}>"
        elif m90:
            entry = f"flash_fwd_sm90_kernel<bf16, D=64, lse={m90[1]}>"
        elif mb90:
            entry = f"{mb90[1]}<bf16, D=64>"
        elif entry and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line)[1]
        elif entry and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            print(f"[env] ptxas {entry}: {regs} registers, {spill} bytes spilled")
            seen.append(entry)
            if "_sm90_kernel" in entry:  # the tensor-core kernels
                check(spill == "0", f"{entry} spills {spill} bytes")
            entry = None
    check(sum(e.startswith("flash_fwd_sm90") for e in seen) == 2,
          "the build log lacks the two tensor-core forward instances")
    check(all(any(e.startswith(f"flash_bwd_{k}_sm90") for e in seen) for k in ("dq", "dkv")),
          "the build log lacks a tensor-core backward kernel")
    check(any(e.startswith("flash_carry_sm90_kernel") for e in seen),
          "the build log lacks the tensor-core carry kernel")
    for simt in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_carry_kernel"):
        check(not any(e.startswith(f"{simt}<bf16") for e in seen),
              f"a bf16 instance of the CUDA-core {simt} was compiled")
    phase_sass(path, _kernels._find_nvcc())
    return card


def phase_sass(lib, nvcc: str) -> None:
    """Count the HGMMA (wgmma) instructions in each forward, backward and
    carry kernel of the built library with ``cuobjdump -sass``, found beside
    ``nvcc``."""
    import os

    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(tool):
        print("[env] HGMMA per forward / backward / carry kernel: not measured (no cuobjdump beside nvcc)")
        return
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()[-500:]}")
    counts: dict = {}
    fn = None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m[1]
            counts.setdefault(fn, 0)
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    shown = {name: n for name, n in counts.items() if re.search(r"flash_(fwd|bwd|carry)", name)}
    for name, n in sorted(shown.items()):
        print(f"[env] HGMMA in {name}: {n}")
    sm90 = [n for name, n in shown.items() if "flash_fwd_sm90_kernel" in name]
    check(len(sm90) == 2 and all(n > 0 for n in sm90), "a bf16 forward instance holds no HGMMA instruction")
    bwd90 = [n for name, n in shown.items() if "flash_bwd_dq_sm90" in name or "flash_bwd_dkv_sm90" in name]
    check(len(bwd90) == 2 and all(n > 0 for n in bwd90), "a bf16 backward kernel holds no HGMMA instruction")
    carry90 = [n for name, n in shown.items() if "flash_carry_sm90" in name]
    check(len(carry90) == 1 and carry90[0] > 0, "the bf16 carry kernel holds no HGMMA instruction")


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
    # values so near zero that the f32 sums' own rounding shows. The bf16
    # forward multiplies P as two bf16 halves (within 2^-17 P of P), so its
    # output gets 2^-15 of the row's weighted mass (P / l) @ |V| beyond that;
    # the bf16 backward splits dS, dS^T and P^T alike, so each gradient gets
    # 2^-15 of its own weighted mass (plain_flash_grad_mass).
    # f32 outputs are held to the JAX package's f32 tolerances (forward
    # 1e-5, gradients 1e-4), lse to 1e-5 in every case.
    tols = {torch.bfloat16: ({"atol": 1e-6, "bf16_ulps": 1},) * 2,
            torch.float32: ({"atol": 1e-5}, {"atol": 1e-4})}
    rows: dict = {}
    cases = ((SEQ_LEN, True, torch.bfloat16), (1000, True, torch.bfloat16),
             (SEQ_LEN, False, torch.bfloat16), (1, True, torch.bfloat16), (129, True, torch.bfloat16),
             (SEQ_LEN, True, torch.float32))
    for s, causal, dtype in cases:
        main = (s, causal, dtype) == cases[0]
        print(f"[kernels] B={BATCH} S={s} H={HEADS} D={EMBED // HEADS} {str(dtype)[6:]} causal={causal}")
        fwd_tol, grad_tol = tols[dtype]
        q, k, v, g = inputs(BATCH, s, dtype)
        out, lse = _kernels.flash_fwd(q, k, v, causal, True)
        out_p, lse_p = att.plain_flash_forward(q, k, v, causal)
        if dtype == torch.bfloat16:  # the tensor-core forward splits P: its bar adds 2^-15 of the mass
            fwd_tol = {**fwd_tol, "mass": att.plain_flash_row_mass(q, k, v, causal)}
        e_fwd = max(max_err(out, out_p, "flash_fwd out", **fwd_tol),
                    max_err(lse, lse_p, "flash_fwd lse", atol=1e-5))
        out_n, _ = _kernels.flash_fwd(q, k, v, causal, False)
        check(torch.equal(out_n, out), "the forward without lse differs from the one with it")
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = _kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal)
        dk, dv = _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
        dq_p = att.plain_flash_backward_dq(q, k, v, g, lse, delta, causal)
        dk_p, dv_p = att.plain_flash_backward_dkv(q, k, v, g, lse, delta, causal)
        masses = (att.plain_flash_grad_mass(q, k, v, g, lse, delta, causal) if dtype == torch.bfloat16
                  else (None, None, None))  # the tensor-core backward splits dS, dS^T and P^T
        e_dq = max_err(dq, dq_p, "flash_bwd_dq dq", **grad_tol, mass=masses[0])
        e_dkv = max(max_err(dk, dk_p, "flash_bwd_dkv dk", **grad_tol, mass=masses[1]),
                    max_err(dv, dv_p, "flash_bwd_dkv dv", **grad_tol, mass=masses[2]))
        if not main:
            continue
        # Library yardsticks on the same inputs, never called by the port: the
        # SDPA forward, and the one aten call that computes the backward pair's
        # function, (dq, dk, dv) from (dO, q, k, v, out, lse), fed the outputs
        # of its own forward.
        qh, kh, vh, gh = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True), 20)
            # Row 1's yardstick also returns the logsumexp, as row 1 does.
            flash_fwd_lib = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qh, kh, vh, 0.0, True, False), 20)
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
                          lambda: att.plain_flash_forward(q, k, v, True), flash_fwd_lib, e_fwd),
            "flash_bwd_dq": (lambda: _kernels.flash_bwd_dq(q, k, v, g, lse, delta, True),
                             lambda: att.plain_flash_backward_dq(q, k, v, g, lse, delta, True), sdpa_bwd, e_dq),
            "flash_bwd_dkv": (lambda: _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, True),
                              lambda: att.plain_flash_backward_dkv(q, k, v, g, lse, delta, True), sdpa_bwd, e_dkv),
        }
        for name, (kern, plain, lib_ms, err) in timings.items():
            b_ms, b_by = bound(name, BATCH, s, HEADS, EMBED // HEADS, True, 2)
            rows[name] = {"max_abs_err": err, "ms": time_ms(kern, 20), "plain_ms": time_ms(plain, 5),
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        print(f"[kernels] library (not used by the port): aten flash forward with logsumexp (row 1's "
              f"library_ms) {flash_fwd_lib:.4f} ms, sdpa forward {sdpa_fwd:.4f} ms, flash backward "
              f"(dq, dk, dv in one call; the library_ms of both backward rows) {sdpa_bwd:.4f} ms")
        pair = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
        print(f"[kernels] bwd: dq {rows['flash_bwd_dq']['ms']:.4f} + dk/dv {rows['flash_bwd_dkv']['ms']:.4f} = "
              f"{pair:.4f} ms against the aten flash backward's {sdpa_bwd:.4f} ms ({pair / sdpa_bwd:.2f}x of it)")

    # The eval forward (no logsumexp) at its own shape on the slice.
    print(f"[kernels] B={EVAL_SEQS} S={SEQ_LEN} H={HEADS} D={EMBED // HEADS} bfloat16 causal=True (no lse)")
    q, k, v, _ = inputs(EVAL_SEQS, SEQ_LEN)
    out, none = _kernels.flash_fwd(q, k, v, True, False)
    check(none is None, "the no-lse forward returned an lse")
    check(torch.equal(out, _kernels.flash_fwd(q, k, v, True, True)[0]),
          "the forward without lse differs from the one with it")
    out_p, _ = att.plain_flash_forward(q, k, v, True)
    err = max_err(out, out_p, "flash_fwd_no_lse out", **tols[torch.bfloat16][0],
                  mass=att.plain_flash_row_mass(q, k, v, True))
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
              f"library {r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x of it)")
    return rows


def carry_bound(b: int, sq: int, sk: int, h: int, d: int, esize: int, diagonal: bool) -> tuple:
    """(bound_ms, bound_by) of one carry fold: FLOPs 4 B H Sq Sk D (halved on
    the diagonal chunk) over the bf16 peak vs bytes (q, k, v in their type;
    m, l, acc read and written in f32) over the HBM rate."""
    flops = 4 * b * h * sq * sk * d * (0.5 if diagonal else 1.0)
    nbytes = (b * sq + 2 * b * sk) * h * d * esize + 2 * (2 * b * h * sq + b * sq * h * d) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def carry_err(got, ref, what: str, mass=None) -> float:
    """Max |got - ref| over a carry; fails unless m is within 1e-6 (1e-5
    where ``mass`` is given: the bf16 kernel's wgmma sums the scores in its
    own order), l within 1e-5 + 1e-5 |ref| and acc within 1e-5 + 1e-5 |ref|
    + 1e-6 l, plus 2^-15 ``mass`` for the bf16 kernel, which splits P into
    two bf16 halves (``mass = plain_flash_chunk_mass``: the fold's
    exp(S - m_new) @ |V|). Both sides are f32 sums of ~1000 weighted
    terms, folded one key tile at a time by the kernel and in one step by
    the plain version; an acc element near 0 sums terms of size up to ~l,
    so its rounding scales with l (1e-6 l is 1e-6 in the normalized
    output)."""
    import torch

    worst = 0.0
    l_ref = ref[1].transpose(1, 2)[..., None]
    m_tol = 1e-5 if mass is not None else 1e-6
    room = 2.0**-15 * mass if mass is not None else 0.0
    tols = {"m": (f"{m_tol:g}", lambda r: torch.full_like(r, m_tol)),
            "l": ("1e-5 + 1e-5|ref|", lambda r: 1e-5 + 1e-5 * r.abs()),
            "acc": ("1e-5 + 1e-5|ref| + 1e-6 l" + (" + 2^-15 mass" if mass is not None else ""),
                    lambda r: 1e-5 + 1e-5 * r.abs() + 1e-6 * l_ref + room)}
    for name, a, r in zip(("m", "l", "acc"), got, ref):
        check(bool(torch.isfinite(a).all()), f"{what} {name}: non-finite values")
        diff = (a - r).abs()
        label, tol = tols[name]
        ok = bool((diff <= tol(r)).all())
        err = float(diff.max())
        note = ""
        if name == "acc":  # what the l and mass terms are needed for
            core = 1e-5 + 1e-5 * r.abs()
            note = f" ({int((diff > core).sum())} of {diff.numel()} elements past 1e-5 + 1e-5|ref| alone"
            if mass is not None:  # the largest share of the mass term that an element needs
                past = (diff - core - 1e-6 * l_ref).clamp(min=0)
                note += f"; worst element uses {float((past / room.clamp(min=1e-30)).max()):.3f} of the mass term"
            note += ")"
        print(f"  {what} {name}: max_abs_err={err:.3e} tol={label} {'ok' if ok else 'FAIL'}{note}")
        check(ok, f"{what} {name} disagrees with the plain version (max_abs_err {err:.3e})")
        worst = max(worst, err)
    return worst


def phase_carry() -> dict:
    """The ring's carry kernel against its plain version, then its times."""
    import torch
    import torch.nn.functional as F
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    hd = EMBED // HEADS

    def inputs(s, dtype):
        return [torch.randn((RING_BATCH, s, HEADS, hd), generator=gen).to(dev, dtype) for _ in range(5)]

    def fold(carry, q, k, v, q_off, kv_off, causal, what):
        """One kernel fold against the plain one; returns both carries, the
        fold's mass (bf16) and the error."""
        got = _kernels.flash_carry(carry, q, k, v, q_off, kv_off, causal)
        ref = att.plain_flash_chunk_update(carry, q, k, v, q_off, kv_off, causal)
        mass = (att.plain_flash_chunk_mass(carry, q, k, v, q_off, kv_off, causal)
                if q.dtype == torch.bfloat16 else None)  # the bf16 kernel splits P
        return got, ref, mass, carry_err(got, ref, what, mass)

    def finalized_err(past, past_p, mass, what):
        """The finalized bf16 output within one bf16 ulp of the plain one's,
        plus 2^-15 of the fold's mass / l where the fold split P."""
        l = past_p[1].transpose(1, 2)[..., None].clamp(min=1e-30)
        return max_err(att.finalize_carry(past, torch.bfloat16), att.finalize_carry(past_p, torch.bfloat16),
                       what, atol=1e-6, bf16_ulps=1, mass=mass / l if mass is not None else None)

    off = (RING_SHARDS - 1) * RING_SHARD  # shard 7: its diagonal chunk, then a past one
    rows, errs = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        print(f"[carry] B={RING_BATCH} Sq=Sk={RING_SHARD} H={HEADS} D={hd} {str(dtype)[6:]} causal=True "
              f"q_offset={off}")
        q, k, v, kp, vp = inputs(RING_SHARD, dtype)
        fresh = att.init_carry(q.shape, dev)
        diag, _, _, e_diag = fold(fresh, q, k, v, off, off, True, "diagonal fold (kv_offset = q_offset)")
        past, past_p, mass, e_past = fold(diag, q, kp, vp, off, 0, True, "past fold (kv_offset 0)")
        future = _kernels.flash_carry(past, q, kp, vp, off, off + RING_SHARD, True)
        same = all(torch.equal(a, b) for a, b in zip(future, past))
        print(f"  future fold (kv_offset {off + RING_SHARD}): carry bit-identical {'ok' if same else 'FAIL'}")
        check(same, "a fold wholly in the future changed the carry")
        e_out = finalized_err(past, past_p, mass, "past fold's finalized bf16 output")
        if not main:
            continue
        errs += [e_diag, e_past, e_out]
        errs.append(fold(fresh, q, k, v, off, off - 100, True,
                         "fold with the diagonal inside a key tile (kv_offset = q_offset - 100)")[3])
        print(f"[carry] B={RING_BATCH} Sq=Sk=1000 H={HEADS} D={hd} bfloat16 causal=False (ragged)")
        qr, kr, vr, _, _ = inputs(1000, torch.bfloat16)
        errs.append(fold(att.init_carry(qr.shape, dev), qr, kr, vr, 0, 0, False, "ragged non-causal fold")[3])
        for s in (129, 1):  # one full q tile and a row; one row and one key
            print(f"[carry] B={RING_BATCH} Sq=Sk={s} H={HEADS} D={hd} bfloat16 causal=True q_offset={7 * s}")
            qs, ks, vs, kps, vps = inputs(s, torch.bfloat16)
            diag_s, _, _, e = fold(att.init_carry(qs.shape, dev), qs, ks, vs, 7 * s, 7 * s, True,
                                   f"S={s} diagonal fold")
            past_s, past_sp, mass_s, e2 = fold(diag_s, qs, kps, vps, 7 * s, 0, True, f"S={s} past fold")
            errs += [e, e2, finalized_err(past_s, past_sp, mass_s, f"S={s} past fold's finalized bf16 output")]
        ms_past = time_ms(lambda: _kernels.flash_carry(diag, q, kp, vp, off, 0, True), 20)
        ms_diag = time_ms(lambda: _kernels.flash_carry(fresh, q, k, v, off, off, True), 20)
        plain_past = time_ms(lambda: att.plain_flash_chunk_update(diag, q, kp, vp, off, 0, True), 5)
        plain_diag = time_ms(lambda: att.plain_flash_chunk_update(fresh, q, k, v, off, off, True), 5)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, kp, vp))
        with torch.no_grad():
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 20)
        b_past, by_past = carry_bound(RING_BATCH, RING_SHARD, RING_SHARD, HEADS, hd, 2, False)
        b_diag, by_diag = carry_bound(RING_BATCH, RING_SHARD, RING_SHARD, HEADS, hd, 2, True)
        rows["flash_carry"] = {"max_abs_err": max(errs), "ms": ms_past, "plain_ms": plain_past,
                               "bound_ms": b_past, "bound_by": by_past, "library_ms": None,
                               "ms_diagonal": ms_diag, "plain_ms_diagonal": plain_diag,
                               "bound_ms_diagonal": b_diag}
        print(f"[carry] past fold {ms_past:.4f} ms (bound {b_past:.4f} ms by {by_past}, {b_past / ms_past:.1%} "
              f"of it), plain {plain_past:.4f} ms; diagonal fold {ms_diag:.4f} ms (bound {b_diag:.4f} ms by "
              f"{by_diag}, {b_diag / ms_diag:.1%}), plain {plain_diag:.4f} ms")
        print(f"[carry] library: none (no PyTorch call folds a chunk into an unnormalized carry); for "
              f"information only, SDPA on the same past chunk (a different function: normalized, no "
              f"carry) {sdpa:.4f} ms")
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
    for name, (_, per_round, _) in KERNEL_ROWS.items():
        # run() drives the warm-up round and then the timed rounds.
        check(launches[name] > 0, f"{name} was never launched on the main path")
        check(launches[name] == per_round * (ROUNDS + 1),
              f"{name}: {launches[name]} launches, expected {per_round} per round x {ROUNDS + 1} "
              f"(warm-up + {ROUNDS})")
    return launches, sim


def phase_ring() -> tuple:
    """The sequence-parallel trainer at the ring configuration; returns the
    launches of the ring's kernels in its run (warm-up step + timed steps)
    and a function that runs one more step."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.models.transformer import TransformerLM, transformer_lm_model
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.optim import adam
    from p2pfl_tpu_torch.parallel.mesh import Mesh
    from p2pfl_tpu_torch.parallel.sequence import (
        make_sequence_parallel_train_step,
        sequence_parallel_apply,
        shard_tokens,
    )

    mesh = Mesh({"seq": RING_SHARDS}, device="cuda")
    model = transformer_lm_model(0, RING_SEQ, VOCAB, LAYERS, HEADS, EMBED, "ring_flash", "seq", device="cuda")
    n_params = sum(p.numel() for p in model.params.values())
    print(f"[ring] TransformerLM ring_flash {LAYERS}L/{EMBED}d/{HEADS}h vocab {VOCAB}: {n_params} params; "
          f"sequence {RING_SEQ} over {mesh}")
    check(n_params == N_PARAMS, f"expected {N_PARAMS} params, got {n_params}")

    # Reference on a small input: the ring against flash attention (both exact).
    with torch.device("meta"):
        flash = TransformerLM(vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                              embed_dim=EMBED, attention_kind="flash")
    toks = torch.randint(0, VOCAB, (2, 2048), generator=torch.Generator().manual_seed(2)).cuda()
    with torch.no_grad():
        got = sequence_parallel_apply(model.apply, mesh)(model.params, toks)
        ref = ModelHandle(model.params, flash).apply(model.params, toks)
    check(got.shape == (2, 2048, VOCAB), f"logits shape {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    print(f"[ring] ring_flash vs flash logits on [2, 2048]: max_abs_err={err:.3e} tol 6e-2")
    check(bool(torch.isfinite(got).all()) and err <= 6e-2, "ring_flash logits disagree with flash attention")
    del got, ref

    # Synthetic tokens as bench.py's --lm-mfu arm makes them.
    rng = np.random.default_rng(7)
    x = (rng.integers(0, VOCAB, size=(RING_BATCH, 1)) + np.arange(RING_SEQ)) % VOCAB
    tokens = shard_tokens(x.astype(np.int32), mesh)
    opt = adam(LR)
    params, state = model.params, opt.init(model.params)
    step = make_sequence_parallel_train_step(model.apply, opt, mesh, "seq")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _kernels.reset_launches()
    params, state, loss = step(params, state, tokens)  # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(RING_STEPS):
        params, state, loss = step(params, state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    losses = [float(l) for l in losses]
    print(f"[ring] {RING_STEPS} steps after a warm-up: {seconds / RING_STEPS:.4f} s/step ({seconds:.3f} s, "
          f"host clock ending in torch.cuda.synchronize()); {RING_BATCH * RING_SEQ} tokens per step")
    print(f"[ring] loss per step (warm-up first): {losses}")
    print(f"[ring] max_memory_allocated: {peak} bytes ({peak / 2**30:.2f} GiB; {held} bytes held before "
          f"the first step: weights, tokens)")
    print(f"[ring] kernels: {json.dumps(launches)}")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "training loss did not fall over the steps")
    for name, (_, per_step, _) in RING_KERNEL_ROWS.items():
        check(launches[name] > 0, f"{name} was never launched on the ring path")
        check(launches[name] == per_step * (RING_STEPS + 1),
              f"{name}: {launches[name]} launches, expected {per_step} per step x {RING_STEPS + 1} "
              f"(warm-up + {RING_STEPS})")

    def one_more_step() -> None:
        step(params, state, tokens)
        torch.cuda.synchronize()

    return {name: launches[name] for name in RING_KERNEL_ROWS}, one_more_step


def phase_profile(label: str, run) -> None:
    """``run()`` (one more round or step) under torch.profiler: device time by
    kernel class, the wall time under the profiler, and the device's busy
    share of it (an upper bound on idle, since tracing slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
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
    print(f"[profile] {label} under torch.profiler: wall {wall_us / 1e3:.1f} ms, device busy "
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
        rows.update(phase_carry())
        profiling = "--profile" in sys.argv[1:]
        launches, sim = phase_slice()
        if profiling:
            phase_profile("slice: one round", lambda: sim.run(rounds=1, warmup=False))
        del sim
        gc.collect()  # the population's state must not count in the ring's peak memory
        ring_launches, ring_step = phase_ring()
        launches.update(ring_launches)
        if profiling:
            phase_profile("ring: one train step", ring_step)
    except Exception as e:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    table = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **rows[name]}
        for name, (replaces, _, source) in {**KERNEL_ROWS, **RING_KERNEL_ROWS}.items()
    ]
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
