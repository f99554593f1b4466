#!/usr/bin/env python3
"""Time compile-time variants of the port's bf16 tensor-core kernels on one card.

    python3 scripts/torch_kernel_variants.py fwd     # the forward (flash_fwd_sm90.cu)
    python3 scripts/torch_kernel_variants.py bwd     # the backward pair (flash_bwd_sm90.cu)
    python3 scripts/torch_kernel_variants.py carry   # the carry fold (flash_fwd_sm90.cu)
    python3 scripts/torch_kernel_variants.py grouped # the forward above D 256 (flash_fwd_grouped_sm90.cu)
    python3 scripts/torch_kernel_variants.py bwd_grouped  # the backward pair above D 256 (flash_bwd_grouped_sm90.cu)
    python3 scripts/torch_kernel_variants.py narrow  # the forward below D 64 (flash_fwd_narrow_sm90.cu)
    python3 scripts/torch_kernel_variants.py bwd_narrow  # the backward pair below D 64 (flash_bwd_narrow_sm90.cu)
    python3 scripts/torch_kernel_variants.py carry_grouped  # the carry fold above D 64 (flash_carry_grouped_sm90.cu)
    python3 scripts/torch_kernel_variants.py carry_narrow  # the carry fold below D 64 (flash_carry_narrow_sm90.cu)

Each variant is the chosen source under ``p2pfl_tpu_torch/csrc/`` with some
of its text replaced (``VARIANTS`` below), built with the package's other
sources into a library of its own under ``build/variants/`` (one ``nvcc``
per file, all at once) and loaded with ctypes. ``fwd`` runs the forward
with lse at [8, 1024, 8, 64] bf16 causal and the one without at
[16, 1024, 8, 64]; ``bwd`` runs dq and dk/dv at [8, 1024, 8, 64] bf16
causal; ``carry`` runs the ring's past and diagonal folds of one chunk
[2, 1024, 8, 64] bf16 (shard 7 of 8, as ``chip_smoke.py`` times them);
``grouped`` runs the forward with lse at [8, 1024, 1, D] bf16 causal and the
one without at [16, 1024, 1, D], at D 512 and 1024; ``bwd_grouped`` runs dq
and dk/dv at [8, 1024, 1, D] bf16 causal, at D 512 and 1024; ``narrow`` runs
the forward with lse at [8, 1024, H, D] and the one without at [16, 1024,
H, D] bf16 causal at D 32 / 16 / 48 (H 16 / 32 / 8), and both at the flash
classifier's shapes ([16, 64, 4, 32], eval [256, 64, 4, 32]) and the
longcontext example's ([4, 256, 4, 16], eval [16, 256, 4, 16]);
``bwd_narrow`` runs dq and dk/dv at those training shapes;
``carry_grouped`` runs the ring's past and diagonal folds of one chunk
[2, 1024, H, D] bf16 at D 128 / 256 / 512 / 1024 (H 4 / 2 / 1 / 1) and
prints each variant's largest error in m against the plain version's and
against the exact row max (f64 scores), beside the plain version's own;
``carry_narrow`` runs the past and diagonal folds of one chunk [2, 1024, H,
D] bf16 at D 32 / 16 / 48 (H 16 / 32 / 8). A
variant of ``flash_fwd_sm90.cu`` changes the forward and the carry fold
alike; each family times its own. Every variant's outputs must equal the
package's kernels' bit for bit (the variants change scheduling, not
arithmetic), except those that reorder a sum (``REORDERING``: the dq key
tile's width changes the order of dQ's k-steps; the carry's S chains the
order of its sums), which are held instead to
the package's bar against the plain version (1e-6 + 1 bf16 ulp + 2^-15 of
each gradient's weighted mass, ``chip_smoke.max_err``; a carry's split bar,
``chip_smoke.carry_err``). Times are CUDA events
over 50 launches (``chip_smoke.time_ms``), taken in the order A B ... B A
so that drift shows, with each variant's ptxas registers and spills. Runs
on the card only.
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCES = {"fwd": "flash_fwd_sm90.cu", "bwd": "flash_bwd_sm90.cu", "carry": "flash_fwd_sm90.cu",
           "grouped": "flash_fwd_grouped_sm90.cu", "bwd_grouped": "flash_bwd_grouped_sm90.cu",
           "narrow": "flash_fwd_narrow_sm90.cu", "bwd_narrow": "flash_bwd_narrow_sm90.cu",
           "carry_grouped": "flash_carry_grouped_sm90.cu", "carry_narrow": "flash_carry_narrow_sm90.cu"}
# kernel family -> variant name -> {text in the source: replacement}
VARIANTS = {
    "fwd": {
        "as built": {},
        "regs 64/216": {"kProducerRegs = 40;": "kProducerRegs = 64;", "kConsumerRegs = 232;": "kConsumerRegs = 216;"},
        "guarded tile wait": {"mbar_spin(blk.full_bar(s)": "mbar_wait(blk.full_bar(s)"},
        "3 stages": {"kStages = 2;": "kStages = 3;"},
    },
    "bwd": {
        "as built": {},
        "regs 56/224": {"kProducerRegs = 40;": "kProducerRegs = 56;", "kConsumerRegs = 232;": "kConsumerRegs = 224;"},
        "guarded tile wait": {"mbar_spin(blk.full_bar(s)": "mbar_wait(blk.full_bar(s)"},
        "3 stages": {"kStages = 2;  // K / V ring depth": "kStages = 3;  // K / V ring depth",
                     "kStages = 2;  // Q / dO ring depth": "kStages = 3;  // Q / dO ring depth"},
    },
    "carry": {
        "as built": {},
        "3 stages": {"kStages = 2;": "kStages = 3;"},
        "regs 64/216": {"kProducerRegs = 40;": "kProducerRegs = 64;", "kConsumerRegs = 232;": "kConsumerRegs = 216;"},
        "guarded tile wait": {"mbar_spin(blk.full_bar(s)": "mbar_wait(blk.full_bar(s)"},
    },
    "grouped": {
        "as built": {},
        "4 Q/K stages": {"kQKStages = 6;": "kQKStages = 4;", "kSmemBytes == 214144": "kSmemBytes == 164960"},
        "panel loop unrolled 2": {"#pragma unroll 1\n    for (int p = 0; p < blk.panels; ++p)":
                                  "#pragma unroll 2\n    for (int p = 0; p < blk.panels; ++p)"},
        "no panel in flight": {"wgmma_wait_one();  // the previous": "wgmma_wait_all();  // the previous"},
    },
    "bwd_grouped": {
        "as built": {},
        "dq BK 32, 8 stages": {"BK = 64;           // keys per K / V tile": "BK = 32;           // keys per K / V tile",
                               "kStages = 6;": "kStages = 8;",
                               "kSmemBytes == 214144": "kSmemBytes == 197792"},
        "dq 5 stages": {"kStages = 6;": "kStages = 5;", "kSmemBytes == 214144": "kSmemBytes == 189552"},
        "dk/dv 8 stages": {"kStages = 12;": "kStages = 8;", "kSmemBytes == 214752": "kSmemBytes == 165536"},
        "dk/dv 13 stages": {"kStages = 12;": "kStages = 13;", "kSmemBytes == 214752": "kSmemBytes == 227056"},
        "groups of 2 panels": {"kGroupPanels = 4;": "kGroupPanels = 2;", "kSmemBytes == 214144": "kSmemBytes == 181376",
                               "kSmemBytes == 214752": "kSmemBytes == 181984"},
    },
    "narrow": {
        "as built": {},
        "3 stages": {"constexpr int kStages = 2;": "constexpr int kStages = 3;",
                     "Tiles<16>::kSmemBytes == 11304 && Tiles<32>::kSmemBytes == 21544 && "
                     "Tiles<64>::kSmemBytes == 42024":
                     "Tiles<16>::kSmemBytes == 15416 && Tiles<32>::kSmemBytes == 29752 && "
                     "Tiles<64>::kSmemBytes == 58424"},
        "3 blocks an SM at W 16 / 32": {"constexpr int kBlocksW = W < 64 ? 4 : 3;": "constexpr int kBlocksW = 3;"},
    },
    "bwd_narrow": {  # the blocks an SM of both kernels at every W, then the ring's depth
        "as built": {},
        **{f"{n} blocks an SM": {"constexpr int kDqBlocksW = W == 16 ? 4 : 3;": f"constexpr int kDqBlocksW = {n};",
                                 "constexpr int kDkvBlocksW = W < 64 ? 3 : 2;": f"constexpr int kDkvBlocksW = {n};"}
           for n in (2, 3, 4)},
        "3 stages": {"constexpr int kStages = 2;": "constexpr int kStages = 3;",
                     "kDqSmemBytes == 13352": "kDqSmemBytes == 17464", "kDqSmemBytes == 25640": "kDqSmemBytes == 33848",
                     "kDqSmemBytes == 50216": "kDqSmemBytes == 66616", "kDkvSmemBytes == 14376": "kDkvSmemBytes == 19000",
                     "kDkvSmemBytes == 26664": "kDkvSmemBytes == 35384",
                     "kDkvSmemBytes == 51240": "kDkvSmemBytes == 68152"},
    },
    "carry_grouped": {  # the q tile's rows, the Q / K ring's depth, S's chains, the partial group, registers
        "as built": {},
        "128-row q tile": {"constexpr int kConsumers = 1;": "constexpr int kConsumers = 2;",
                           "kConsumerRegs = 240;": "kConsumerRegs = 232;"},
        "10 Q/K stages": {"kQKStages = 6;": "kQKStages = 10;"},
        **{f"S in chains of {n} panels": {"kChainPanels = 2;": f"kChainPanels = {n};"} for n in (1, 4)},
        "S in one wgmma chain": {"kChainPanels = 2;": "kChainPanels = 1 << 20;"},
        "no products past the group's panels": {
            "for (int p = 0; p < kGroupPanels; ++p)\n        wgmma_m64n64k16_rs(o[p], p_hi":
            "for (int p = 0; p < kGroupPanels; ++p)\n        if (p < blk.group_panels) wgmma_m64n64k16_rs(o[p], p_hi",
            "for (int p = 0; p < kGroupPanels; ++p)\n        wgmma_m64n64k16_rs(o[p], p_lo":
            "for (int p = 0; p < kGroupPanels; ++p)\n        if (p < blk.group_panels) wgmma_m64n64k16_rs(o[p], p_lo"},
        "consumer 232 registers": {"kConsumerRegs = 240;": "kConsumerRegs = 232;"},
    },
    "carry_narrow": {  # the blocks an SM at W 16 / 32, where and how the consumer waits for Q, the ring's depth
        "as built": {},
        "3 blocks an SM at W 16 / 32": {"constexpr int kBlocksW = W < 64 ? 4 : 3;": "constexpr int kBlocksW = 3;"},
        **{f"{form} Q wait after the carry read": {
            "  if (blk.n_tiles > 0) mbar_wait(blk.q_bar(), 0);  // before the carry read: see the header\n": "",
            "  Ring ring;\n  for (int t = 0; t < blk.n_tiles; ++t) {\n    mbar_spin":
            f"  if (blk.n_tiles > 0) {wait}(blk.q_bar(), 0);\n"
            "  Ring ring;\n  for (int t = 0; t < blk.n_tiles; ++t) {\n    mbar_spin"}
           for form, wait in (("guarded", "mbar_wait"), ("unguarded", "mbar_spin"))},
        "3 stages": {"constexpr int kStages = 2;": "constexpr int kStages = 3;",
                     "Tiles<16>::kSmemBytes == 11304 && Tiles<32>::kSmemBytes == 21544 && "
                     "Tiles<64>::kSmemBytes == 42024":
                     "Tiles<16>::kSmemBytes == 15416 && Tiles<32>::kSmemBytes == 29752 && "
                     "Tiles<64>::kSmemBytes == 58424"},
    },
}
# Variants whose sums may run in another order than the package's (a 128-row
# q tile walks more masked key tiles on the diagonal fold; other S chains).
REORDERING = {"dq BK 32, 8 stages", "128-row q tile", "S in chains of 1 panels", "S in chains of 4 panels",
              "S in one wgmma chain"}


def build(family: str, nvcc: str, flags: tuple) -> dict:
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "p2pfl_tpu_torch" / "csrc"
    varied = SOURCES[family]
    base = (csrc / varied).read_text()
    jobs = {}
    for i, (name, subs) in enumerate(VARIANTS[family].items()):
        text = base
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        src = out_dir / f"v{i}_{varied}"
        src.write_text(text)
        obj = out_dir / f"v{i}.o"
        cmd = [nvcc, *flags, "-I", str(csrc), "-c", "-o", str(obj), str(src)]
        jobs[name] = (i, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    from p2pfl_tpu_torch.ops import _kernels

    others = [out_dir / f"{src.stem}.o" for src in _kernels.SOURCES if src.name != varied]
    commons = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj), str(csrc / f"{obj.stem}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for obj in others]
    for proc in commons:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(log)
    libs = {}
    for name, (i, obj, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name!r} failed to build:\n{log}")
        lib = out_dir / f"v{i}.so"
        link = subprocess.run([nvcc, "-shared", "-o", str(lib), str(obj), *map(str, others)],
                              capture_output=True, text=True)
        if link.returncode:
            raise SystemExit(link.stdout + link.stderr)
        ptxas = [f"{m[1]} registers, {s[1]} bytes spilled"
                 for s, m in zip(re.finditer(r"(\d+) bytes spill stores", log),
                                 re.finditer(r"Used (\d+) registers", log))]
        ptxas += sorted({line.split(":", 1)[-1].strip() for line in log.splitlines()
                         if "ptxas" in line and ("warning" in line or "Performance" in line)})
        lib = ctypes.CDLL(str(lib))
        p, i_, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.p2pfl_flash_fwd.argtypes = [p, p, p, p, p, i_, i_, i_, i_, i_, i_, f, i_, p]
        lib.p2pfl_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, i_, i_, i_, i_, i_, i_, f, i_, p]
        lib.p2pfl_flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i_, i_, i_, i_, i_, i_, f, i_, p]
        lib.p2pfl_flash_carry.argtypes = [p, p, p, p, p, p, p, p, p, i_, i_, i_, i_, i_, i_, f, i_, i_, i_, p]
        for fn in (lib.p2pfl_flash_fwd, lib.p2pfl_flash_bwd_dq, lib.p2pfl_flash_bwd_dkv, lib.p2pfl_flash_carry):
            fn.restype = ctypes.c_int
        libs[name] = (lib, ptxas)
    return libs


def calls(family: str):
    """{case: (fn(lib) -> outputs, the package's outputs, plain)} for the
    family; ``plain`` (backward cases only, else None) is ``(the plain
    versions' outputs, their weighted masses)``."""
    import torch

    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import attention as port

    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def rand(b):
        return [torch.randn((b, 1024, 8, 64), generator=gen).cuda().to(torch.bfloat16) for _ in range(4)]

    def check(code):
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")

    def backward(q, k, v, g, label=""):
        out, lse = _kernels.flash_fwd(q, k, v, True, True)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        b, sq, h, d = q.shape
        inputs = (q, k, v, g, lse, delta)  # the closures below hold the tensors, not only their pointers

        def dq(lib):
            out = torch.empty_like(q)
            check(lib.p2pfl_flash_bwd_dq(*(t.data_ptr() for t in inputs), out.data_ptr(), b, sq, sq, h, d, 1,
                                         1.0 / math.sqrt(d), 1, stream))
            return (out,)

        def dkv(lib):
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            check(lib.p2pfl_flash_bwd_dkv(*(t.data_ptr() for t in inputs), dk.data_ptr(), dv.data_ptr(), b, sq,
                                          sq, h, d, 1, 1.0 / math.sqrt(d), 1, stream))
            return dk, dv

        mass = port.plain_flash_grad_mass(q, k, v, g, lse, delta, True)
        plain_dq = ((port.plain_flash_backward_dq(q, k, v, g, lse, delta, True),), mass[:1])
        plain_dkv = (port.plain_flash_backward_dkv(q, k, v, g, lse, delta, True), mass[1:])
        return {f"flash_bwd_dq{label}": (dq, (_kernels.flash_bwd_dq(q, k, v, g, lse, delta, True),), plain_dq),
                f"flash_bwd_dkv{label}": (dkv, _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, True), plain_dkv)}

    def forward(q, k, v, with_lse):
        def fwd(lib):  # the closure holds q, k, v, not only their pointers
            b, sq, h, d = q.shape
            out = torch.empty_like(q)
            lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
            check(lib.p2pfl_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      lse.data_ptr() if lse is not None else None, b, sq, sq, h, d, 1,
                                      1.0 / math.sqrt(d), 1, stream))
            return (out,) if lse is None else (out, lse)

        return fwd

    cases = {}
    if family == "bwd_narrow":
        shapes = {"D=32": (8, 1024, 16, 32), "D=16": (8, 1024, 32, 16), "D=48": (8, 1024, 8, 48),
                  "cls": (16, 64, 4, 32), "lc": (4, 256, 4, 16)}
        for label, shape in shapes.items():
            cases.update(backward(*(torch.randn(shape, generator=gen).cuda().to(torch.bfloat16) for _ in range(4)),
                                  f" {label}"))
        return cases
    if family == "narrow":
        shapes = {"D=32": ((8, 1024, 16, 32), 16), "D=16": ((8, 1024, 32, 16), 16), "D=48": ((8, 1024, 8, 48), 16),
                  "cls": ((16, 64, 4, 32), 256), "lc": ((4, 256, 4, 16), 16)}
        for label, ((b, s, h, d), b_eval) in shapes.items():
            for name, bb, with_lse in (("flash_fwd", b, True), ("flash_fwd_no_lse", b_eval, False)):
                q, k, v = (torch.randn((bb, s, h, d), generator=gen).cuda().to(torch.bfloat16) for _ in range(3))
                ref = _kernels.flash_fwd(q, k, v, True, with_lse)
                cases[f"{name} {label}"] = (forward(q, k, v, with_lse), ref if with_lse else ref[:1], None)
        return cases
    if family == "bwd_grouped":
        for d in (512, 1024):
            cases.update(backward(*(torch.randn((8, 1024, 1, d), generator=gen).cuda().to(torch.bfloat16)
                                    for _ in range(4)), f" D={d}"))
        return cases
    if family == "grouped":
        for d in (512, 1024):
            for name, b, with_lse in (("flash_fwd", 8, True), ("flash_fwd_no_lse", 16, False)):
                q, k, v = (torch.randn((b, 1024, 1, d), generator=gen).cuda().to(torch.bfloat16) for _ in range(3))
                ref = _kernels.flash_fwd(q, k, v, True, with_lse)
                cases[f"{name} D={d}"] = (forward(q, k, v, with_lse), ref if with_lse else ref[:1], None)
        return cases
    if family == "fwd":
        for name, b, with_lse in (("flash_fwd", 8, True), ("flash_fwd_no_lse", 16, False)):
            q, k, v, _ = rand(b)
            cases[name] = (forward(q, k, v, with_lse), (_kernels.flash_fwd(q, k, v, True, with_lse)[0],), None)
        return cases
    if family in ("carry", "carry_grouped", "carry_narrow"):
        from p2pfl_tpu_torch.ops import attention as att

        shapes = {"carry": ((64, 8),), "carry_grouped": ((128, 4), (256, 2), (512, 1), (1024, 1)),
                  "carry_narrow": ((32, 16), (16, 32), (48, 8))}[family]
        for d, h in shapes:  # one ring chunk [2, 1024, h, d]
            q, k, v, kp, vp = (torch.randn((2, 1024, h, d), generator=gen).cuda().to(torch.bfloat16)
                               for _ in range(5))
            off = 7 * 1024  # shard 7 of 8: its diagonal chunk into a fresh carry, then a past chunk
            fresh = att.init_carry(q.shape, q.device)
            diag = _kernels.flash_carry(fresh, q, k, v, off, off, True)
            for name, carry, kc, vc, kv_off in (("past fold", diag, kp, vp, 0), ("diagonal fold", fresh, k, v, off)):
                def fold(lib, q=q, carry=carry, kc=kc, vc=vc, kv_off=kv_off):  # the defaults hold the tensors
                    outs = tuple(torch.empty_like(t) for t in carry)
                    b, sq, h, d = q.shape
                    check(lib.p2pfl_flash_carry(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                                *(t.data_ptr() for t in (*carry, *outs)), b, sq, sq, h, d, 1,
                                                1.0 / math.sqrt(d), 1, off, kv_off, stream))
                    return outs

                plain = None
                if family == "carry_grouped":
                    s64 = att._causal_mask(torch.einsum("bqhd,bkhd->bhqk", q.double(), kc.double()) / math.sqrt(d),
                                           off, kv_off)
                    m64 = torch.maximum(carry[0].double(), s64.amax(-1))  # the exact row max (f64 scores)
                    plain = (att.plain_flash_chunk_update(carry, q, kc, vc, off, kv_off, True),
                             att.plain_flash_chunk_mass(carry, q, kc, vc, off, kv_off, True), m64)
                label = name if family == "carry" else f"{name} D={d}"
                cases[label] = (fold, _kernels.flash_carry(carry, q, kc, vc, off, kv_off, True), plain)
        return cases
    return backward(*rand(8))


def main() -> int:
    import torch

    import chip_smoke
    from p2pfl_tpu_torch.ops import _kernels

    family = sys.argv[1] if len(sys.argv) > 1 else "fwd"
    if family not in VARIANTS:
        print(f"usage: torch_kernel_variants.py [{'|'.join(VARIANTS)}]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.nvidia_smi()}")
    libs = build(family, _kernels._find_nvcc(), _kernels.NVCC_FLAGS)
    cases = calls(family)
    for vname, (lib, ptxas) in libs.items():
        same = all(torch.equal(a, b) for fn, refs, _ in cases.values() for a, b in zip(fn(lib), refs))
        print(f"{vname}: ptxas {ptxas}; outputs equal to the package's kernels: {same}")
        if family == "carry_grouped":  # m against the plain version's and the exact (f64) row max
            for name, (fn, _, (ref, _, m64)) in cases.items():
                m = fn(lib)[0].double()
                print(f"  {name}: max |m - plain| {float((m - ref[0]).abs().max()):.3e}, |m - f64| "
                      f"{float((m - m64).abs().max()):.3e}; the plain version's |m - f64| "
                      f"{float((ref[0].double() - m64).abs().max()):.3e}")
        if same:
            continue
        if vname not in REORDERING:
            return 1
        for name, (fn, _, plain) in cases.items():  # raises if an output is past the bar
            if family == "carry_grouped":  # the plain carry and the fold's mass
                chip_smoke.carry_err(fn(lib), plain[0], f"{vname}: {name}", plain[1])
                continue
            refs, masses = plain
            for i, (got, ref, mass) in enumerate(zip(fn(lib), refs, masses)):
                chip_smoke.max_err(got, ref, f"{vname}: {name} output {i}", atol=1e-6, bf16_ulps=1, mass=mass)
    order = list(libs) + list(reversed(libs))
    times = {v: {name: [] for name in cases} for v in libs}
    for vname in order:
        for name, (fn, _, _) in cases.items():
            times[vname][name].append(chip_smoke.time_ms(lambda: fn(libs[vname][0]), 50))
    for vname, t in times.items():
        print(f"{vname}: " + "; ".join(f"{name} {' / '.join(f'{x:.4f}' for x in xs)} ms" for name, xs in t.items()))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
