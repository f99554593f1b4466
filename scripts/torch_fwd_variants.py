#!/usr/bin/env python3
"""Time compile-time variants of the port's bf16 forward kernel on one card.

    python3 scripts/torch_fwd_variants.py

Each variant is ``p2pfl_tpu_torch/csrc/flash_fwd_sm90.cu`` with some of its
text replaced (``VARIANTS`` below), built with ``flash_attn.cu`` into a
library of its own under ``build/variants/`` (one ``nvcc`` per file, all at
once) and loaded with ctypes. Every variant runs the forward with lse at
[8, 1024, 8, 64] bf16 causal and the one without at [16, 1024, 8, 64]; its
outputs must equal the package's kernel's bit for bit (the variants change
scheduling, not arithmetic). Times are CUDA events over 50 launches
(``chip_smoke.time_ms``), taken in the order A B ... B A so that drift
shows, with each variant's ptxas registers and spills. Runs on the card
only.
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

# name -> {text in the source: replacement}
VARIANTS = {
    "as built": {},
    "regs 64/216": {"kProducerRegs = 40;": "kProducerRegs = 64;", "kConsumerRegs = 232;": "kConsumerRegs = 216;"},
    "guarded tile wait": {"mbar_spin(blk.full_bar(s)": "mbar_wait(blk.full_bar(s)"},
    "3 stages": {"kStages = 2;": "kStages = 3;"},
}


def build(nvcc: str, flags: tuple) -> dict:
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "p2pfl_tpu_torch" / "csrc"
    base = (csrc / "flash_fwd_sm90.cu").read_text()
    jobs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = base
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        src = out_dir / f"v{i}_flash_fwd_sm90.cu"
        src.write_text(text)
        obj = out_dir / f"v{i}.o"
        cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
        jobs[name] = (i, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    attn = out_dir / "flash_attn.o"
    common = subprocess.run([nvcc, *flags, "-c", "-o", str(attn), str(csrc / "flash_attn.cu")],
                            capture_output=True, text=True)
    if common.returncode:
        raise SystemExit(common.stdout + common.stderr)
    libs = {}
    for name, (i, obj, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name!r} failed to build:\n{log}")
        lib = out_dir / f"v{i}.so"
        link = subprocess.run([nvcc, "-shared", "-o", str(lib), str(obj), str(attn)], capture_output=True, text=True)
        if link.returncode:
            raise SystemExit(link.stdout + link.stderr)
        ptxas = [f"{m[1]} registers, {s[1]} bytes spilled"
                 for s, m in zip(re.finditer(r"(\d+) bytes spill stores", log),
                                 re.finditer(r"Used (\d+) registers", log))]
        ptxas += sorted({line.split(":", 1)[-1].strip() for line in log.splitlines()
                         if "ptxas" in line and ("warning" in line or "Performance" in line)})
        libs[name] = (ctypes.CDLL(str(lib)), ptxas)
    return libs


def main() -> int:
    import torch

    import chip_smoke
    from p2pfl_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        print("torch_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.nvidia_smi()}")
    libs = build(_kernels._find_nvcc(), _kernels.NVCC_FLAGS)
    gen = torch.Generator().manual_seed(0)
    shapes = {"flash_fwd": (8, True), "flash_fwd_no_lse": (16, False)}
    inputs = {name: [torch.randn((b, 1024, 8, 64), generator=gen).cuda().to(torch.bfloat16) for _ in range(3)]
              for name, (b, _) in shapes.items()}
    refs = {name: _kernels.flash_fwd(*inputs[name], True, lse)[0] for name, (_, lse) in shapes.items()}
    p = ctypes.c_void_p
    i, f = ctypes.c_int, ctypes.c_float

    def call(lib, name):
        q, k, v = inputs[name]
        b, sq, h, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if shapes[name][1] else None
        code = lib.p2pfl_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   lse.data_ptr() if lse is not None else None, b, sq, sq, h, d, 1,
                                   1.0 / math.sqrt(d), 1, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return out

    for lib, ptxas in libs.values():
        lib.p2pfl_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, p]
        lib.p2pfl_flash_fwd.restype = ctypes.c_int
    for vname, (lib, ptxas) in libs.items():
        same = all(torch.equal(call(lib, name), refs[name]) for name in shapes)
        print(f"{vname}: ptxas {ptxas}; outputs equal to the package's kernel: {same}")
        if not same:
            return 1
    order = list(libs) + list(reversed(libs))
    times = {v: {name: [] for name in shapes} for v in libs}
    for vname in order:
        for name in shapes:
            times[vname][name].append(chip_smoke.time_ms(lambda: call(libs[vname][0], name), 50))
    for vname, t in times.items():
        print(f"{vname}: " + "; ".join(f"{name} {' / '.join(f'{x:.4f}' for x in xs)} ms" for name, xs in t.items()))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
