#!/usr/bin/env python3
"""Compare the SASS of one CUDA source of the port between two checkouts.

    python3 scripts/torch_sass_diff.py BASE [SOURCE]

``BASE`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive``), ``SOURCE`` a file under
``p2pfl_tpu_torch/csrc/`` (default ``flash_fwd_sm90.cu``). Both copies are
compiled with the package's ``nvcc`` flags to cubins under
``build/sass_diff/`` and disassembled with ``cuobjdump -sass``; each kernel
is reported as identical, identical but for addresses, or with the diff of
its instructions (addresses and immediates masked), beside its line and
``HGMMA`` counts; for a kernel identical but for addresses, its first
differing instructions as they are. A kernel in only one build is listed
as such. Needs
``nvcc`` and ``cuobjdump``: runs on the machine with the card.
"""

from __future__ import annotations

import difflib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def sass(nvcc: str, flags: tuple, src: Path, cubin: Path) -> dict:
    """{kernel: [instruction lines]} of ``src``, each the instruction and its
    encoding words with runs of blanks as one (cuobjdump pads its columns to
    the widest line of the whole dump, so a kernel's lines shift when another
    kernel comes or goes); the per-file hash in an anonymous namespace's
    mangled name is dropped so both builds match."""
    keep = [f for f in flags if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([nvcc, *keep, "-cubin", "-o", str(cubin), str(src)], check=True)
    tool = str(Path(nvcc).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(cubin)], capture_output=True, text=True, check=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "ANON_", m[1])
            kernels[name] = []
        elif name:
            ins = re.sub(r"\s+", " ", re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)).strip()
            if ins and not ins.startswith("/*"):
                kernels[name].append(ins)
    return kernels


def main() -> int:
    from p2pfl_tpu_torch.ops import _kernels

    if len(sys.argv) < 2:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    base, source = Path(sys.argv[1]), sys.argv[2] if len(sys.argv) > 2 else "flash_fwd_sm90.cu"
    nvcc = _kernels._find_nvcc()
    out = ROOT / "build" / "sass_diff"
    out.mkdir(parents=True, exist_ok=True)
    stem = Path(source).stem  # one pair of cubins per source: several sources may be compared at once
    old = sass(nvcc, _kernels.NVCC_FLAGS, base / "p2pfl_tpu_torch" / "csrc" / source, out / f"base_{stem}.cubin")
    new = sass(nvcc, _kernels.NVCC_FLAGS, ROOT / "p2pfl_tpu_torch" / "csrc" / source, out / f"tree_{stem}.cubin")
    hgmma = lambda ins: sum("HGMMA" in x for x in ins)  # noqa: E731
    masked = lambda ins: [re.sub(r"0x[0-9a-f]+", "X", re.sub(r"/\*.*?\*/", "", x)).strip() for x in ins]  # noqa: E731
    for name in sorted(set(old) | set(new)):
        a, b = old.get(name), new.get(name)
        if a is None or b is None:
            only = b if a is None else a
            print(f"{name}: only in {'this tree' if a is None else 'BASE'} ({len(only)} lines, HGMMA {hgmma(only)})")
            continue
        diff = list(difflib.unified_diff(masked(a), masked(b), lineterm="", n=1))[2:]
        verdict = "IDENTICAL" if a == b else "identical but for addresses" if not diff else f"{len(diff)} diff lines"
        print(f"{name}: BASE {len(a)} lines, this tree {len(b)} lines, HGMMA {hgmma(a)} / {hgmma(b)}: {verdict}")
        for line in diff[:60]:
            print("    " + line)
        if a != b and not diff:  # which numbers differ: constant-bank offsets, branch targets, ...
            pairs = [(x, y) for x, y in zip(a, b) if x != y]
            print(f"    {len(pairs)} instructions differ, first: " + "; ".join(f"{x!r} -> {y!r}" for x, y in pairs[:3]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
