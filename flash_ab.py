#!/usr/bin/env python3
"""A/B of flash-attention kernel sources on one NVIDIA card.

    python3 flash_ab.py NAME=PATH[:FLAG,FLAG...] [NAME=PATH ...]

Each PATH is a version of ``flash_attention.cu`` with the same C entry
(``flash_attention_fwd_bf16``): for example the package's source and the
parent commit's, unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Each is built with the package's nvcc flags (plus the
optional ``-D`` or ``-Xptxas`` flags after the colon) into
``build/flash_ab/NAME.so``, its ptxas spill and serialisation lines are
printed, and it is loaded in place of the package's library and run through
``chip_smoke.flash_phase`` at chip_smoke's flash shapes: checked against the
plain version and timed as CUDA-graph replays. The versions run in the
order a, b, ..., b, a, so that drift on the card shows as a difference
between a version's two passes.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import ops as fa

    out_dir = REPO / "build" / "flash_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for arg in argv:
        name, _, spec = arg.partition("=")
        path, _, flags = spec.partition(":")
        out = out_dir / f"{name}.so"
        t0 = time.perf_counter()
        res = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, *[f for f in flags.split(",") if f],
                              "-o", str(out), path], capture_output=True, text=True)
        print(f"[build] {name}: {time.perf_counter() - t0:.1f} s, rc {res.returncode}", flush=True)
        for line in (res.stdout + res.stderr).splitlines():
            if any(w in line for w in ("error", "spill", "Performance Loss", "setmaxnreg")):
                print(f"[build] {name}: {line.strip()[:200]}", flush=True)
        if res.returncode:
            return 1
        libs[name] = fa.bind(ctypes.CDLL(str(out)))
    print(cs._gpu_line(), flush=True)
    for name in list(libs) + list(reversed(list(libs))):
        print(f"== {name}", flush=True)
        fa._lib = libs[name]
        for widths, shapes in cs.FLASH_ROWS:
            cs.flash_phase(fa, widths, shapes)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
