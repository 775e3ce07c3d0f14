#!/usr/bin/env python3
"""A/B of kernel sources on one NVIDIA card.

    python3 kernel_ab.py KERNEL NAME=PATH[:FLAG,FLAG...] [NAME=PATH ...] [--splits N,...] [--blocks N,...] [--ff N,...]

KERNEL is ``flash``, ``decode``, ``scan`` or ``gather``. Each PATH is a version of that
kernel's source, ``<tree>/src/repro_torch/kernels/<package>/csrc/<file>.cu``:
for example the package's own and the parent commit's, unpacked with
``git archive`` into a directory that ``.gitignore`` lists. Each is built
with the package's nvcc flags and its own tree's shared headers (plus the
optional ``-D`` or ``-Xptxas`` flags after the colon) into
``build/kernel_ab/NAME.so``, and its ptxas spill and serialisation lines are
printed. The ``ops.py`` beside the source is loaded as a module of its own
with that library, so two versions may differ in their C entries and their
launch plans. Each then runs through chip_smoke's phases at chip_smoke's
shapes, checked against its plain version and timed as CUDA-graph replays:
``flash_phase`` for every ``FLASH_ROWS`` entry, ``decode_phase`` and
``paged_phase``, ``scan_phase``, or ``gather_phase`` and
``gather_matmul_phase``. The phases reach each version through its wrappers
only (``plans=False``: they do not print the launch plans, whose functions
may differ between versions). The versions run in the order a, b, ..., b, a,
so that drift on the card shows as a difference between a version's two
passes. With ``--splits`` (decode only) each pass runs the decode phases
once for each forced split count instead of the version's own dense split
plan (``split_plan``): a sweep of the plan's choice. A count above 8 is
rounded up to whole clusters of 8. With ``--blocks`` (decode only, versions
whose paged plan is ``paged_plan`` returning the work list's ``blocks``)
each pass runs the paged phase once for each forced ``blocks``. With
``--ff`` (gather only) each pass runs the gather-matmul phase once for each
weight width F in place of Mixtral's 16384: fewer column strips, so fewer
blocks share the card.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGES = {"flash": "flash_attention", "decode": "decode_attention", "scan": "rglru_scan",
            "gather": "tiered_gather"}


def _load_ops(name: str, src: Path, lib: ctypes.CDLL):
    """The ``ops.py`` beside ``src`` as a fresh module whose wrappers use ``lib``."""
    spec = importlib.util.spec_from_file_location(f"kernel_ab_{name}", src.parents[1] / "ops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Prebuilt:  # stands in for kernels.nvcc inside that module
        @staticmethod
        def load(_name, _src):
            return lib

    mod.nvcc = Prebuilt
    mod._lib = None
    return mod


def _forced_plan(n: int):
    """A decode split plan of n splits of whole 64-key tiles in place of the
    version's own: up to 8 (fewer where the cache has fewer tiles) are one
    cluster; more are whole clusters of 8, the last splits empty where the
    tiles do not divide."""
    def plan(B, Hkv, cap, *rest):
        tiles = -(-cap // 64)
        if n > 8:
            splits = -(-n // 8) * 8
            return -(-tiles // splits) * 64, splits
        per = -(-tiles // n)
        return per * 64, -(-tiles // per)
    return plan


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available() or len(argv) < 2 or argv[0] not in PACKAGES:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import nvcc

    kernel, sweeps = argv[0], {}
    for opt in ("--splits", "--blocks", "--ff"):
        if opt in argv:
            i = argv.index(opt)
            sweeps[opt] = [int(n) for n in argv[i + 1].split(",")]
            argv = argv[:i] + argv[i + 2:]
    out_dir = REPO / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    mods = {}
    for arg in argv[1:]:
        name, _, spec = arg.partition("=")
        path, _, flags = spec.partition(":")
        src = Path(path).resolve()
        if src.parents[1].name != PACKAGES[kernel]:
            print(f"{path} is not a source of kernels/{PACKAGES[kernel]}", file=sys.stderr)
            return 2
        out = out_dir / f"{name}.so"
        t0 = time.perf_counter()
        res = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-I", str(src.parents[2] / "csrc"),
                              *[f for f in flags.split(",") if f], "-o", str(out), str(src)],
                             capture_output=True, text=True)
        print(f"[build] {name}: {time.perf_counter() - t0:.1f} s, rc {res.returncode}", flush=True)
        for line in (res.stdout + res.stderr).splitlines():
            if any(w in line for w in ("error", "spill", "Performance Loss", "setmaxnreg")):
                print(f"[build] {name}: {line.strip()[:200]}", flush=True)
        if res.returncode:
            return 1
        mods[name] = _load_ops(name, src, ctypes.CDLL(str(out)))
    print(cs._gpu_line(), flush=True)
    for name in list(mods) + list(reversed(list(mods))):
        print(f"== {name}", flush=True)
        ops = mods[name]
        if kernel == "flash":
            for widths, shapes in cs.FLASH_ROWS:
                cs.flash_phase(ops, widths, shapes)
        elif kernel == "decode" and "--blocks" in sweeps:
            for n in sweeps["--blocks"]:
                print(f"-- {n} blocks", flush=True)
                ops.paged_plan = lambda *args, n=n: n  # the module's paged wrapper reads its plan
                cs.paged_phase(ops, plans=False)
        elif kernel == "decode":
            for n in sweeps.get("--splits", [None]):
                if n is not None:
                    print(f"-- {n} splits", flush=True)
                    ops.split_plan = _forced_plan(n)  # the module's wrappers read its plan
                cs.decode_phase(ops, plans=False)
                cs.paged_phase(ops, plans=False)
        elif kernel == "scan":
            cs.scan_phase(ops, plans=False)
        elif "--ff" in sweeps:
            for f in sweeps["--ff"]:
                print(f"-- F {f}", flush=True)
                cs.D_FF = f  # the phase's weight width
                cs.gather_matmul_phase(ops)
        else:
            cs.gather_phase(ops)
            cs.gather_matmul_phase(ops)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
