#!/usr/bin/env python3
"""The decode-step kernels beside two floors and two variants, on one
NVIDIA GPU.

    python3 scripts/step_kernel_sweep.py

At 64 and 16 rows of d = dv = 128, bf16 q, k, v, fp32 state rotated over
enough copies that every launch finds its state cold (``chip_smoke.py``'s
``time_step`` and its ``median_ms``), it times:

- two floors of that timing: one launch of a one-element add, and one
  in-place multiply over as many fp32 bytes as a step's state (each read and
  written once, as the step kernels do) on as many rotated copies;
- ``hla2_step`` and ``ahla_step`` as the tree builds them, and variants
  built from a copy of ``csrc/`` (into ``build/step_kernel_sweep/<name>/``)
  with one change each:
  - ``cluster8``: ``CLUSTER = 8`` in ``step_cluster.cuh`` (the tree keeps
    4);
  - ``at_once``: every TMA copy issued at the start, rather than the later
    matrices once the first has landed.

Each build is first held against its plain version as ``chip_smoke.py``
holds the tree's (4 steps at 64 rows x d 128, and at the ragged d 72,
dv 40).  Builds are timed in the order base, variants, variants reversed,
base; the times are printed last, beside the card's name and power limit.
"""

import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

KERNELS = ("hla2_step", "ahla_step")
CLUSTER_LINE = "constexpr int CLUSTER = 4;"


def _cluster8(name, files):
    h = files["step_cluster.cuh"]
    if CLUSTER_LINE not in h:
        raise RuntimeError(f"step_cluster.cuh no longer says {CLUSTER_LINE}")
    files["step_cluster.cuh"] = h.replace(CLUSTER_LINE,
                                          "constexpr int CLUSTER = 8;")


def _at_once(name, files):
    src = files[f"{name}.cu"]
    late = re.search(r"  wait_bar\(bars \+ 1\);\n  if \(tid == 0\) \{\n"
                     r"(.*?)  \}\n", src, re.S)
    first = re.search(r"    load_box\(\w+, \w+, \w+, row \* d, bars \+ 1\);"
                      r"\n", src)
    if not (late and first):
        raise RuntimeError(f"{name}.cu: the later TMA copies are not where "
                           "this variant expects them")
    src = src.replace(late.group(0), "  wait_bar(bars + 1);\n")
    files[f"{name}.cu"] = src.replace(first.group(0),
                                      first.group(0) + late.group(1))


VARIANTS = {"cluster8": _cluster8, "at_once": _at_once}


def build(variant):
    """Both step kernels of ``variant`` (None: the tree's sources):
    {name: loaded library}."""
    from repro_torch.kernels import _build, decode_step

    out = _build.BUILD_ROOT.parent / "step_kernel_sweep" / (variant or "tree")
    out.mkdir(parents=True, exist_ok=True)

    def one(name):
        files = {p.name: p.read_text() for p in
                 list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / f"{name}.cu"]}
        if variant:
            VARIANTS[variant](name, files)
        for fname, text in files.items():  # a quoted include finds the copy
            (out / fname).write_text(text)
        lib = out / f"lib{name}.so"
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({variant}):\n"
                               f"{res.stdout}")
        cdll = ctypes.CDLL(str(lib))
        fn = getattr(cdll, name)
        fn.argtypes, fn.restype = {"hla2_step": decode_step._SIG,
                                   "ahla_step": decode_step._AHLA_SIG}[name]
        return cdll

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(one, KERNELS)))


def floors(device, rows, d=128):
    """(one-element add, in-place multiply over a state's bytes), in ms."""
    import torch

    import chip_smoke as cs

    tiny = torch.zeros(1, device=device)
    numel = rows * (3 * d * d + 2 * d)
    n_st = max(8, -(-100_000_000 // (4 * numel)))
    flats = [torch.randn(numel, device=device) for _ in range(n_st)]
    add = cs.median_ms(lambda i: tiny.add_(1), 40)
    mul = cs.median_ms(lambda i: flats[i % n_st].mul_(0.999), 40)
    cs.log(f"floors at rows {rows}: one-element add {add:.4f} ms, in-place "
           f"multiply over {4 * numel / 1e6:.2f} MB of fp32 ({n_st} copies "
           f"rotated) {mul:.4f} ms")
    return add, mul


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_kernel_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    cs.CARD = cs.card()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    names = [None] + list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    for name in names:
        _build._libs.update(libs[name])  # the wrappers now launch this build
        cs.log(f"{name or 'tree'}: checks")
        for rows, d, dv, n_prior in ((64, 128, None, 300), (6, 72, 40, 70)):
            cs.check_step(device, rows=rows, d=d, dv=dv, n_prior=n_prior)
            cs.check_ahla_step(device, rows=rows, d=d, dv=dv, n_prior=n_prior)
    lines = []
    for rows in (64, 16):
        add, mul = floors(device, rows)
        lines.append(f"rows={rows} floors: one-element add {add:.4f} ms, "
                     f"in-place multiply over the state's bytes {mul:.4f} ms")
        for name in names + names[::-1]:
            _build._libs.update(libs[name])
            gen = torch.Generator(device=device).manual_seed(rows)
            for mixer in ("hla2", "ahla"):
                ms, _, bound, _ = cs.time_step(device, mixer, gen, rows,
                                               plain=False)
                lines.append(f"rows={rows} {name or 'tree'} {mixer}_step: "
                             f"{ms:.4f} ms, bound {bound:.4f} ms "
                             f"({bound / ms:.1%} of bound)")
    print(cs.CARD)
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
