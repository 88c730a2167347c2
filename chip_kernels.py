#!/usr/bin/env python3
"""Times of the port's three CUDA kernels at the shapes the main paths
give them, on one NVIDIA GPU, for this checkout's package or another's.

    python3 chip_kernels.py              # this checkout
    python3 chip_kernels.py --tree DIR   # the package under DIR, e.g. a
                                         # `git archive` of an earlier commit
    python3 chip_kernels.py --sweep      # and config 3's sweep around them
    python3 chip_kernels.py --kernels h1 # only these kernels (of jacobi,
                                         # h1, nd)

It builds that package's kernels, prints each kernel entry's registers,
spills and shared memory (``chip_smoke.ptxas_report``), sets up config 3
(the inputs of the L-twin, h1 and nd calls), the FCC field path of
config 4 (n=8 p=4: Jacobi on its 512 × 64×64 L-twin batch, nd at (l, q)
= (5, 6)) and, where the package has the scalar Helmholtz operator,
config 2 (its h1 shapes and Jacobi 45×45), prints nd's launch shape and
resident blocks per SM at its config-3 and FCC calls (where the package
reports them, ``nd_apply.launch_shape``) and prints the card's name and power
limit, one line per kernel and shape (``chip_smoke.kernel_times``, config 5's
h1 and Jacobi shapes too where the package has config 5: the kernel's call
time between CUDA events and its device time from a ``torch.profiler``
trace, for Jacobi ``torch.linalg.eigh``'s two times; the plain versions
are not timed) and the records as one JSON line. With ``--sweep`` it runs
config 3's warm sweep (``chip_smoke.phase_dielectric``: a cold pass, 2
timed passes, every oracle and launch gate) once before the timings and
once after them, and prints both rates: whether the profiler sessions of
the timings slow the later launches of their process. Run on two trees
in one chip call (parent, change, change, parent) it compares them on one
card. Exits 1 without a CUDA device.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke  # this checkout's timing helpers; caps the host BLAS


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(chip_smoke.REPO),
                    help="checkout whose bravais_tpu_torch is timed")
    ap.add_argument("--sweep", action="store_true",
                    help="run config 3's sweep before and after the timings")
    ap.add_argument("--kernels", nargs="+", default=["jacobi", "h1", "nd"],
                    choices=["jacobi", "h1", "nd"],
                    help="the kernels to time (default all three)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_kernels: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import bravais_tpu_torch
    if Path(bravais_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {bravais_tpu_torch.__file__}, not the "
                           f"package under {tree}")
    from bravais_tpu_torch.utils import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    chip_smoke.log("device", f"{smi}; timing the package under {tree}")
    ptxas = chip_smoke.ptxas_report(cuda_build.build_all())
    dev = torch.device("cuda", 0)
    setup = chip_smoke.dielectric(dev)
    fcc = {"jacobi", "nd"} & set(args.kernels)
    op4 = chip_smoke.fcc_problem(dev)[2] if fcc else None
    occupancy = nd_occupancy(dev, setup[2], op4) if "nd" in fcc else None
    rates = {}
    if args.sweep:
        rates["untraced"] = chip_smoke.phase_dielectric(dev, setup)[1]
    rods = (chip_smoke.rods_setup(dev) if importlib.util.find_spec(
        "bravais_tpu_torch.operators.helmholtz") else None)
    op5 = (chip_smoke.config5_operator(dev) if importlib.util.find_spec(
        "bravais_tpu_torch.cli.config5_all14") else None)
    times = chip_smoke.kernel_times(dev, setup[2], rods, plain=False,
                                    op4=op4, op5=op5, kernels=args.kernels)
    chip_smoke.log_times(times)
    if args.sweep:
        rates["after_trace"] = chip_smoke.phase_dielectric(dev, setup)[1]
        chip_smoke.log("sweep", f"config 3 eig/s: {rates['untraced']:.4f} "
                       f"untraced, {rates['after_trace']:.4f} after the "
                       f"profiler sessions; tree {tree}")
    print(json.dumps({"tree": str(tree), "device": smi, "kernels": times,
                      "config3_eig_s": rates, "ptxas": ptxas,
                      "nd_occupancy": occupancy}), flush=True)
    return 0


def nd_occupancy(dev, op3, op4):
    """{call: launch shape} of nd's config-3 calls (16 rows fused and
    M-half, 48 rows fused) and the FCC field path's (16 rows fused and
    M-half), where the package reports it, else None."""
    import torch
    from bravais_tpu_torch.operators import nd_apply
    if not hasattr(nd_apply, "launch_shape"):
        return None
    out = {}
    for tag, op, rows, want in (("", op3, 16, "AM"), ("", op3, 16, "M"),
                                ("", op3, 48, "AM"), ("fcc ", op4, 16, "AM"),
                                ("fcc ", op4, 16, "M")):
        c = op.nd_consts()
        ue = torch.zeros((rows * c.nelem, c.ndof), dtype=torch.complex64,
                         device=dev)
        out[f"{tag}rows {rows} {want}"] = shape = nd_apply.launch_shape(
            ue, c, want)
        chip_smoke.log("occupancy", f"nd {tag}rows {rows} {want}: "
                       f"{shape['rows_per_block']} element-rows "
                       f"({shape['threads']} threads, {shape['smem_bytes']} "
                       f"B shared) per block, {shape['blocks_per_sm']} "
                       f"resident blocks per SM")
    return out


if __name__ == "__main__":
    sys.exit(main())
