"""Time the single-device grid kernels K1-K3 of the checkout it runs
from on the SPH box at 64^3 in float32 (M4, and the quintic), and print
one JSON line of ms a launch (CUDA events, the whole wrapper; the mean
of two turns of 20 repeats).

    python -m gandalf_tpu_torch.time_grid27 TAG

The inputs are chip_smoke.py's hydro main path's after its setup
(check.slice_params, check.jittered_box_ic), the comparison
check.compare_kernels.  To compare two commits on one card, run it in a
checkout of each, in turns (parent, change, change, parent), in one
call; a commit without this file takes a copy of it (it needs only
check.py's comparisons).  Refuses to run without CUDA.
"""

from __future__ import annotations

import json
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("time_grid27: no CUDA device")
    from . import _ext
    from .check import compare_kernels, jittered_box_ic, slice_params
    from .sim.simulation import GradhSphSimulation

    _ext.lib()
    dev = torch.device("cuda", 0)
    out = {"tag": sys.argv[1] if len(sys.argv) > 1 else "",
           "card": torch.cuda.get_device_name(0)}
    for kernel in ("m4", "quintic"):
        params = slice_params(64)
        params.set("kernel", kernel)
        sim = GradhSphSimulation(params, device=dev, dtype=torch.float32)
        sim.SetupSimulation(jittered_box_ic(params, 64))
        rep = compare_kernels(sim, sim.state, repeats=20)
        out.update({name: {"ms": r["ms"], "ok": r["ok"],
                           "k_cell": sim.gridspec.k_cell}
                    for name, r in rep.items() if "ms" in r})
        del sim
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
