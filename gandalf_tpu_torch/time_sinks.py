"""Time the 3D sink kernels (K16-K18, K20), K14 and the tree kernels
K4-K7 of the checkout it runs from, each beside nothing else, and print
one JSON line of ms a launch (CUDA events, the whole wrapper; 20
repeats, K14 10).

    python -m gandalf_tpu_torch.time_sinks TAG

The inputs are those of chip_smoke.py's 3D sink path at its kernels'
shapes: check.sink_kernel_inputs and check.smooth_accretion_inputs at
262,144 gas particles and 16 slots in float32, K14 on the 8,192-star
Plummer cluster with a coincident pair, and K4-K7 on the
self-gravitating box at 64^3.  To compare two commits on one card, run
it in a checkout of each, in turns (parent, change, change, parent), in
one call; a commit without this file takes a copy of it (it needs only
check.py's comparisons).  Refuses to run without CUDA.
"""

from __future__ import annotations

import json
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("time_sinks: no CUDA device")
    from . import _ext
    from .check import (compare_nbody_kernels, compare_sink_kernels,
                        compare_td_sink_kernels, compare_tree_kernels,
                        jittered_box_ic, nbody_kernel_inputs,
                        sink_kernel_inputs, slice_params,
                        smooth_accretion_inputs)
    from .kernels.smoothing import kernel_factory
    from .sim.simulation import GradhSphSimulation

    _ext.lib()
    dev = torch.device("cuda", 0)
    kern = kernel_factory("m4", 3)
    f32 = torch.float32
    rep = compare_sink_kernels(
        kern, sink_kernel_inputs(262144, 16, dev, f32), repeats=20)
    rep.update(compare_td_sink_kernels(
        kern, smooth_inputs=smooth_accretion_inputs(262144, 16, dev, f32),
        repeats=20))
    (r, v, m, h), k = nbody_kernel_inputs(8192, dev, f32)
    rep.update(compare_nbody_kernels(r, v, m, h, k, repeats=10,
                                     which=("direct_softened",)))
    params = slice_params(64, self_gravity=1)
    sim = GradhSphSimulation(params, device=dev, dtype=f32)
    sim.SetupSimulation(jittered_box_ic(params, 64))
    rep.update(compare_tree_kernels(sim, sim.state, repeats=20))
    out = {"tag": sys.argv[1] if len(sys.argv) > 1 else "",
           "card": torch.cuda.get_device_name(0)}
    out.update({name: {"ms": r["ms"], "ok": r["ok"]}
                for name, r in rep.items() if "ms" in r})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
