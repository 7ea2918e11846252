"""Command-line entry point of the port (gandalf_tpu/__main__.py's
counterpart; src/Common/gandalf.cpp).

Usage:
    python -m gandalf_tpu_torch <paramfile>        run a simulation
    python -m gandalf_tpu_torch -r <paramfile>     restart from the last
                                                   snapshot (run_id.restart)

Runs on the CUDA device and raises when there is none: unlike the JAX
package's command line, it never falls back to the CPU.  Writes the
snapshots of out_file_form (GANDALF_WRITE_SNAPSHOTS defaults to 1 here),
a `run_id.param` record, a `run_id.timing` report and a `cont` file that
a clean finish removes (the cluster auto-resubmit convention,
gandalf.cpp:126-128), all in the working directory.  ``main(argv,
device="cpu")`` runs the plain versions of the kernels on the CPU, for
tests.
"""

from __future__ import annotations

import os
import sys

import torch


def main(argv=None, device="cuda", dtype=None) -> int:
    """Run (or with -r restart) the parameter file in argv; `device` and
    `dtype` go to SimulationBase.factory.  Returns the exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    restart = False
    if argv and argv[0] == "-r":
        restart = True
        argv = argv[1:]
    if len(argv) != 1:
        print("Usage: python -m gandalf_tpu_torch [-r] <paramfile>",
              file=sys.stderr)
        return 1
    paramfile = argv[0]
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("python -m gandalf_tpu_torch runs on a CUDA "
                           "device and there is none")
    print("GANDALF-TPU PyTorch/CUDA port — SPH / MFV / N-body")

    from .params import Parameters
    from .sim.simulation import SimulationBase

    params = Parameters()
    params.read_file(paramfile)
    run_id = params.stringparams["run_id"]

    os.environ.setdefault("GANDALF_WRITE_SNAPSHOTS", "1")
    sim = SimulationBase.factory(params, device, dtype)

    if restart:
        restart_file = f"{run_id}.restart"
        if not os.path.exists(restart_file):
            print(f"No restart file {restart_file}", file=sys.stderr)
            return 1
        t0 = sim.load_restart_snapshot()
        print(f"Restarting from t = {t0!r}")
    params.record_to_file(f"{run_id}.param")

    with open("cont", "w") as f:
        f.write(run_id + "\n")
    try:
        sim.SetupSimulation()
        sim.Run()
    finally:
        sim.timing.write(f"{run_id}.timing")
    if os.path.exists("cont"):
        os.remove("cont")
    print(f"Final t : {sim.t:.6g}     Total no. of steps : {sim.Nsteps}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
