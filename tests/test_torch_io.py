"""The port's snapshot I/O, diagnostics, output cadence, restarts and
command line against gandalf_tpu's, on the CPU in float64.

- ``gandalf_tpu_torch/sim/io.py``: every writer's file equals the JAX
  package's byte for byte (column, SEREN unformatted and formatted with
  and without stars, SEREN lite), every reader reads it back, and each
  package's reader reads the other's files to equal arrays;
- ``gandalf_tpu_torch/utils/diagnostics.py``: Diagnostics.compute and
  its line equal the JAX package's in 1-3 dims;
- ``python -m gandalf_tpu_torch`` (``main(argv, device="cpu")``) on
  check.cli_params's 2D radiating run (binaryacc's two stars as sources
  of the ionisation scheme) writes the files the JAX package's command
  line writes for the same parameter file, with snapshots within 1e-9; a
  run stopped by Nstepsmax and restarted with -r agrees with the JAX
  package's stop and restart to 1e-9, starting at the stopped run's t;
- the command line refuses to run without CUDA unless asked for the CPU;
- ROADMAP fault F32: in float32 the JAX package's Run spins on at
  float32(tend) < tend until Nstepsmax, where the port stops;
- ROADMAP fault F33: the JAX package's column reader drops a snapshot's
  stars, so its restart starts without them; the port refuses such a
  restart.

Every file goes under the test's tmp_path.
"""

import os

import numpy as np
import pytest
import torch

from gandalf_tpu.__main__ import main as jax_main
from gandalf_tpu.sim import io as jio
from gandalf_tpu.utils.diagnostics import Diagnostics as JaxDiagnostics
from gandalf_tpu_torch.__main__ import main as torch_main
from gandalf_tpu_torch.check import (cli_params, write_cli_stellar_table,
                                     write_param_file)
from gandalf_tpu_torch.sim import io as tio
from gandalf_tpu_torch.utils.diagnostics import Diagnostics

torch.set_num_threads(1)

TOL = 1e-9
FIELDS = ("r", "v", "m", "h", "rho", "u")


def _hydro(n=60, ndim=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"r": rng.random((n, ndim)), "v": rng.standard_normal((n, ndim)),
            "m": rng.random(n) + 0.5, "h": rng.random(n) * 0.1 + 0.01,
            "rho": rng.random(n) + 0.5, "u": rng.random(n) + 0.1,
            "iorig": np.arange(n)}


def _stars(ndim, seed=1):
    rng = np.random.default_rng(seed)
    return {"r": rng.random((3, ndim)), "v": rng.standard_normal((3, ndim)),
            "m": rng.random(3) + 1.0, "h": np.full(3, 0.1)}


# form: (writer, reader or None)
FORMS = {
    "column": ("write_column_snapshot", "read_column_snapshot"),
    "su": ("write_seren_unform", "read_seren_unform"),
    "sf": ("write_seren_form", "read_seren_form"),
    "sl": ("write_seren_lite", None),
}


def _write(mod, form, fname, hydro, star):
    writer = getattr(mod, FORMS[form][0])
    if form == "column":
        writer(fname, 1.25, hydro, nstar=0 if star is None else 3,
               star=star)
    elif form == "sl":
        writer(fname, 1.25, hydro, noutsnap=4)
    else:
        writer(fname, 1.25, hydro, h_fac=1.2, nsteps=42, noutsnap=4,
               star=star)


@pytest.mark.parametrize("form,stars", [(f, s) for f in sorted(FORMS)
                                         for s in (False, True)
                                         if not (s and f == "sl")])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_writers_equal_and_round_trip(tmp_path, form, ndim, stars):
    """Both packages' writers give the same bytes; the port's reader
    reads its file back (the stars too, where the format carries them
    back; SEREN lite carries none and has no reader) and the JAX reader
    reads the port's file to equal arrays."""
    hydro = _hydro(ndim=ndim)
    star = _stars(ndim) if stars else None
    mine, theirs = tmp_path / "port.snap", tmp_path / "jax.snap"
    _write(tio, form, str(mine), hydro, star)
    _write(jio, form, str(theirs), hydro, star)
    assert mine.read_bytes() == theirs.read_bytes()
    reader = FORMS[form][1]
    if reader is None:
        return
    t, data = getattr(tio, reader)(str(mine))
    tj, dj = getattr(jio, reader)(str(mine))
    assert t == tj == 1.25
    # the ASCII forms hold 12 (column) or 11 (sf) significant digits
    rtol = 1e-15 if form == "su" else 1e-9
    for k in FIELDS:
        np.testing.assert_allclose(data[k], hydro[k], rtol=rtol)
        np.testing.assert_array_equal(data[k], dj[k])
    if stars and form != "column":
        assert data["nstar"] == 3
        for k in ("r", "v", "m", "h"):
            np.testing.assert_allclose(data["star"][k], star[k], rtol=rtol)
            np.testing.assert_array_equal(data["star"][k], dj["star"][k])


@pytest.mark.parametrize("form", ["column", "su", "sf"])
def test_jax_files_read_by_the_port(tmp_path, form):
    """A snapshot the JAX package writes reads through the port's reader
    to the arrays the JAX reader gives."""
    hydro, star = _hydro(ndim=2), _stars(2)
    fname = str(tmp_path / "jax.snap")
    _write(jio, form, fname, hydro, star)
    reader = FORMS[form][1]
    t, data = getattr(tio, reader)(fname)
    tj, dj = getattr(jio, reader)(fname)
    assert t == tj
    for k in FIELDS:
        np.testing.assert_array_equal(data[k], dj[k])
    assert data["nstar"] == dj["nstar"] == 3


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("gravity", [False, True])
def test_diagnostics_equal_jax(ndim, gravity):
    hydro = _hydro(ndim=ndim, seed=4)
    gpot = np.random.default_rng(5).random(60) if gravity else None
    args = (hydro["r"], hydro["v"], hydro["m"], hydro["u"], gpot)
    mine, theirs = Diagnostics.compute(*args), JaxDiagnostics.compute(*args)
    for k in ("Nhydro", "Etot", "ke", "utot", "gpe", "mtot"):
        assert getattr(mine, k) == getattr(theirs, k), k
    for k in ("mom", "angmom", "rcom", "vcom"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(theirs, k))
    d0 = JaxDiagnostics.compute(hydro["r"], 0.5 * hydro["v"], hydro["m"],
                                hydro["u"], gpot)
    assert mine.line(0.3, d0) == theirs.line(0.3, d0)
    assert mine.energy_error(d0) == theirs.energy_error(d0)


# ---------------------------------------------------------------------------
# the command line, snapshots and restarts
# ---------------------------------------------------------------------------

RUN_ID = "HII2D"


def _cli(pkg, workdir, argv, params):
    """Run a package's command line in `workdir` on `params` (written as
    run.dat, with the flat stellar.dat beside it)."""
    workdir.mkdir(exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        if not os.path.exists("run.dat"):
            write_param_file(params, "run.dat")
            write_cli_stellar_table("stellar.dat")
        if pkg == "jax":
            return jax_main(argv + ["run.dat"])
        return torch_main(argv + ["run.dat"], device="cpu",
                          dtype=torch.float64)
    finally:
        os.chdir(cwd)


def _snapshots(workdir):
    return sorted(p.name for p in workdir.glob(f"{RUN_ID}.su.*"))


def _assert_same_snapshot(a, b):
    ta, da = tio.read_seren_unform(str(a))
    tb, db = tio.read_seren_unform(str(b))
    assert ta == pytest.approx(tb, rel=TOL, abs=0.0)
    for k in FIELDS:
        scale = max(np.abs(db[k]).max(), 1e-300)
        assert np.abs(da[k] - db[k]).max() / scale <= TOL, (a.name, k)
    assert da["nstar"] == db["nstar"] == 2
    for k in ("r", "v", "m"):
        scale = np.abs(db["star"][k]).max()
        assert np.abs(da["star"][k] - db["star"][k]).max() / scale <= TOL


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The 2D radiating run (check.cli_params(8): 256 particles, two
    stars, the ionisation scheme every step, SEREN snapshots every
    0.025 to t = 0.1) through each package's command line, and the same
    run stopped by Nstepsmax = 6 then restarted with -r."""
    base = tmp_path_factory.mktemp("cli")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GANDALF_WRITE_SNAPSHOTS", "1")
        for pkg in ("jax", "torch"):
            full = base / f"{pkg}_full"
            assert _cli(pkg, full, [], cli_params()) == 0
            stop = base / f"{pkg}_stop"
            assert _cli(pkg, stop, [], cli_params(nstepsmax=6)) == 0
            stopped = _snapshots(stop)
            # the restart runs on to tend
            write_param_file(cli_params(), stop / "run.dat")
            assert _cli(pkg, stop, ["-r"], None) == 0
            out[pkg] = {"full": full, "stop": stop, "stopped": stopped}
    return out


def test_cli_writes_the_jax_files(cli_runs):
    """The same files by name, the snapshots equal within 1e-9, the
    param record and the restart pointer equal, no cont file left."""
    j, t = cli_runs["jax"]["full"], cli_runs["torch"]["full"]
    names = sorted(p.name for p in j.iterdir())
    assert names == sorted(p.name for p in t.iterdir())
    assert f"{RUN_ID}.restart" in names and f"{RUN_ID}.diag" in names
    assert f"{RUN_ID}.timing" in names and "cont" not in names
    assert len(_snapshots(t)) >= 4
    for name in _snapshots(t):
        _assert_same_snapshot(t / name, j / name)
    assert (t / f"{RUN_ID}.param").read_text() \
        == (j / f"{RUN_ID}.param").read_text()
    assert (t / f"{RUN_ID}.restart").read_text() \
        == (j / f"{RUN_ID}.restart").read_text()
    diag_t = np.loadtxt(t / f"{RUN_ID}.diag", ndmin=2)
    diag_j = np.loadtxt(j / f"{RUN_ID}.diag", ndmin=2)
    np.testing.assert_allclose(diag_t, diag_j, rtol=TOL, atol=1e-12)


def test_restart_matches_jax(cli_runs):
    """The stopped runs wrote the same snapshots; each restart starts at
    its stopped run's t (rel 1e-10), goes on to tend and writes the same
    snapshots as the JAX package's restart, to 1e-9."""
    j, t = cli_runs["jax"], cli_runs["torch"]
    assert t["stopped"] == j["stopped"] and t["stopped"]
    names = _snapshots(t["stop"])
    assert names == _snapshots(j["stop"])
    assert len(names) > len(t["stopped"])
    for name in names:
        _assert_same_snapshot(t["stop"] / name, j["stop"] / name)
    last_stopped = tio.read_seren_unform(
        str(t["stop"] / t["stopped"][-1]))[0]
    first_new = names[len(t["stopped"])]
    t_last = tio.read_seren_unform(str(t["stop"] / names[-1]))[0]
    assert t_last == pytest.approx(0.1, rel=1e-12)
    assert tio.read_seren_unform(str(t["stop"] / first_new))[0] \
        > last_stopped


def test_restart_starts_at_the_stopped_t(tmp_path, monkeypatch):
    """load_restart_snapshot hands setup the stopped run's state: the
    restarted controller starts at its t (rel 1e-10) with its stars."""
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GANDALF_WRITE_SNAPSHOTS", "1")
    write_cli_stellar_table("stellar.dat")
    sim = SimulationBase.factory(cli_params(nstepsmax=5), "cpu",
                                 torch.float64)
    sim.Run()
    assert sim.Nsteps == 5
    sim._write_restart_snapshot()
    again = SimulationBase.factory(cli_params(), "cpu", torch.float64)
    t0 = again.load_restart_snapshot()
    assert t0 == pytest.approx(sim.t, rel=1e-10)
    again.SetupSimulation()
    assert again.t == pytest.approx(sim.t, rel=1e-10)
    assert int(again.state.sinks.active.sum()) == 2
    assert again.Noutsnap == sim.Noutsnap
    again.Run()
    assert again.t == pytest.approx(0.1, rel=1e-12)
    assert np.isfinite(again.state.u.numpy()).all()


def test_snapshots_spill_beyond_the_cache(tmp_path, monkeypatch):
    """Beyond GANDALF_SNAPSHOT_CACHE snapshots the oldest spill to .npz
    files under the temporary directory and read back equal."""
    from gandalf_tpu_torch.check import slice_params
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    monkeypatch.setenv("GANDALF_SNAPSHOT_CACHE", "2")
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    sim = SimulationBase.factory(slice_params(4), "cpu", torch.float64)
    sim.SetupSimulation()
    for _ in range(4):
        sim.main_loop_step()
        sim._take_snapshot()
    assert [s.loaded for s in sim.snapshots] == [False, False, True, True]
    assert list(tmp_path.rglob("*.npz"))
    first = sim.snapshots[0]
    assert first.data["r"].shape == (64, 3) and first.loaded


def test_cli_refuses_without_cuda(tmp_path, monkeypatch):
    """Unlike the JAX command line, the port's has no CPU fallback: with
    no CUDA device it raises before writing anything, unless the caller
    asks for the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_param_file(cli_params(), "run.dat")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main(["run.dat"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["run.dat"]
    assert torch_main([]) == 1


def test_float32_run_stops_at_tend_f32():
    """ROADMAP fault F32: the Sod tube of tests/test_adsod.py at 64 + 16
    particles in float32 (neib_search kdtree), tend 0.02, Nstepsmax 400.
    float32(0.02) = 0.0199999996 < 0.02: the JAX package's Run compares
    t with the Python float tend, so once t reaches float32(tend) (step
    4) every later step adds nothing and it runs on to Nstepsmax.  The
    port compares in the state's type and stops at float32(tend) after
    the same 4 steps; the two t agree."""
    import jax

    from gandalf_tpu.params import Parameters as JaxParameters
    from gandalf_tpu.sim.simulation import SimulationBase as JaxSim
    from gandalf_tpu_torch.check import sod_params
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    p = sod_params(64, 16, tend=0.02)
    for k, v in (("Nstepsmax", 400), ("neib_search", "kdtree"),
                 ("run_id", ""), ("tsnapfirst", 1.0e30),
                 ("dt_snap", 1.0e30)):
        p.set(k, v)
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(p, table))
    with jax.enable_x64(False):
        jsim = JaxSim.factory(jp)
        jsim.Run()
        assert np.asarray(jsim.state.r).dtype == np.float32
    tsim = SimulationBase.factory(p, "cpu", torch.float32)
    tsim.Run()
    tend32 = float(np.float32(0.02))
    assert tend32 < 0.02
    assert jsim.Nsteps == 400
    assert tsim.Nsteps == 4
    assert float(jsim.t) == tsim.t == tend32


def _column_restart(tmp_path, mod):
    """A column snapshot of 60 gas particles and 3 stars in 2D (the
    writer of `mod`) and the run_id.restart pointer to it, under
    tmp_path."""
    fname = str(tmp_path / "RUN.column.00003")
    mod.write_column_snapshot(fname, 0.5, _hydro(ndim=2), nstar=3,
                              star=_stars(2))
    (tmp_path / "RUN.restart").write_text(f"column\n{fname}\n")
    return fname


def test_column_restart_drops_stars_in_jax_f33(tmp_path, monkeypatch):
    """ROADMAP fault F33 on the JAX package: its column reader reads the
    header's star count but only the gas rows, so its restart loader
    stages 60 gas particles and no star for setup."""
    from gandalf_tpu.params import Parameters as JaxParameters
    from gandalf_tpu.sim.simulation import SimulationBase as JaxSim
    from gandalf_tpu_torch.check import cli_params

    monkeypatch.chdir(tmp_path)
    _column_restart(tmp_path, jio)
    p = cli_params()
    p.set("run_id", "RUN")
    q = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(q, table).update(getattr(p, table))
    jsim = JaxSim.factory(q)
    jsim.load_restart_snapshot()
    data = jsim.restart_data
    assert data["nstar"] == 3
    assert len(data["m"]) == 60 and "star" not in data
    assert data["t"] == 0.5


def test_column_restart_with_stars_refused_f33(tmp_path, monkeypatch):
    """The port's restart loader refuses a column snapshot whose header
    counts stars (F33), naming the fault; without stars it loads."""
    from gandalf_tpu_torch.check import cli_params
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    monkeypatch.chdir(tmp_path)
    _column_restart(tmp_path, tio)
    p = cli_params()
    p.set("run_id", "RUN")
    sim = SimulationBase.factory(p, "cpu", torch.float64)
    with pytest.raises(NotImplementedError, match="F33"):
        sim.load_restart_snapshot()
    assert sim.restart_data is None
    fname = str(tmp_path / "RUN.column.00004")
    tio.write_column_snapshot(fname, 0.75, _hydro(ndim=2))
    (tmp_path / "RUN.restart").write_text(f"column\n{fname}\n")
    assert sim.load_restart_snapshot() == 0.75
    assert len(sim.restart_data["m"]) == 60
