"""Port parity: the RadWS functions and radiative feedback against
gandalf_tpu's (float64, CPU, the plain versions of K27-K30).

Both packages compute with the same table: a JAX OpacityTable (the
synthetic ideal table, or one read from a 9-column file this file
writes, whose kappa, kappa_p, mu and gamma vary and one of whose energy
rows is not monotone) carried across by convert.opacity_table_from_jax.
The inputs are numpy-seeded and reach beyond both ends of the density
and temperature grids, with du/dt large enough to clamp the equilibrium
at T_min and at the table's top.  Tolerance 1e-12: both sides evaluate
the same formulas in the same order, and every lookup must land on the
same index (the table values read there are then equal).  The implicit
heating rate is held to 1e-12 of the size of its own terms instead
(|du/dt| plus the radiative term's T^4 and T_amb^4 parts, at the
temperature JAX's bisection reached): near the ambient temperature it is
4 sigma (T^4 - T_amb^4), a difference that keeps 5 to 6 fewer digits
than its terms, so the last bits of XLA's and torch's x ** y show there
at up to 1e-9 of the rate itself."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gandalf_tpu.ops import eos as jeos
from gandalf_tpu.ops import radiative_fb as jfb
from gandalf_tpu.ops import radws as jrw
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu_torch.convert import opacity_table_from_jax
from gandalf_tpu_torch.ops import eos as teos
from gandalf_tpu_torch.ops import radiative_fb as tfb
from gandalf_tpu_torch.ops import radws as trw
from gandalf_tpu_torch.params import Parameters

torch.set_num_threads(1)

TOL = 1e-12
N = 3000


def write_table(path, nd=6, nt=40):
    """A table in the reference's 9-column format (density-major, header
    "ndens ntemp fcol"): mu from 2.35 to 0.6 and gamma from 5/3 to 1.1
    with T, u = T/((gamma-1) mu) with a ripple, kappa and kappa_p power
    laws with a break, and density row 2's energies 20-23 reversed."""
    dens = np.logspace(-6.0, 1.0, nd)
    temp = np.logspace(0.5, 4.5, nt)
    with open(path, "w") as f:
        f.write("# test opacity table\n")
        f.write(f"{nd} {nt} 0.7\n")
        for i, d in enumerate(dens):
            lt = np.log10(temp)
            mu = 1.475 - 0.875 * np.tanh((lt - 3.3) / 0.4)
            gam = np.where(lt < 2.5, 5.0 / 3.0 - 0.27 * (lt / 2.5) ** 2,
                           1.4 - 0.3 * (lt - 2.5) / 2.0)
            u = temp / ((gam - 1.0) * mu) * (1.0 + 0.05 * np.sin(3.0 * lt))
            if i == 2:
                u[20:24] = u[20:24][::-1].copy()
            kap = d ** 0.3 * np.where(lt < 2.0, 10.0 ** (2.0 * (lt - 2.0)),
                                      10.0 ** (-1.5 * (lt - 2.0)))
            for T, uu, m, g, k in zip(*(x.tolist() for x in
                                        (temp, u, mu, gam, kap))):
                f.write(f"{float(d)!r} {T!r} {uu!r} {m!r} {k!r} {k!r} "
                        f"{2.0 * k!r} {g!r} {g!r}\n")
    return str(path)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """{name: (JAX table, port table)}: the ideal table and a file's."""
    path = write_table(tmp_path_factory.mktemp("radws") / "eos.test.dat")
    out = {}
    for name, jt in (("ideal", jrw.make_ideal_table(temp_ambient=10.0)),
                     ("file", jrw.read_opacity_table(path,
                                                     temp_ambient=8.0))):
        out[name] = (jt, opacity_table_from_jax(jt))
    return out


def _inputs(jt, seed=4):
    """rho a decade beyond each end of the density grid, u from below the
    lowest to above the highest tabulated energy, du/dt N(0, 1) u with 3%
    at -1e6 and 3% at +1e22 (the two clamps), gpot in [-1, 5], T_amb in
    [0.5, 1e4] and dt in [1e-6, 1]."""
    rng = np.random.default_rng(seed)
    ld = np.asarray(jt.log_dens)
    e = np.asarray(jt.energy)
    rho = 10.0 ** rng.uniform(ld[0] - 1.0, ld[-1] + 1.0, N)
    u = 10.0 ** rng.uniform(np.log10(e.min()) - 0.5,
                            np.log10(e.max()) + 0.5, N)
    dudt = rng.standard_normal(N) * u
    pick = rng.random(N)
    dudt[pick < 0.03] = -1e6
    dudt[pick > 0.97] = 1e22
    return {"rho": rho, "u": u, "dudt": dudt,
            "gpot": rng.uniform(-1.0, 5.0, N),
            "tamb": 10.0 ** rng.uniform(np.log10(0.5), 4.0, N),
            "dt": 10.0 ** rng.uniform(-6.0, 0.0, N)}


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.tensor(x, dtype=torch.float64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    d = np.where(got == want, 0.0, np.abs(got - want))
    return float(np.max(np.where(want != 0, d / np.abs(np.where(
        want != 0, want, 1.0)), d)))


def test_reader_reads_the_reference_format(tables, tmp_path):
    """read_opacity_table on the file: every array and scalar as the
    JAX package reads it, also with the Lombardi column factor."""
    jt, tt = tables["file"]
    for k in trw.OpacityTable.ARRAYS:
        assert np.array_equal(getattr(tt, k).numpy(),
                              np.asarray(getattr(jt, k))), k
    for k in ("fcol2", "rad_const", "temp_min", "temp_ambient"):
        assert getattr(tt, k) == float(getattr(jt, k)), k
    path = write_table(tmp_path / "t.dat", nd=3, nt=5)
    mine = trw.read_opacity_table(path, lombardi=True, u_scale=2.0,
                                  kappa_scale=3.0)
    theirs = jrw.read_opacity_table(path, lombardi=True, u_scale=2.0,
                                    kappa_scale=3.0)
    assert mine.fcol2 == float(theirs.fcol2) == 0.7 * 0.7
    for k in trw.OpacityTable.ARRAYS:
        assert np.array_equal(getattr(mine, k).numpy(),
                              np.asarray(getattr(theirs, k))), k
    # the reversed entries make the module table's row 2 non-monotone
    assert np.any(np.diff(tt.energy[2].numpy()) < 0.0)


@pytest.mark.parametrize("name", ["ideal", "file"])
def test_lookups_match_jax(tables, name):
    """idens_of, itemp_of, temp_from_u and u_of_temp: the same indices
    and values, on the file table's non-monotone row too."""
    jt, tt = tables[name]
    x = _inputs(jt)
    temp = x["tamb"] * 3.0
    for fn, args in (("idens_of", (x["rho"],)), ("itemp_of", (temp,))):
        got = getattr(trw, fn)(tt, *map(_t, args)).numpy()
        want = np.asarray(getattr(jrw, fn)(jt, *map(_j, args)))
        assert np.array_equal(got, want), fn
    for fn, args in (("temp_from_u", (x["rho"], x["u"])),
                     ("u_of_temp", (x["rho"], temp))):
        got = getattr(trw, fn)(tt, *map(_t, args)).numpy()
        want = np.asarray(getattr(jrw, fn)(jt, *map(_j, args)))
        assert _rel(got, want) <= TOL, fn
    if name == "file":
        # u within the reversed entries of row 2 take their counted index
        row = tt.energy[2]
        rho2 = torch.full((4,), 10.0 ** float(tt.log_dens[2]),
                          dtype=torch.float64)
        u2 = row[20:24] * (1.0 + 1e-9)
        got = trw.temp_from_u(tt, rho2, u2).numpy()
        want = np.asarray(jrw.temp_from_u(jt, _j(rho2.numpy()),
                                          _j(u2.numpy())))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["ideal", "file"])
def test_radws_eos_matches_jax(tables, name):
    """K27's plain version (P, c) against the JAX Radws EOS's
    thermal_update on (N,) inputs and on a dense (cells, K) shape whose
    empty slots carry rho 1e-30 and u 0, as the grid pass's do; the port's
    Radws.thermal_update gives the same."""
    jt, tt = tables[name]
    x = _inputs(jt)
    jeos_ = jeos.Radws(gamma=5.0 / 3.0, table=jt)
    teos_ = teos.Radws(gamma=5.0 / 3.0, table=tt)
    empty = np.arange(N) % 5 == 4
    rho_d = np.where(empty, 1e-30, x["rho"]).reshape(60, 50)
    u_d = np.where(empty, 0.0, x["u"]).reshape(60, 50)
    for rho, u in ((x["rho"], x["u"]), (rho_d, u_d)):
        _, p_j, c_j = jeos_.thermal_update(_j(rho), _j(u))
        p_t, c_t = trw.radws_eos_plain(tt, _t(rho), _t(u))
        assert p_t.shape == rho.shape
        assert _rel(p_t.numpy(), p_j) <= TOL
        assert _rel(c_t.numpy(), c_j) <= TOL
        u_e, p_e, c_e = teos_.thermal_update(_t(rho), _t(u))
        assert torch.equal(u_e, _t(u))
        assert torch.equal(p_e, p_t) and torch.equal(c_e, c_t)


@pytest.mark.parametrize("name", ["ideal", "file"])
@pytest.mark.parametrize("field", [False, True])
def test_energy_find_equi_matches_jax(tables, name, field):
    """K28's plain version (col2 from max(gpot, 0) fused in) against
    radws_col2 + energy_find_equi with the table's T_amb and with a
    per-particle field: ueq (a table entry, so equal entries mean equal
    indices) and dt_therm, with both clamps taken, as the index's branch
    shows."""
    jt, tt = tables[name]
    x = _inputs(jt)
    col2 = jrw.radws_col2(jt, _j(x["rho"]), jnp.maximum(_j(x["gpot"]), 0.0))
    amb = x["tamb"] if field else None
    ueq_j, dt_j = jrw.energy_find_equi(jt, _j(x["rho"]), _j(x["u"]),
                                       _j(x["dudt"]), col2,
                                       temp_amb=None if amb is None
                                       else _j(amb))
    ueq_t, dt_t, idx = trw.energy_find_equi(
        tt, _t(x["rho"]), _t(x["u"]), _t(x["dudt"]), _t(x["gpot"]),
        None if amb is None else _t(amb), index=True)
    assert np.array_equal(ueq_t.numpy(), np.asarray(ueq_j))
    # the index reads ueq's entry; its branch takes both clamps
    nt = tt.log_temp.shape[0]
    idx = idx.long()
    assert torch.equal(tt.energy.reshape(-1)[idx // 3 // nt], ueq_t)
    assert set((idx % 3).tolist()) == {0, 1, 2}
    assert _rel(dt_t.numpy(), dt_j) <= TOL
    top = float(tt.energy.max())
    assert (ueq_t == top).any() or name == "file"
    assert (dt_t.numpy() == 1e30).any()


def _jax_implicit(monkeypatch, jt, rho, u, dudt, col2, dt, amb):
    """JAX's radws_implicit_heating, and the temperatures and indices its
    g(T) read, recorded through itemp_of: T_min's, the top's and the
    root's (the first two calls and the last)."""
    seen = []
    itemp = jrw.itemp_of

    def record(table, temp):
        it = itemp(table, temp)
        seen.append((np.asarray(temp), np.asarray(it)))
        return it

    monkeypatch.setattr(jrw, "itemp_of", record)
    heat = np.asarray(jrw.radws_implicit_heating(
        jt, rho, u, dudt, col2, dt, temp_amb=amb))
    monkeypatch.undo()
    assert len(seen) == 2 + 40 + 1
    return heat, seen[0], seen[1], seen[-1]


@pytest.mark.parametrize("name", ["ideal", "file"])
@pytest.mark.parametrize("per_particle", [False, True])
def test_implicit_heating_matches_jax(tables, name, per_particle,
                                      monkeypatch):
    """K29's plain version (col2 fused in) against radws_col2 +
    radws_implicit_heating with a scalar dt and the table's T_amb, and
    with per-particle dt and T_amb: the index equal to the one JAX's
    reads imply (its branch from g at the edges, the temperature index
    at the edge or the root), and each rate within 1e-12 of the size of
    its own terms there, |du/dt| + 4 a (T^4 + T_amb^4) / (col2 kappa +
    1/kappa_p) (see the module's docstring); both edge branches taken."""
    jt, tt = tables[name]
    x = _inputs(jt)
    rho, u, dudt = _j(x["rho"]), _j(x["u"]), _j(x["dudt"])
    col2 = jrw.radws_col2(jt, rho, jnp.maximum(_j(x["gpot"]), 0.0))
    dt = x["dt"] if per_particle else 1e-3
    amb = x["tamb"] if per_particle else None
    h_j, (t_lo, it_lo), (t_hi, it_hi), (t_root, it_root) = _jax_implicit(
        monkeypatch, jt, rho, u, dudt, col2, _j(dt),
        None if amb is None else _j(amb))
    h_t, idx = trw.radws_implicit_heating(
        tt, _t(x["rho"]), _t(x["u"]), _t(x["dudt"]), _t(x["gpot"]),
        _t(dt), None if amb is None else _t(amb), index=True)
    # JAX's branch from g at the edges: g(T) = u(T) - u - dt heat(T)
    idens = np.asarray(jrw.idens_of(jt, rho))
    tamb = jt.temp_ambient if amb is None else amb

    def heat_g(t, it):
        kap = np.asarray(jt.kappa)[idens, it]
        kp = np.asarray(jt.kappap)[idens, it]
        heat = np.asarray(jrw._ebalance(jt, dudt, _j(tamb), _j(t), _j(kap),
                                        _j(kp), col2))
        u_t = t / (np.asarray(jt.mu)[idens, it]
                   * (np.asarray(jt.gamma)[idens, it] - 1.0))
        return heat, u_t - x["u"] - dt * heat, kap, kp

    h_lo, g_lo, _, _ = heat_g(t_lo, it_lo)
    _, g_hi, _, _ = heat_g(t_hi, it_hi)
    branch = np.where(g_lo >= 0.0, 1, np.where(g_hi <= 0.0, 2, 0))
    t_j = np.where(branch == 1, t_lo, np.where(branch == 2, t_hi, t_root))
    it_j = np.where(branch == 1, it_lo, np.where(branch == 2, it_hi,
                                                 it_root))
    nt = len(np.asarray(jt.log_temp))
    assert np.array_equal(idx.numpy(), (idens * nt + it_j) * 3 + branch)
    assert (branch == 1).any() and (branch == 2).any()
    _, _, kap, kp = heat_g(t_j, it_j)
    scale = np.abs(x["dudt"]) + 4.0 * float(jt.rad_const) * (
        t_j ** 4 + np.asarray(tamb) ** 4) / (np.asarray(col2) * kap
                                             + 1.0 / kp)
    err = np.abs(h_t.numpy() - h_j) / scale
    assert np.max(err) <= TOL, float(np.max(err))


def test_relaxation_and_col2_match_jax():
    """radws_energy_integration (scalar and per-particle dt, the
    dt_therm ~ 0 and x >= 40 branches) and radws_col2."""
    rng = np.random.default_rng(2)
    u0, ueq = rng.uniform(1, 100, N), rng.uniform(1, 100, N)
    dtt = 10.0 ** rng.uniform(-35, 3, N)
    dtt[:10] = 1e30
    for dt in (1e-2, rng.uniform(0, 1, N)):
        got = trw.radws_energy_integration(_t(u0), _t(ueq), _t(dtt), _t(dt))
        want = jrw.radws_energy_integration(_j(u0), _j(ueq), _j(dtt), _j(dt))
        assert _rel(got.numpy(), want) <= TOL
    jt = jrw.make_ideal_table()
    tt = opacity_table_from_jax(jt)
    rho, g = rng.uniform(0, 2, N), rng.uniform(0, 3, N)
    assert np.array_equal(trw.radws_col2(tt, _t(rho), _t(g)).numpy(),
                          np.asarray(jrw.radws_col2(jt, _j(rho), _j(g))))


def test_factory_takes_the_ideal_table_when_the_file_is_missing(tmp_path,
                                                                capsys):
    """eos_factory's radws branch: a warning and make_ideal_table(gamma,
    mu_bar, temp_ambient) without the file, as the JAX package; the file
    when it exists."""
    path = write_table(tmp_path / "eos.dat")
    for table_path, expect_file in ((str(tmp_path / "none.dat"), False),
                                    (path, True)):
        p = Parameters()
        for k, v in dict(gas_eos="radws", gamma_eos=1.4, mu_bar=2.35,
                         temp_ambient=20.0, radws_table=table_path).items():
            p.set(k, v)
        q = JaxParameters()
        for t in ("intparams", "floatparams", "stringparams"):
            getattr(q, t).update(getattr(p, t))
        mine, theirs = teos.eos_factory(p), jeos.eos_factory(q)
        assert isinstance(mine, teos.Radws)
        assert ("WARNING" in capsys.readouterr().out) != expect_file
        for k in trw.OpacityTable.ARRAYS:
            assert np.array_equal(getattr(mine.table, k).numpy(),
                                  np.asarray(getattr(theirs.table, k))), k
        assert mine.table.temp_ambient == 20.0


# ---------------------------------------------------------------------------
# radiative feedback
# ---------------------------------------------------------------------------

MJ = 9.546e-4


def _slots(seed=6, ns=12):
    """Slots of every mass class (planet 5 M_J, brown dwarf 40 M_J, star
    0.3 msun, and masses on the class edges 13 and 80 M_J), mdot
    log-uniform, two empty; particles in the unit cube, one on slot 0."""
    rng = np.random.default_rng(seed)
    m = np.array([5 * MJ, 40 * MJ, 0.3, 13 * MJ, 80 * MJ, 0.3] * 2)[:ns]
    mdot = 10.0 ** rng.uniform(-4, 0, ns)
    active = np.ones(ns, bool)
    active[-2:] = False
    m[-2:] = mdot[-2:] = 0.0
    rs = rng.random((ns, 3))
    r = rng.random((500, 3))
    r[0] = rs[0]
    return r, rs, m, mdot, np.full(ns, 0.03), active


CFG = dict(rad_const=2.0, temp_inf=5.0, f_acc=0.75, lsun=1.0, msun=1.0,
           mjup=MJ, r_planet=0.002, r_bdwarf=0.005, r_star=0.01)


def test_sink_luminosity_matches_jax():
    """sink_luminosity over all three classes and their edges."""
    _, _, m, mdot, rad, _ = _slots()
    L_t, r_t = tfb.sink_luminosity(tfb.SinkHeatingConfig(**CFG), _t(m),
                                   _t(mdot), _t(rad))
    L_j, r_j = jfb.sink_luminosity(jfb.SinkHeatingConfig(**CFG), _j(m),
                                   _j(mdot), _j(rad))
    assert np.array_equal(r_t.numpy(), np.asarray(r_j))
    assert sorted(set(r_t.numpy())) == [0.002, 0.005, 0.01]
    assert _rel(L_t.numpy(), L_j) <= TOL


@pytest.mark.parametrize("case", ["sinks", "disc_1", "disc_2",
                                  "sink_heating_off", "ambient_off"])
def test_ambient_temperature_matches_jax(case):
    """combined_ambient_temperature (K30's plain version on the CPU)
    against the JAX package's with disc heating off and about one or two
    central slots, with sink_heating off (every slot masked out of both
    sums, as _radws_equilibrium passes it) and with ambient_heating off
    (T_inf = 0); JAX's ambient_temperature against the combined
    temperature without a disc, and disc_ambient_t4."""
    r, rs, m, mdot, rad, active = _slots()
    cfg = dict(CFG, temp_inf=0.0 if case == "ambient_off" else 5.0)
    nc = {"disc_1": 1, "disc_2": 2, "sink_heating_off": 1}.get(case)
    if case == "sink_heating_off":
        active = np.zeros_like(active)
    disc = None if nc is None else dict(temp_au=250.0, temp_q=0.75,
                                        rsmooth=0.01, n_central=nc)
    got = tfb.combined_ambient_temperature(
        tfb.SinkHeatingConfig(**cfg),
        None if disc is None else tfb.DiscHeatingConfig(**disc), _t(r),
        _t(rs), _t(m), _t(mdot), _t(rad), torch.tensor(active))
    want = jfb.combined_ambient_temperature(
        jfb.SinkHeatingConfig(**cfg),
        None if disc is None else jfb.DiscHeatingConfig(**disc), _j(r),
        _j(rs), _j(m), _j(mdot), _j(rad), jnp.asarray(active))
    assert _rel(got.numpy(), want) <= TOL
    if case == "sink_heating_off":
        assert np.all(got.numpy() == 5.0)
    args_t = (_t(r), _t(rs), _t(m), _t(mdot), _t(rad), torch.tensor(active))
    args_j = (_j(r), _j(rs), _j(m), _j(mdot), _j(rad), jnp.asarray(active))
    a_t = tfb.combined_ambient_temperature(tfb.SinkHeatingConfig(**cfg),
                                           None, *args_t)
    a_j = jfb.ambient_temperature(jfb.SinkHeatingConfig(**cfg), *args_j)
    assert _rel(a_t.numpy(), a_j) <= TOL
    assert torch.equal(tfb.ambient_temperature(tfb.SinkHeatingConfig(**cfg),
                                               *args_t), a_t)
    if disc is not None:
        d_t = tfb.disc_ambient_t4(tfb.DiscHeatingConfig(**disc), _t(r),
                                  _t(rs), torch.tensor(active))
        d_j = jfb.disc_ambient_t4(jfb.DiscHeatingConfig(**disc), _j(r),
                                  _j(rs), jnp.asarray(active))
        assert _rel(d_t.numpy(), d_j) <= TOL
