"""Named scenario presets (the counterpart of ``pypic_tpu/presets.py``).

Ported so far, with the same defaults:

* ``landau_damping`` — pypic.py:846-855 ("landau-damping best params")
* ``two_stream``     — pypic.py:822-832 (commented two-stream block)
* ``bump_on_tail``   — pypic.py:834-843 (bump-on-tail block)
* ``explicit_landau`` — pypic.py:667-677 (gen-3 explicit landau block)
* ``sheath_dd``      — PIC_L_DD.py:316-341 (bounded two-species sheath
  with absorbing walls; BASELINE configs[2]'s physics)
* ``pic_iead``       — pygcpic.py:1120-1200 (magnetized D + B sheath with
  IEAD collection; BASELINE configs[3])
* ``pic_iead_gc``    — pic_iead with the guiding-center pusher (BASELINE
  configs[3]'s "guiding-center magnetized PIC")
* ``pic_bca_aps``    — pygcpic.py:1307-1344 (H plasma against a B wall:
  ionization, capped-source re-activation, the BCA escape and wall-impact
  rows for ``engines.bca_driver``)
* ``dirichlet_neumann_test`` — pygcpic.py:1968-2093 (unmagnetized D-N
  sheath fed by the capped wall-flux source)

* ``domain_implicit`` — BASELINE configs[4]: the Landau workload
  domain-decomposed over the slab mesh (``parallel.domain_implicit``)
* ``domain_explicit`` — the explicit cycle on the same workload
  (``parallel.domain``)
* ``pic_iead_dd``    — pic_iead slab-sharded over the ranks
  (``parallel.domain_magnetized``)

``PRESETS`` maps their names to the functions above, in the JAX
package's order, and ``get`` makes one by name, as in the JAX package.

Every builder takes ``n`` and ``seed`` overrides, and ``device`` for the
state's tensors: the current CUDA device unless it says otherwise (pass
``device='cpu'`` without a card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np

from .constants import (E_CHARGE, EPSILON_0, EV_TO_K, K_BOLTZMANN,
                        M_ELECTRON, M_PROTON)
from .grid import GridSpec
from . import initialize
from .engines import explicit, implicit, magnetized, sheath


@dataclasses.dataclass
class Preset:
    name: str
    engine: Any  # engine module (has make_step)
    config: Any
    state: Any
    meta: Dict[str, Any]
    # engines whose make_step needs more than the config (the domain
    # engines also take the slab mesh) provide a closure
    step_builder: Any = None

    def make_step(self):
        if self.step_builder is not None:
            return self.step_builder()
        return self.engine.make_step(self.config)


def _debye(te_kelvin: float, density: float) -> float:
    return float(
        np.sqrt(K_BOLTZMANN * te_kelvin * EPSILON_0 / E_CHARGE**2 / density)
    )


def landau_damping(n: int = 1_000_000, ng: int = 200, seed: int = 1,
                   device=None, **kw) -> Preset:
    """pypic.py:846-855: density 1e5, perturbation 0.8, Kp 1, dt 1e-5,
    Te 100*11600 K, Ti 0.1*11600 K, L = 22 LD; implicit engine with
    tol 1e-3 / maxiter 20 (pypic.py:859-860)."""
    density, te, ti = 1e5, 100.0 * EV_TO_K, 0.1 * EV_TO_K
    length = 22.0 * _debye(te, density)
    grid = GridSpec(ng, length, "periodic")
    x, v, params = initialize.initialize_periodic(
        "landau-damping", n, density, 1, 0.8, grid, te, ti, seed=seed
    )
    cfg = implicit.ImplicitConfig(
        grid, 1e-5, params.p2c, tol=kw.get("tol", 1e-3),
        maxiter=kw.get("maxiter", 20),
    )
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=device)
    return Preset("landau_damping", implicit, cfg, st,
                  dict(params=params, system="landau-damping"))


def two_stream(n: int = 1_000_000, ng: int = 50, seed: int = 1,
               device=None, **kw) -> Preset:
    """pypic.py:822-832: density 1e10, perturbation 0.2, dt 0.5e-8,
    Ti = Te = 0.1*11600 K, L = 15 LD."""
    density, te, ti = 1e10, 0.1 * EV_TO_K, 0.1 * EV_TO_K
    length = 15.0 * _debye(te, density)
    grid = GridSpec(ng, length, "periodic")
    x, v, params = initialize.initialize_periodic(
        "two-stream", n, density, 1, 0.2, grid, te, ti, seed=seed
    )
    cfg = implicit.ImplicitConfig(
        grid, 0.5e-8, params.p2c, tol=kw.get("tol", 1e-3),
        maxiter=kw.get("maxiter", 20),
    )
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=device)
    return Preset("two_stream", implicit, cfg, st,
                  dict(params=params, system="two-stream"))


def bump_on_tail(n: int = 1_000_000, ng: int = 50, seed: int = 1,
                 device=None, **kw) -> Preset:
    """pypic.py:834-843: density 1e5, perturbation 0.1, dt 1e-5,
    Ti = Te = 0.1*11600 K, L = 30 LD."""
    density, te, ti = 1e5, 0.1 * EV_TO_K, 0.1 * EV_TO_K
    length = 30.0 * _debye(te, density)
    grid = GridSpec(ng, length, "periodic")
    x, v, params = initialize.initialize_periodic(
        "bump-on-tail", n, density, 1, 0.1, grid, te, ti, seed=seed
    )
    cfg = implicit.ImplicitConfig(
        grid, 1e-5, params.p2c, tol=kw.get("tol", 1e-3),
        maxiter=kw.get("maxiter", 20),
    )
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=device)
    return Preset("bump_on_tail", implicit, cfg, st,
                  dict(params=params, system="bump-on-tail"))


def explicit_landau(n: int = 100_000, ng: int = 100, seed: int = 1,
                    device=None) -> Preset:
    """pypic.py:667-677 (gen-3 explicit landau block): density 1e10,
    perturbation 0.05, Kp 2, dt 1e-8, dx 0.04, Ti = Te = 1*11600 K."""
    density, te, ti = 1e10, 1.0 * EV_TO_K, 1.0 * EV_TO_K
    dx = 0.04
    grid = GridSpec(ng, ng * dx, "periodic")
    x, v, params = initialize.initialize_periodic(
        "landau-damping", n, density, 2, 0.05, grid, te, ti, seed=seed
    )
    cfg = explicit.ExplicitConfig(grid, 1e-8, params.p2c)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=device)
    return Preset("explicit_landau", explicit, cfg, st,
                  dict(params=params, system="landau-damping"))


def sheath_dd(n: int = 40_000, ng: int = 51, seed: int = 1, device=None,
              **kw) -> Preset:
    """PIC_L_DD.py:316-341: density 1e19, dt 1e-12, dx 1e-5,
    Ti = Te = 10*11600 K, gamma 0, tol 1e-5 / maxiter 20; the exit
    histograms on (vmax 3e6 m/s). The same numpy draws as the JAX preset."""
    density, te, ti = 1e19, 10.0 * EV_TO_K, 10.0 * EV_TO_K
    dx = 1e-5
    grid = GridSpec(ng, dx * (ng - 1), "dirichlet-dirichlet")
    d = initialize.initialize_sheath(n, density, 1.0, 0.0, grid, te, ti, seed=seed)
    p2c = grid.length * density / n
    cfg = sheath.SheathConfig(
        grid, 1e-12, p2c, kbte=K_BOLTZMANN * te, kbti=K_BOLTZMANN * ti,
        gamma=kw.get("gamma", 0.0),
        exit_hist_vmax=kw.get("exit_hist_vmax", 3e6),
    )
    st = sheath.init_state(d["x"], d["v"], d["q"], d["m"], d["species"], cfg,
                           seed=seed, device=device)
    return Preset("sheath_dd", sheath, cfg, st, dict(params=d["params"]))


def _floating_potential(te, ti, ion_mass):
    """pygcpic.py:1141."""
    return (te / EV_TO_K) * 0.5 * np.log(
        ion_mass / (2.0 * np.pi * M_ELECTRON) / (1.0 + ti / te)
    )


def pic_iead(n_per_species: int = 1000, ng: int = 600, seed: int = 1,
             device=None) -> Preset:
    """pygcpic.py:1120-1200: D+ plus B 1+..5+ (densities 1e20 and
    [1e11, 1e12, 1e12, 1e11, 1e13]), B = 2 T at 86 deg, dt 1e-10,
    Ti = Te = 10*11600 K, L = 300 LD, Boltzmann D-D walls, IEAD collection,
    always-source re-activation. The same numpy draws as the JAX preset,
    so the initial state is the JAX one's."""
    density = 1e20
    densities_boron = [1e11, 1e12, 1e12, 1e11, 1e13]
    te = ti = 10.0 * EV_TO_K
    length = 300.0 * _debye(te, density)
    grid = GridSpec(ng, length, "dirichlet-dirichlet")
    dt = 1e-10
    p2c = density * length / n_per_species
    p2cs_b = [d * length / n_per_species for d in densities_boron]
    alpha = 86.0 * np.pi / 180.0
    b = (2.0 * np.cos(alpha), 2.0 * np.sin(alpha), 0.0)

    rng = np.random.default_rng(seed)
    groups = [(2.0 * M_PROTON, 1.0, p2c, 0)] + [
        (10.81 * M_PROTON, float(cs), p2cs_b[cs - 1], 1) for cs in range(1, 6)
    ]
    n = n_per_species * len(groups)
    x = rng.uniform(0.0, length, n)
    m = np.concatenate([np.full(n_per_species, g[0]) for g in groups])
    cs = np.concatenate([np.full(n_per_species, g[1]) for g in groups])
    p2c_arr = np.concatenate([np.full(n_per_species, g[2]) for g in groups])
    sp = np.concatenate(
        [np.full(n_per_species, g[3], np.int32) for g in groups]
    )
    vth = np.sqrt(K_BOLTZMANN * ti / m)
    v = rng.normal(size=(n, 3)) * vth[:, None]

    phi_f = _floating_potential(te, ti, 2.0 * M_PROTON)
    src = magnetized.SourceSpec(
        mass=M_PROTON, charge_state=1.0, p2c=p2c, species_idx=0, ti=ti
    )
    cfg = magnetized.MagnetizedConfig(
        grid, dt, te, b=b, species_z=(1, 5), reactivate="source", source=src,
        iead_energy_max=4.0 * phi_f,
    )
    st = magnetized.init_state(x, v, m, cs, p2c_arr, sp, cfg, seed=seed,
                               device=device)
    return Preset("pic_iead", magnetized, cfg, st,
                  dict(floating_potential=phi_f,
                       bca_incident=((2.0, 1), (10.81, 5)),
                       species_labels=("D", "B")))


def pic_iead_gc(n_per_species: int = 1000, ng: int = 600, seed: int = 1,
                device=None) -> Preset:
    """pic_iead with ``pusher='gc'``: the charged particles integrate as
    guiding centers (GC RK4 in the step, 6D <-> GC transforms at
    initialization, re-activation and wall impact). The state is rebuilt
    through init_state from the pic_iead state's own values, as the JAX
    preset rebuilds it, so the initial states are the JAX one's."""
    pre = pic_iead(n_per_species=n_per_species, ng=ng, seed=seed,
                   device="cpu")
    cfg = dataclasses.replace(pre.config, pusher="gc")
    st0 = pre.state
    st = magnetized.init_state(
        st0.p.numpy() * cfg.grid.dx, st0.v.numpy(), st0.m.numpy(),
        st0.charge_state.numpy(), st0.p2c.numpy(), st0.species_idx.numpy(),
        cfg, seed=seed, device=device)
    return Preset("pic_iead_gc", magnetized, cfg, st, dict(pre.meta))


def pic_bca_aps(ppc: int = 200, seed: int = 1, capacity_factor: float = 1.5,
                device=None) -> Preset:
    """pygcpic.py:1307-1344: an H plasma against a B wall, density 1e19,
    3 nodes a Debye length over 200 (ng = 600, n = 600 ppc), dt 8e-11,
    Ti 10 eV and Te 50 eV, B = 2 T at 86 degrees, smooth_rho on,
    ionization on, 'capped-source' re-activation holding the ionized H
    population at source_n = n (pygcpic.py:1543-1549), the mid-domain
    escape of wall-born particles (pygcpic.py:1529-1541), wall-impact rows
    (1,024 a step) and capacity_factor times n slots, the headroom for
    the surface model's products (``engines.bca_driver.run_bca``). The
    same numpy draws as the JAX preset, so the initial state is the JAX
    one's."""
    density = 1e19
    ti, te = 10.0 * EV_TO_K, 50.0 * EV_TO_K
    ld = _debye(te, density)
    num_ld, ng_per_ld = 200, 3
    length = num_ld * ld
    ng = ng_per_ld * num_ld
    grid = GridSpec(ng, length, "dirichlet-dirichlet")
    dt = 8e-11
    n = ng * ppc
    p2c = density * length / n
    alpha = 86.0 * np.pi / 180.0
    b = (2.0 * np.cos(alpha), 2.0 * np.sin(alpha), 0.0)

    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, length, n)
    vth = np.sqrt(K_BOLTZMANN * ti / M_PROTON)
    v = rng.normal(size=(n, 3)) * vth
    src = magnetized.SourceSpec(
        mass=M_PROTON, charge_state=1.0, p2c=p2c, species_idx=0, ti=ti
    )
    cfg = magnetized.MagnetizedConfig(
        grid, dt, te, b=b, species_z=(1, 5), smooth_rho=True,
        ionization=True, reactivate="capped-source", source=src, source_n=n,
        iead_energy_max=300.0, iead_bins=(40, 30),  # pygcpic.py:1422-1423
        impact_buffer_size=1024, bca_escape=True,
    )
    st = magnetized.init_state(
        x, v, M_PROTON, 1.0, p2c, 0, cfg, seed=seed,
        capacity=int(n * capacity_factor), device=device,
    )
    return Preset("pic_bca_aps", magnetized, cfg, st,
                  dict(source_n=n, wall_z=5, source_z=1))


def dirichlet_neumann_test(n: int = 50_000, ng: int = 800, seed: int = 1,
                           device=None) -> Preset:
    """pygcpic.py:1968-2021: density 1e19, dt 2e-10, Ti = Te = 10*11600 K,
    L = 400 LD, unmagnetized, flux source capped at 100/step with
    gamma 0.5 / vx_pert -3 (pygcpic.py:2008, 2019). The same numpy draws
    as the JAX preset, so the initial state is the JAX one's."""
    density = 1e19
    te = ti = 10.0 * EV_TO_K
    length = 400.0 * _debye(te, density)
    grid = GridSpec(ng, length, "dirichlet-neumann")
    dt = 2e-10
    p2c = density * length / n
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, length, n)
    vth = np.sqrt(K_BOLTZMANN * ti / M_PROTON)
    v = rng.normal(0.0, vth, (n, 3))
    v[:, 0] = -np.abs(v[:, 0])  # pygcpic.py:1999-2000
    src = magnetized.SourceSpec(
        mass=M_PROTON, charge_state=1.0, p2c=p2c, species_idx=0, ti=ti
    )
    cfg = magnetized.MagnetizedConfig(
        grid, dt, te, b=(0.0, 0.0, 0.0), species_z=(1,),
        reactivate="flux", source=src, flux_limit=100,
        flux_gamma=0.5, flux_vx_pert=-3.0,
    )
    st = magnetized.init_state(x, v, M_PROTON, 1.0, p2c, 0, cfg, seed=seed,
                               device=device)
    return Preset("dirichlet_neumann_test", magnetized, cfg, st, {})


def _domain_load(n, ng, seed, device, mesh):
    """The canonical Landau workload of the domain presets and the slab
    mesh (``make_mesh(device)`` unless given): (grid, x, v, params,
    mesh, sigma_cells)."""
    from .parallel import make_mesh

    mesh = mesh if mesh is not None else make_mesh(device=device)
    density, te, ti = 1e5, 100.0 * EV_TO_K, 0.1 * EV_TO_K
    length = 22.0 * _debye(te, density)
    grid = GridSpec(ng, length, "periodic")
    x, v, params = initialize.initialize_periodic(
        "landau-damping", n, density, 1, 0.8, grid, te, ti, seed=seed
    )
    sigma_cells = float(np.asarray(v).std()) * 1e-5 / grid.dx
    return grid, x, v, params, mesh, sigma_cells


def domain_implicit(n: int = 1_000_000, ng: int = 200, seed: int = 1,
                    shards: int | None = None, replicas: int | None = None,
                    device=None, mesh=None, **kw) -> Preset:
    """BASELINE configs[4]: the Landau workload (pypic.py:846-855)
    domain-decomposed over the slab mesh, as ``pypic_tpu.presets``
    builds it: the halo covers an 8-sigma Maxwellian excursion a step
    (k of them under ``migrate_every`` k: the superstep carries the
    excursions of k micro-steps), migrate_cap = max(4096, 4 k n / ng),
    extrapolated Picard init, tol 1e-9 and maxiter 50 unless ``kw`` says
    otherwise. With ``migrate_every`` k > 1 the step is
    ``make_superstep(cfg, mesh, k)`` and ``meta['steps_per_call']`` is k:
    one call advances k steps and stacks a (k,) axis on every metric. ``shards`` defaults to
    the world size over ``replicas`` (one slab a rank without replicas);
    ``mesh`` to ``make_mesh(device)``, or with ``replicas`` > 1 to
    ``make_mesh2(shards, replicas, device)`` (slabs x data-parallel
    replicas). The state is this rank's."""
    from .parallel import domain_implicit as di
    from .parallel.mesh import Mesh2, make_mesh2

    k_mig = int(kw.get("migrate_every", 1))
    r = int(replicas) if replicas else 1
    root = mesh.world if isinstance(mesh, Mesh2) else mesh
    grid, x, v, params, root, sigma_cells = _domain_load(n, ng, seed,
                                                         device, root)
    n_dev = int(shards) if shards else max(1, root.world // r)
    if r > 1 and not isinstance(mesh, Mesh2):
        mesh = make_mesh2(n_dev, r, device=root.device)
    elif mesh is None:
        mesh = root
    cfg = di.DomainImplicitConfig(
        grid, 1e-5, params.p2c, num_shards=n_dev,
        tol=kw.get("tol", 1e-9), maxiter=kw.get("maxiter", 50),
        halo=min(ng // n_dev - 3,
                 max(4, k_mig * int(np.ceil(8.0 * sigma_cells)))),
        picard_init="extrapolate",
        migrate_cap=max(4096, 4 * k_mig * (n // ng)),
        dp_axis_name="dp" if r > 1 else None, num_replicas=r,
    )
    st = di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, mesh)
    return Preset("domain_implicit", di, cfg, st,
                  dict(params=params, system="landau-damping", mesh=mesh,
                       steps_per_call=k_mig),
                  step_builder=lambda: (di.make_superstep(cfg, mesh, k_mig)
                                        if k_mig > 1
                                        else di.make_step(cfg, mesh)))


def domain_explicit(n: int = 1_000_000, ng: int = 200, seed: int = 1,
                    shards: int | None = None, device=None, mesh=None,
                    **kw) -> Preset:
    """The explicit leapfrog cycle (PIC_L.py:762-768) domain-decomposed
    over the slab mesh on ``domain_implicit``'s workload, as
    ``pypic_tpu.presets`` builds it: migrate_cap = max(4096, 4 n / ng),
    the replicated solve unless ``field_solve='distributed'``; halo 0,
    or with ``carried_rho='on'`` one covering an 8-sigma excursion a step
    (it deposits the pushed positions). ``migrate_every`` k > 1 builds the
    superstep with a halo covering k such excursions, migrate_cap =
    max(4096, 4 k n / ng) and ``meta['steps_per_call']`` k."""
    from .parallel import domain as dom

    k_mig = int(kw.get("migrate_every", 1))
    grid, x, v, params, mesh, sigma_cells = _domain_load(n, ng, seed,
                                                         device, mesh)
    n_dev = int(shards) if shards else mesh.world
    carried = kw.get("carried_rho", "off")
    halo = (0 if k_mig == 1 else
            min(ng // n_dev - 1,
                max(4, k_mig * int(np.ceil(8.0 * sigma_cells)))))
    if carried == "on" and k_mig == 1:
        # carried deposits the pushed positions: the halo covers one step
        halo = min(ng // n_dev - 1, max(4, int(np.ceil(8.0 * sigma_cells))))
    cfg = dom.DomainConfig(
        grid, 1e-5, params.p2c, num_shards=n_dev, halo=halo,
        migrate_cap=max(4096, 4 * k_mig * (n // ng)),
        field_solve=kw.get("field_solve", "replicated"),
        carried_rho=carried,
    )
    st = dom.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, mesh)
    return Preset("domain_explicit", dom, cfg, st,
                  dict(params=params, system="landau-damping", mesh=mesh,
                       steps_per_call=k_mig),
                  step_builder=lambda: (dom.make_superstep(cfg, mesh, k_mig)
                                        if k_mig > 1
                                        else dom.make_step(cfg, mesh)))


def pic_iead_dd(n_per_species: int = 1000, ng: int = 600, seed: int = 1,
                shards: int | None = None, replicas: int | None = None,
                device=None, mesh=None, **kw) -> Preset:
    """pic_iead domain-decomposed over the ranks
    (``parallel.domain_magnetized``), as ``pypic_tpu.presets`` builds it:
    slab-sharded deposits and a Newton-Boltzmann solve that stays
    slab-sharded through every iteration, walls on the end ranks,
    rank-keyed re-activation (react_batch = max(512, n / 64)) with owner
    migration (migrate_cap = max(1024, n / 16)), halo 2, unless ``kw``
    says otherwise (other keys are ignored, as in JAX). ``shards``
    defaults to the world size over ``replicas``; ``mesh`` to
    ``make_mesh(device)``, or with ``replicas`` > 1 to
    ``make_mesh2(shards, replicas, device)``. The load is pic_iead's (the
    same numpy draws); the state is this rank's."""
    from .parallel import domain_magnetized as dmag, make_mesh
    from .parallel.mesh import Mesh2, make_mesh2

    pre = pic_iead(n_per_species=n_per_species, ng=ng, seed=seed,
                   device="cpu")
    c1 = pre.config
    r = int(replicas) if replicas else 1
    root = mesh.world if isinstance(mesh, Mesh2) else mesh
    root = root if root is not None else make_mesh(device=device)
    n_dev = int(shards) if shards else max(1, root.world // r)
    if r > 1 and not isinstance(mesh, Mesh2):
        mesh = make_mesh2(n_dev, r, device=root.device)
    elif mesh is None:
        mesh = root
    n_tot = pre.state.p.shape[0]
    cfg = dmag.DomainMagnetizedConfig(
        grid=c1.grid, dt=c1.dt, te=c1.te, b=c1.b, species_z=c1.species_z,
        num_shards=n_dev, ionization=c1.ionization, reactivate="source",
        source=c1.source,
        react_batch=kw.get("react_batch", max(512, n_tot // 64)),
        iead_energy_max=c1.iead_energy_max,
        newton_tol=c1.newton_tol, newton_maxiter=c1.newton_maxiter,
        halo=kw.get("halo", 2),
        migrate_cap=kw.get("migrate_cap", max(1024, n_tot // 16)),
        dp_axis_name="dp" if r > 1 else None, num_replicas=r,
    )
    st0 = pre.state
    st = dmag.init_state(
        st0.p.numpy() * c1.grid.dx, st0.v.numpy(), st0.m.numpy(),
        st0.charge_state.numpy(), st0.p2c.numpy(), st0.species_idx.numpy(),
        cfg, mesh, seed=seed, device=root.device)
    return Preset("pic_iead_dd", dmag, cfg, st, dict(pre.meta, mesh=mesh),
                  step_builder=lambda: dmag.make_step(cfg, mesh))


PRESETS: Dict[str, Callable[..., Preset]] = {
    "landau_damping": landau_damping,
    "two_stream": two_stream,
    "bump_on_tail": bump_on_tail,
    "explicit_landau": explicit_landau,
    "sheath_dd": sheath_dd,
    "pic_iead": pic_iead,
    "pic_iead_gc": pic_iead_gc,
    "pic_bca_aps": pic_bca_aps,
    "dirichlet_neumann_test": dirichlet_neumann_test,
    "domain_implicit": domain_implicit,
    "domain_explicit": domain_explicit,
    "pic_iead_dd": pic_iead_dd,
}


def get(name: str, **kwargs) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name](**kwargs)
