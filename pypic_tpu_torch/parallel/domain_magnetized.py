"""Domain-decomposed magnetized Boltzmann-electron sheath engine (the
counterpart of ``pypic_tpu/parallel/domain_magnetized.py``), on
``torch.distributed``.

The gen-4 pic_iead cycle (pygcpic.py:1200-1294, ``engines.magnetized``)
slab-sharded over a chain of ranks:

* the ion charge and number densities deposit onto extended slabs (the
  ``deposit`` kernel) and fold to their owners along the chain; the
  adaptive Boltzmann reference-density update (pygcpic.py:889-904) sums
  its integrals over the slabs (the trapezoid's end weights live on the
  end ranks);
* the Newton-Boltzmann solve stays slab-sharded through every iteration:
  the residual takes one-node halos from the chain exchange and each
  Newton step is the substructured chain solve
  (``distributed_poisson.make_distributed_tridiag_chain``: one
  ``tridiag3_chain`` launch for the rank's local system, six scalars a
  rank all-gathered, the (2S, 2S) interface solved on every rank). The
  residual, summed over the slabs, is read on the host once an
  iteration: it is the loop's exit, the same on every rank;
* the Dirichlet walls live on the end ranks (zero halos at the chain's
  ends); the wall-impact IEAD histograms (the ``deposit`` kernel through
  ``ops.cic.histogram_add``) are summed over every rank onto a replicated
  histogram;
* MCC ionization runs on each rank at the number density gathered (the
  ``gather`` kernel) at the new positions, on a Philox stream tagged by
  the rank's (slab, replica) index: rank 0 draws what one device draws;
* re-activation is rank-keyed from a replicated table of ``react_batch``
  draws (``sources.sample_source_batch``, the ``source_batch`` kernel,
  with the single-device engine's key, step and counters, so the table is
  the same on every rank and a one-rank run draws the single-device
  port's table): an inactive slot's global rank is the exclusive prefix
  of the ranks' inactive counts plus its local rank. Re-activated slots
  take GLOBAL positions and migrate to their owners with the step's other
  boundary crossers (``domain.migrate`` on the chain); deactivated slots
  wait mid-slab.

``solver='replicated'`` all-gathers the densities and runs the one-launch
Newton kernel ``cuda_newton.boltzmann_dirichlet`` (its plain version on
the CPU), then keeps the rank's slab: JAX's equivalence anchor.

Slabs x replicas (``num_replicas`` R > 1 with ``dp_axis_name``, the rank's
``Mesh2`` from ``mesh.make_mesh2``): rank s R + r holds replica r of slab
s, the columns r::R of the slab's rows; the slab deposits and the
ledgers are summed over the slab's replicas, so every replica of a slab
solves the same densities, bit for bit, and runs the same Newton
iterations; migration rides each replica's own chain of slabs with its
round count summed over the whole mesh; the re-activation rank is global
over (slab, replica).

What JAX refuses under slab sharding the port refuses the same way: the
config has no guiding-center pusher, impact buffer or ``bca_escape``
field, and D-N walls raise JAX's ValueError.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import devices, sources
from ..constants import E_CHARGE, EPSILON_0, EV_TO_K, K_BOLTZMANN, M_ELECTRON
from ..engines.magnetized import (SourceSpec, boltzmann_n0_update,
                                  iead_update, mirror_gather_position)
from ..grid import DIRICHLET_DIRICHLET, GridSpec
from ..ops import cuda_newton, cuda_rng
from ..ops.cic import deposit, gather
from ..ops.ionization import attempt_ionization, coefficient_table, rate_matrix
from ..ops.poisson import _EXP_CLAMP, _safe_exp
from ..push import boris_push_dt
from ..utils import compact_rows
from .distributed_poisson import make_distributed_tridiag_chain
from .domain import distribute_by_slab, halo_extend, halo_fold, migrate
from .domain_implicit import _meshes, replica_columns

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class DomainMagnetizedConfig:
    """Same fields, defaults and validation as
    ``pypic_tpu.parallel.domain_magnetized.DomainMagnetizedConfig``; see
    its comments for what each option means."""

    grid: GridSpec  # 'dirichlet-dirichlet'; ng must divide by num_shards
    dt: float
    te: float  # electron temperature [K]
    b: Tuple[float, float, float]  # magnetic field [T]
    species_z: Tuple[int, ...]
    num_shards: int
    smooth_rho: bool = False
    newton_tol: float = 1e-9  # pygcpic.py:1022
    newton_maxiter: int = 1000
    ionization: bool = False
    max_charge_state: int = 3
    reactivate: str = "none"  # 'source' | 'capped-source' | 'flux' | 'none'
    source: Optional[SourceSpec] = None
    source_n: int = 0
    react_batch: int = 4096
    react_timing: str = "reference"
    flux_limit: int = 0
    flux_gamma: float = 0.0
    flux_vx_pert: float = 0.0
    iead_bins: Tuple[int, int] = (40, 40)
    iead_energy_max: float = 0.0  # [eV]; 0 disables IEAD accumulation
    iead_angle_max: float = 90.0
    eta_in_volts: bool = False
    gather_weights: str = "reference"
    deposit_method: str = "auto"
    halo: int = 2  # max intra-step excursion, cells
    migrate_cap: int = 4096
    axis_name: str = "slabs"
    solver: str = "distributed"
    dp_axis_name: str | None = None
    num_replicas: int = 1

    def __post_init__(self):
        for f in ("dt", "te", "newton_tol", "flux_gamma", "flux_vx_pert",
                  "iead_energy_max", "iead_angle_max"):
            object.__setattr__(self, f, float(getattr(self, f)))
        for f in ("num_shards", "newton_maxiter", "max_charge_state",
                  "source_n", "react_batch", "flux_limit", "halo",
                  "migrate_cap"):
            object.__setattr__(self, f, int(getattr(self, f)))
        object.__setattr__(self, "b", tuple(float(v) for v in self.b))
        object.__setattr__(
            self, "species_z", tuple(int(z) for z in self.species_z))
        if self.grid.bc != DIRICHLET_DIRICHLET:
            raise ValueError(
                "the slab-sharded magnetized engine supports "
                "'dirichlet-dirichlet' walls only (the D-N Neumann row's "
                "rank-1 term has no distributed solve)"
            )
        if self.grid.ng % self.num_shards:
            raise ValueError(
                f"ng={self.grid.ng} not divisible by {self.num_shards} shards"
            )
        if self.halo + 3 > self.cells_per_shard:
            raise ValueError(
                f"halo={self.halo} too large for {self.cells_per_shard}-cell "
                "slabs (need halo + 3 <= cells_per_shard)"
            )
        if self.reactivate not in ("none", "source", "capped-source", "flux"):
            raise ValueError(f"unknown reactivate {self.reactivate!r}")
        if self.reactivate != "none" and self.react_batch <= 0:
            raise ValueError(
                "slab-sharded re-activation needs react_batch > 0 "
                "(rank-keyed draws from a replicated table)"
            )
        if self.react_timing not in ("reference", "immediate"):
            raise ValueError(f"unknown react_timing {self.react_timing!r}")
        if self.solver not in ("distributed", "replicated"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.gather_weights not in ("reference", "cic"):
            raise ValueError(f"unknown gather_weights {self.gather_weights!r}")
        object.__setattr__(self, "num_replicas", int(self.num_replicas))
        if (self.num_replicas > 1) != (self.dp_axis_name is not None):
            raise ValueError(
                "num_replicas > 1 requires dp_axis_name (and vice versa)")

    @property
    def cells_per_shard(self) -> int:
        return self.grid.ng // self.num_shards


@dataclasses.dataclass
class DomainMagnetizedState:
    """One rank's particles and its slabs of phi, JAX's fields (``interop``
    joins the ranks into JAX's global arrays). ``rng`` is the Philox key,
    two 32-bit words on the host (the draws of step s use counter step s,
    so the key never changes); ``step_host`` is ``step`` on the host."""

    p: torch.Tensor  # (capacity,) GLOBAL grid coordinates
    y: torch.Tensor  # (capacity,) [m]
    z: torch.Tensor
    vx: torch.Tensor  # (capacity,) [m/s]
    vy: torch.Tensor
    vz: torch.Tensor
    m: torch.Tensor
    charge_state: torch.Tensor
    p2c: torch.Tensor
    species_idx: torch.Tensor  # int32
    t: torch.Tensor
    active: torch.Tensor  # int32 {1, 0}
    at_wall: torch.Tensor  # int32
    from_wall: torch.Tensor  # int32
    filled: torch.Tensor  # bool slot occupancy
    phi: torch.Tensor  # (c,) this rank's slab
    phi_prev: torch.Tensor  # (c,) (Newton warm start)
    n0: torch.Tensor  # () the same on every rank
    p_old: torch.Tensor  # ()
    added: torch.Tensor  # ()
    rng: Tuple[int, int]  # Philox key words
    iead: torch.Tensor  # (S, ne, na) the same on every rank
    step: torch.Tensor  # () int32
    step_host: Optional[int] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.step_host is None:
            self.step_host = int(self.step.item())
        self.rng = tuple(int(k) & _MASK32 for k in self.rng)

    def replace(self, **changes) -> "DomainMagnetizedState":
        if "step" in changes:
            changes.setdefault("step_host", None)
        return dataclasses.replace(self, **changes)


class StepMetrics(NamedTuple):
    n0: torch.Tensor
    phi_max: torch.Tensor
    newton_iters: torch.Tensor
    newton_residual: torch.Tensor
    n_active: torch.Tensor
    n_hit_wall: torch.Tensor
    n_ionized: torch.Tensor
    n_reactivated: torch.Tensor
    added: torch.Tensor
    rho: torch.Tensor  # (ng,) diagnostic, the same on every rank
    phi: torch.Tensor  # (ng,) diagnostic
    n_migrated: torch.Tensor
    n_dropped: torch.Tensor


# the migrated per-particle fields, in migrate's order (p first)
_MIGRATED = ("p", "y", "z", "vx", "vy", "vz", "m", "charge_state", "p2c",
             "species_idx", "t", "active", "at_wall", "from_wall")
_INT_FIELDS = ("species_idx", "active", "at_wall", "from_wall")


def init_state(x, v3, m, charge_state, p2c, species_idx,
               cfg: DomainMagnetizedConfig, mesh, seed: int = 0,
               capacity_factor: float = 1.5,
               device=None) -> DomainMagnetizedState:
    """This rank's state from the whole load (host arrays, positions x in
    meters; every rank is handed the same), as JAX's init_state lays it
    out: the slab's rows, and with replicas the replica's columns r::R
    of them (JAX's (S, R, cap_r) layout). ``mesh``: the rank's
    ``SlabMesh``, or its ``Mesh2`` with replicas. ``device`` defaults to
    the mesh's."""
    m2 = _meshes(cfg, mesh)
    slabs = m2.slabs
    device = devices.resolve(device if device is not None else slabs.device)
    grid = cfg.grid
    x = np.asarray(x)
    v3 = np.asarray(v3, np.float32)
    zeros = np.zeros(x.size, np.float32)
    fields = [(x / grid.dx).astype(np.float32), zeros, zeros,
              v3[:, 0], v3[:, 1], v3[:, 2], np.asarray(m, np.float32),
              np.asarray(charge_state, np.float32),
              np.asarray(p2c, np.float32), np.asarray(species_idx, np.int32),
              zeros]
    blocks, filled, _ = distribute_by_slab(
        [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in fields],
        torch.from_numpy(x).to(device), cfg, capacity_factor,
        shards=[slabs.rank])
    if cfg.num_replicas > 1:
        r = m2.replicas.rank
        blocks = [replica_columns(b, r, cfg.num_replicas) for b in blocks]
        filled = replica_columns(filled, r, cfg.num_replicas)
    blocks = [b[0] for b in blocks]
    filled = filled[0]
    n = filled.shape[0]
    c = cfg.cells_per_shard
    ne, na = cfg.iead_bins

    def zeros_t(shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    seed = int(seed)
    return DomainMagnetizedState(
        p=blocks[0], y=blocks[1], z=blocks[2], vx=blocks[3], vy=blocks[4],
        vz=blocks[5], m=blocks[6], charge_state=blocks[7], p2c=blocks[8],
        species_idx=blocks[9], t=blocks[10],
        active=filled.to(torch.int32),
        at_wall=zeros_t((n,), torch.int32),
        from_wall=zeros_t((n,), torch.int32), filled=filled,
        phi=zeros_t((c,)), phi_prev=zeros_t((c,)),
        n0=zeros_t(()), p_old=zeros_t(()), added=zeros_t(()),
        rng=((seed >> 32) & _MASK32, seed & _MASK32),
        iead=zeros_t((len(cfg.species_z), ne, na)),
        step=zeros_t((), torch.int32), step_host=0)


def _neighbours(f, slabs):
    """(f_(i-1), f_(i+1)) of a (c,) slab field from the chain's one-node
    halos (zeros at its ends: the walls)."""
    left, right = slabs.ring_exchange(f[-1:], f[:1], periodic=False)
    return torch.cat([left, f[:-1]]), torch.cat([f[1:], right])


def _make_distributed_newton(cfg: DomainMagnetizedConfig, slabs):
    """The slab-sharded Newton-Boltzmann D-D solve of this rank
    (``ops.poisson.solve_boltzmann_dirichlet``'s semantics,
    pygcpic.py:1005-1053): the residual on one-node chain halos, each step
    the substructured chain solve. ``solve(rho_own, n0, phi0_own) ->
    (phi_own, iterations, residual)``; one host read an iteration (the
    residual summed over the slabs)."""
    ng = cfg.grid.ng
    c = cfg.cells_per_shard
    d = slabs.rank
    dev = slabs.device
    dx2 = cfg.grid.dx * cfg.grid.dx
    c1 = E_CHARGE / (K_BOLTZMANN * cfg.te)
    step_max = _EXP_CLAMP / c1
    tol = float(np.float32(cfg.newton_tol))  # compared in float32
    solve_chain = make_distributed_tridiag_chain(c, cfg.num_shards, slabs)
    gidx = d * c + torch.arange(c, device=dev)
    interior = (gidx >= 1) & (gidx <= ng - 2)
    # the global Dirichlet Laplacian's diagonals (_dirichlet_diagonals)
    dl = torch.where(gidx >= ng - 1, 0.0, 1.0).to(torch.float32)
    du = torch.where(gidx <= 0, 0.0, 1.0).to(torch.float32)
    dg = torch.where(interior, -2.0, 1.0).to(torch.float32)

    def solve(rho_own, n0, phi0_own):
        c0 = (E_CHARGE / EPSILON_0) * n0
        c2 = rho_own / EPSILON_0
        # the warm start's walls pinned to 0 (the frozen boundary rows
        # never move them)
        phi = torch.where(interior, phi0_own, 0.0)
        residual = torch.ones((), dtype=torch.float32, device=dev)
        it, r_host = 0, 1.0
        while r_host > tol and it < cfg.newton_maxiter:
            expo = _safe_exp(c1 * phi)
            down, up = _neighbours(phi, slabs)
            f = dl * down + dg * phi + du * up - dx2 * c0 * expo + dx2 * c2
            f = torch.where(interior, f, 0.0)
            ddiag = torch.where(interior, -dx2 * c0 * c1 * expo,
                                -dx2 * c0 * c1)
            dphi = solve_chain(dl, dg + ddiag, du, f)
            dphi = torch.clamp(dphi, -step_max, step_max)
            phi = phi - dphi
            residual = slabs.all_reduce_sum(torch.sum(dphi * dphi))
            it += 1
            r_host = float(residual)  # the loop's exit: one host read
        lo = torch.min(slabs.all_gather(torch.min(phi).reshape(1)))
        return (phi - lo, torch.full((), it, dtype=torch.int32, device=dev),
                residual)

    return solve


def make_step(cfg: DomainMagnetizedConfig, mesh,
              source_draws: Optional[Callable] = None,
              ion_draws: Optional[Callable] = None):
    """This rank's step: state -> (state, StepMetrics), the metrics summed
    over the ranks (the same on every rank). ``mesh``: the rank's
    ``SlabMesh``, or its ``Mesh2`` (slabs x replicas).

    ``source_draws(step, n)``, when given, replaces the re-activation
    table: {"x" [m], "vx", "vy", "vz"}, (react_batch,) tensors on the
    state's device, the same on every rank; ``ion_draws(step, n)`` the
    rank's (n,) ionization uniforms. The CPU tests pass the JAX engine's
    own draws through them; the engine's path never does."""
    m2 = _meshes(cfg, mesh)
    slabs = m2.slabs
    grid = cfg.grid
    ng, dx, dt = grid.ng, grid.dx, cfg.dt
    cells = float(grid.num_cells)
    c = cfg.cells_per_shard
    d_tot = cfg.num_shards
    d = slabs.rank
    first, last = d == 0, d == d_tot - 1
    h = cfg.halo
    hw = h + 1
    ext_n = c + 2 * hw + 1
    lo = float(np.float32(d * c))
    b32 = tuple(float(np.float32(v)) for v in cfg.b)
    te_volts = (cfg.te / EV_TO_K) if cfg.eta_in_volts else (cfg.te * EV_TO_K)
    ve = float(np.sqrt(8.0 / np.pi * K_BOLTZMANN * cfg.te / M_ELECTRON))
    rates = rate_matrix(cfg.species_z, cfg.te) if cfg.ionization else None
    newton_dist = (_make_distributed_newton(cfg, slabs)
                   if cfg.solver == "distributed" else None)
    r_tot = cfg.num_replicas
    dev_idx = d * r_tot + m2.replicas.rank  # the rank's (slab, replica)
    rank_tag = dev_idx << 16
    total = slabs.all_reduce_sum  # over the slabs (fields, replicated)
    total_all = m2.world.all_reduce_sum  # over every rank (particles)
    dpsum = m2.replicas.all_reduce_sum  # over the slab's replicas
    src = cfg.source
    coef = {}

    def clamp_loc(pl):
        return torch.clamp(pl, -float(h), float(c + h))

    def fold(ext):
        return dpsum(halo_fold(ext, c, hw, slabs, periodic=False))

    def draws(state, n):
        if source_draws is not None:
            return source_draws(state.step_host, n)
        dev = state.p.device
        if cfg.reactivate == "flux":
            return sources.sample_flux_batch(
                state.rng, state.step_host, n, grid, src.ti, src.mass,
                vx=src.vx, gamma=cfg.flux_gamma, vx_pert=cfg.flux_vx_pert,
                device=dev)
        return sources.sample_source_batch(state.rng, state.step_host, n,
                                           grid, src.ti, src.mass, vx=src.vx,
                                           device=dev)

    def ion_uniforms(state, n):
        if ion_draws is not None:
            return ion_draws(state.step_host, n)
        return cuda_rng.philox_uniforms(state.rng, state.step_host, n, 1,
                                        cuda_rng.ION_TAG | rank_tag,
                                        device=state.p.device)[0]

    def step(state: DomainMagnetizedState):
        dev = state.p.device
        step_i = state.step_host
        n = state.p.shape[0]
        filled = state.filled
        zero_i = torch.zeros((), dtype=torch.int32, device=dev)
        is_active = filled & (state.active == 1)
        p_loc = torch.where(filled, state.p - lo, 0.5)

        # deposits (pygcpic.py:841-905): rho and n on the extended slab,
        # folded to their owners, summed over the replicas
        w_rho = torch.where(
            is_active, state.charge_state * E_CHARGE * state.p2c / dx, 0.0)
        w_n = torch.where(is_active, state.p2c / dx, 0.0)
        pc = clamp_loc(p_loc) + hw
        rho, n_dens = fold(torch.stack([
            deposit(pc, w_rho, ext_n, periodic=False, method=cfg.deposit_method),
            deposit(pc, w_n, ext_n, periodic=False,
                    method=cfg.deposit_method)])).unbind(0)

        # adaptive Boltzmann reference density (pygcpic.py:889-904): the
        # trapezoid's and the particle integrals summed over the slabs
        eta = torch.exp(state.phi / te_volts)
        zero = torch.zeros((), dtype=eta.dtype, device=dev)
        sums = total(torch.stack([
            torch.sum(eta), eta[0] if first else zero,
            eta[-1] if last else zero, torch.sum(n_dens)]))
        p_new = dx * (sums[0] - 0.5 * (sums[1] + sums[2]))
        n0, p_old = boltzmann_n0_update(
            step_i, state.n0, state.p_old, state.added,
            q_new=sums[1] + sums[2], p_new=p_new, dt=dt, ve=ve,
            n_mean=sums[3] / ng)
        added = torch.zeros_like(state.added)

        if cfg.smooth_rho:
            # the bounded binomial smoother (pygcpic.py:1491) on one-node
            # halos; the global end rows keep their raw value
            down, up = _neighbours(rho, slabs)
            sm = 0.25 * down + 0.5 * rho + 0.25 * up
            if first:
                sm[0] = rho[0]
            if last:
                sm[c - 1] = rho[c - 1]
            rho = sm

        # the Newton solve from the wall-referenced warm start: the wall
        # value lives on rank 0's first node
        wall0 = total(state.phi[0] if first else zero)
        phi_warm = state.phi - wall0
        if cfg.solver == "distributed":
            phi, n_it, resid = newton_dist(rho, n0, phi_warm)
        else:
            res = cuda_newton.boltzmann_dirichlet(
                slabs.all_gather(rho), n0, cfg.te, dx, tol=cfg.newton_tol,
                maxiter=cfg.newton_maxiter, phi0=slabs.all_gather(phi_warm))
            phi = res.phi[d * c:(d + 1) * c].clone()
            n_it, resid = res.iterations, res.residual

        # E = -grad phi (pygcpic.py:907-937): centered on one-node halos,
        # one-sided first-order rows at the global walls
        down, up = _neighbours(phi, slabs)
        e_own = -(up - down) * (0.5 / dx)
        if first:
            e_own[0] = -(up[0] - phi[0]) / dx
        if last:
            e_own[c - 1] = -(phi[c - 1] - down[c - 1]) / dx

        # gather and Boris push in slab coordinates
        e_ext = halo_extend(e_own, hw, slabs, periodic=False)
        pg = clamp_loc(p_loc) + hw
        if cfg.gather_weights == "reference":
            # the reference's swapped intra-cell weights (the integer + hw
            # shift keeps the intra-cell fraction)
            pg = mirror_gather_position(pg, float(ext_n - 1))
        e_p = torch.where(is_active, gather(e_ext, pg, periodic=False), 0.0)
        yz = torch.stack([state.y, state.z], dim=-1)
        v3 = torch.stack([state.vx, state.vy, state.vz], dim=-1)
        x1, yz1, v1 = boris_push_dt(p_loc * dx, yz, v3, e_p, b32,
                                    state.charge_state, state.m, dt)
        p1 = torch.where(is_active, x1 / dx, p_loc)
        y1 = torch.where(is_active, yz1[:, 0], state.y)
        z1 = torch.where(is_active, yz1[:, 1], state.z)
        vx1 = torch.where(is_active, v1[:, 0], state.vx)
        vy1 = torch.where(is_active, v1[:, 1], state.vy)
        vz1 = torch.where(is_active, v1[:, 2], state.vz)
        t1 = torch.where(is_active, state.t + dt, state.t)

        # the Dirichlet walls in global coordinates (pygcpic.py:668-689)
        p1_g = p1 + lo
        hit = is_active & ((p1_g < 0.0) | (p1_g > cells))
        active = torch.where(hit, 0, state.active)
        at_wall = torch.where(hit, 1, state.at_wall)

        iead = state.iead
        if cfg.iead_energy_max > 0.0:
            iead = iead_update(iead, state.species_idx, state.m, vx1, vy1,
                               vz1, hit, bins=cfg.iead_bins,
                               energy_max=cfg.iead_energy_max,
                               angle_max=cfg.iead_angle_max,
                               reduce=total_all, method=cfg.deposit_method)

        # MCC ionization (pygcpic.py:1510-1513), at the number density
        # gathered at the new positions
        n_ionized = zero_i
        charge_state = state.charge_state
        if cfg.ionization:
            still_active = filled & (active == 1)
            n_loc = torch.where(
                still_active,
                gather(halo_extend(n_dens, hw, slabs, periodic=False),
                       clamp_loc(p1) + hw, periodic=False), 0.0)
            key = (n_loc.dtype, dev)
            if key not in coef:
                coef[key] = coefficient_table(rates, dx, dt, n_loc.dtype, dev)
            charge_state, ionized, added_ion = attempt_ionization(
                n_loc, charge_state, state.species_idx, state.p2c, coef[key],
                still_active, ion_uniforms(state, n),
                max_charge_state=cfg.max_charge_state)
            added = added + added_ion
            n_ionized = torch.sum(ionized, dtype=torch.int32)

        # rank-keyed re-activation from the replicated table
        n_react = zero_i
        m_arr, p2c_arr, sp_arr = state.m, state.p2c, state.species_idx
        fw = state.from_wall
        if cfg.reactivate != "none":
            nb = cfg.react_batch
            # 'reference' timing: the slots inactive at step START
            inactive = filled & ((state.active != 1)
                                 if cfg.react_timing == "reference"
                                 else (active != 1))
            rank = compact_rows(inactive)
            counts = m2.world.all_gather(
                torch.sum(inactive, dtype=torch.int32).reshape(1))
            # the global rank over the (slab, replica) ranks
            rank = rank + torch.sum(counts[:dev_idx]).to(torch.int32)
            batch = draws(state, nb)
            bvx = batch["vx"]
            if cfg.reactivate == "flux":
                bvx = -torch.abs(bvx)  # pygcpic.py:2059
                take = inactive & (rank < min(cfg.flux_limit, nb))
            elif cfg.reactivate == "capped-source":
                n_src_active = total_all(torch.sum(
                    filled & (active == 1)
                    & (state.species_idx == src.species_idx)
                    & (charge_state > 0), dtype=torch.int32))
                deficit = torch.clamp(cfg.source_n - n_src_active, min=0)
                take = inactive & (rank < torch.clamp(deficit, max=nb))
            else:
                take = inactive & (rank < nb)
            idx = torch.clamp(rank, 0, nb - 1).to(torch.int64)
            bx_g = batch["x"][idx] / dx  # GLOBAL grid coordinates
            # re-activated slots take global positions (the migration
            # below routes them); the others that did not move wait
            # mid-slab
            p1_g = torch.where(take, bx_g, torch.where(is_active | hit, p1_g,
                                                       lo + 0.5))
            y1 = torch.where(take, 0.0, y1)
            z1 = torch.where(take, 0.0, z1)
            vx1 = torch.where(take, bvx[idx], vx1)
            vy1 = torch.where(take, batch["vy"][idx], vy1)
            vz1 = torch.where(take, batch["vz"][idx], vz1)
            m_arr = torch.where(take, src.mass, m_arr)
            charge_state = torch.where(take, src.charge_state, charge_state)
            p2c_arr = torch.where(take, src.p2c, p2c_arr)
            sp_arr = torch.where(take, src.species_idx, sp_arr)
            # step * dt rounded as the JAX engine's float32 product
            t1 = torch.where(take, float(np.float32(step_i) * np.float32(dt)),
                             t1)
            active = torch.where(take, 1, active)
            at_wall = torch.where(take, 0, at_wall)
            fw = torch.where(take, 0, fw)
            n_react = torch.sum(take, dtype=torch.int32)
            added = added + (2.0 * src.p2c) * torch.sum(take.to(added.dtype))
        else:
            p1_g = torch.where(is_active | hit, p1_g, lo + 0.5)

        # inactive slots must not migrate: pinned mid-slab
        p_mig = torch.where(filled & (active == 1), p1_g, lo + 0.5)
        moved = [p_mig, y1, z1, vx1, vy1, vz1, m_arr, charge_state, p2c_arr,
                 sp_arr, t1, active, at_wall, fw]
        out, filled, n_mig, n_drop = migrate(
            [f.to(torch.float32) for f in moved], filled, d, ng=ng,
            cells_per_shard=c, num_shards=d_tot, cap=cfg.migrate_cap,
            mesh=slabs, count_mesh=m2.world, periodic=False)
        new = dict(zip(_MIGRATED, out))
        for name in _INT_FIELDS:
            new[name] = new[name].to(torch.int32)

        ints = total_all(torch.stack([
            torch.sum(filled & (new["active"] == 1), dtype=torch.int32),
            torch.sum(hit, dtype=torch.int32), n_ionized, n_react]))
        added = total_all(added)
        rho_full = slabs.all_gather(rho)
        phi_full = slabs.all_gather(phi)
        metrics = StepMetrics(
            n0=n0, phi_max=torch.max(phi_full), newton_iters=n_it,
            newton_residual=resid, n_active=ints[0], n_hit_wall=ints[1],
            n_ionized=ints[2], n_reactivated=ints[3], added=added,
            rho=rho_full, phi=phi_full, n_migrated=n_mig, n_dropped=n_drop)
        new_state = state.replace(
            **new, filled=filled, phi=phi, phi_prev=state.phi, n0=n0,
            p_old=p_old, added=added, iead=iead, step=state.step + 1,
            step_host=step_i + 1)
        return new_state, metrics

    return step
