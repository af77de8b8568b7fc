"""Domain-decomposed bounded sheath engine, absorbing walls on the end
ranks (the counterpart of ``pypic_tpu/parallel/domain_sheath.py``), on
``torch.distributed``: BASELINE configs[4]'s "PIC_L_DD sharded across a
mesh" workload.

The gen-2 Dirichlet-Dirichlet sheath cycle (PIC_L_DD.py:316-644,
``engines.sheath``) on the slab machinery of ``parallel.domain``:

* the bounded grid is slab-sharded over a chain (no wrap link): the halo
  exchanges are ``SlabMesh.ring_exchange(periodic=False)``, so the end
  ranks receive zero halos, the walls;
* the wall surface-charge currents ``j[0] += dx q p2c / dt`` per
  left-absorbed particle (PIC_L_DD.py:55-63) are charge sums over the
  ranks applied on rank 0 and rank S-1 only, as is the edge fold
  ``j[0] += j[1]; j[-1] += j[-2]`` (PIC_L_DD.py:65-66);
* the Ampere advance ``E1 = E0 + (dt/eps0)(<jh> - jh)`` is local up to the
  summed mean, so E and j stay slab-sharded through the Picard loop;
* absorbed particles draw a fresh uniform position over the GLOBAL
  domain (PIC_L_DD.py:429-450) and migrate (multi-hop, ``domain.migrate``
  on the chain) to the owning slab before the loop; a second migration
  after the push returns the boundary-crossing survivors to their owners.
  Absorbed slots wait mid-slab for the next step's re-injection.

Each rank's state holds its own particles, (capacity,) arrays with global
grid positions and the slot occupancy ``filled``, and its (c,) slabs of
E, j and the previous E. The Picard loop is composed, as JAX's slab
engine is: the ``gather`` kernel on the halo-extended field, a
tensor-op Crank-Nicolson push and wall check, and each pass's two
currents (half step and end of step) by ``cuda_cic.deposit_det`` on the
extended slab, summed in a fixed order as the single-device engine's
(its floor exit reads the residual at round-off level; above 1,816
extended nodes a slab, int64 fixed-point sums, up to
``cuda_cic.LARGE_MAX_NG``); the exit histograms through
``ops.cic.histogram_add`` (the ``deposit`` kernel).
The loop's exit is JAX's (r > tol, r > tol_floor eps ||es||, k <
maxiter, r and ||es|| summed over the ranks): one host read a pass, as
``engines.sheath``, and every rank reads the same numbers, so every rank
runs the same passes. Anderson(1) mixing sums its inner products over the
ranks. ``migrate`` reads its counts once a round.

The thermostat and re-injection draw from the ``sheath_reinject`` Philox
kernel at counters (row, step, j, rank << 16): rank 0 of one slab draws
what the single-device engine draws for its rows. JAX folds the shard
index into threefry keys, which the port cannot reproduce; tests replay
JAX's draws through ``make_step(reinject_draws=...)``.

``picard_accel`` 'anderson2' mixes over two histories, its inner
products summed over the slabs as Anderson(1)'s. ``deposit_method`` picks
the exit histograms' reduction (``ops.cic.histogram_add``); the currents
sum in a fixed order whatever it says.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import devices
from ..constants import EPSILON_0
from ..engines.sheath import ACTIVE, LOST_LEFT, LOST_RIGHT, picard_keep
from ..grid import GridSpec
from ..ops import cuda_cic, cuda_rng
from ..ops.accel import anderson2_mix, anderson_mix, mix_init
from ..ops.cic import DEPOSIT_METHODS, gather, histogram_add
from ..ops.fd import integrate_neg_trapz
from .domain import (_check_mesh, distribute_by_slab, halo_extend,
                     halo_fold, migrate)
from .mesh import SlabMesh

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class DomainSheathConfig:
    """Same fields, defaults and validation as
    ``pypic_tpu.parallel.domain_sheath.DomainSheathConfig``; see its
    comments for what each option means."""

    grid: GridSpec  # bc='dirichlet-dirichlet'; ng must divide by num_shards
    dt: float
    p2c: float
    kbte: float
    kbti: float
    num_shards: int
    tol: float = 1e-5  # PIC_L_DD.py:317
    tol_floor: float = 0.5
    maxiter: int = 20  # PIC_L_DD.py:318
    gamma: float = 0.0  # thermostat probability (PIC_L_DD.py:331)
    halo: int = 2  # max intra-step excursion, cells
    migrate_cap: int = 4096
    axis_name: str = "slabs"
    deposit_method: str = "auto"
    exit_hist_bins: int = 64
    exit_hist_vmax: float = 0.0
    record_exit_after_step: int = 2000  # PIC_L_DD.py:497
    picard_init: str = "field"
    picard_accel: str = "none"

    def __post_init__(self):
        for f in ("dt", "p2c", "kbte", "kbti", "tol", "tol_floor", "gamma",
                  "exit_hist_vmax"):
            object.__setattr__(self, f, float(getattr(self, f)))
        for f in ("maxiter", "halo", "migrate_cap", "num_shards",
                  "exit_hist_bins", "record_exit_after_step"):
            object.__setattr__(self, f, int(getattr(self, f)))
        if self.grid.ng % self.num_shards:
            raise ValueError(
                f"ng={self.grid.ng} not divisible by {self.num_shards} shards"
            )
        if self.halo + 3 > self.cells_per_shard:
            raise ValueError(
                f"halo={self.halo} too large for {self.cells_per_shard}-cell "
                "slabs (need halo + 3 <= cells_per_shard)"
            )
        if self.picard_init not in ("field", "extrapolate"):
            raise ValueError(f"unknown picard_init {self.picard_init!r}")
        if self.picard_accel not in ("none", "anderson", "anderson2"):
            raise ValueError(f"unknown picard_accel {self.picard_accel!r}")

    @property
    def cells_per_shard(self) -> int:
        return self.grid.ng // self.num_shards


@dataclasses.dataclass
class DomainSheathState:
    """One rank's particles and its slabs of the fields, JAX's fields
    (``interop`` joins the ranks into JAX's global arrays). ``rng`` is the
    Philox key, two 32-bit words on the host; the draws of step s use
    counters (row, s, j, rank << 16), so the key never changes.
    ``step_host`` is ``step`` on the host (read once when a state is built
    without it)."""

    p: torch.Tensor  # (capacity,) global grid coordinates
    v: torch.Tensor  # (capacity, 3) [m/s]
    q: torch.Tensor  # (capacity,) [C]
    m: torch.Tensor  # (capacity,) [kg]
    species: torch.Tensor  # (capacity,) int32 (1 e-, 2 ion)
    active: torch.Tensor  # (capacity,) int32 in {1, 0, -1}
    filled: torch.Tensor  # (capacity,) bool slot occupancy
    e: torch.Tensor  # (c,) [V/m], this rank's slab
    j: torch.Tensor  # (c,) [A/m^2]
    e_prev: torch.Tensor  # (c,) previous-step field
    rng: Tuple[int, int]  # Philox key words
    exit_hist: torch.Tensor  # (2, bins), the same on every rank
    step: torch.Tensor  # () int32
    step_host: Optional[int] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.step_host is None:
            self.step_host = int(self.step.item())
        self.rng = tuple(int(k) & _MASK32 for k in self.rng)

    def replace(self, **changes) -> "DomainSheathState":
        if "step" in changes:
            changes.setdefault("step_host", None)
        return dataclasses.replace(self, **changes)


class StepMetrics(NamedTuple):
    field_energy: torch.Tensor
    kinetic_energy: torch.Tensor
    current_bias: torch.Tensor
    picard_iters: torch.Tensor
    picard_residual: torch.Tensor
    n_active: torch.Tensor
    n_lost_left: torch.Tensor
    n_lost_right: torch.Tensor
    n_migrated: torch.Tensor
    n_dropped: torch.Tensor
    n_halo_clamped: torch.Tensor  # final-iterate excursions beyond the halo
    phi: torch.Tensor  # (ng,) diagnostic, the same on every rank


def _check_ported(cfg: DomainSheathConfig) -> None:
    if cfg.deposit_method not in DEPOSIT_METHODS:
        raise ValueError(f"unknown deposit method {cfg.deposit_method!r}")


def _key(seed: int) -> Tuple[int, int]:
    """The JAX key data of ``PRNGKey(seed)`` as the Philox key words."""
    seed = int(seed)
    return ((seed >> 32) & _MASK32, seed & _MASK32)


def init_state(x, v3, q, m, species, cfg: DomainSheathConfig,
               mesh: SlabMesh, seed: int = 0, capacity_factor: float = 1.5,
               device=None) -> DomainSheathState:
    """This rank's state from the whole load (every rank is handed the
    same host arrays: x [m], v3 (n, 3) [m/s], q, m, species): its slab's
    particles, E0 = 0 (PIC_L_DD.py:385-389) and its slab of j0, one plain
    deposit of every particle on the CPU (JAX's 'scatter', the same bits
    on every rank). ``device`` defaults to the mesh's."""
    _check_ported(cfg)
    _check_mesh(cfg, mesh)
    device = devices.resolve(device if device is not None else mesh.device)
    grid = cfg.grid
    ng, c = grid.ng, cfg.cells_per_shard
    x = np.asarray(x)
    p = x / grid.dx
    w = np.asarray(q) * (cfg.p2c / grid.dx)
    p32 = torch.from_numpy(p.astype(np.float32))
    j0 = cuda_cic.deposit_plain(
        p32, torch.from_numpy((w * np.asarray(v3)[:, 0]).astype(np.float32)),
        ng, periodic=False)
    put = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(device)  # noqa: E731
    (p_o, v_o, q_o, m_o, s_o), filled, _ = distribute_by_slab(
        [p32.to(device), put(v3, np.float32), put(q, np.float32),
         put(m, np.float32), put(species, np.int32)],
        torch.from_numpy(x).to(device), cfg, capacity_factor,
        shards=[mesh.rank])
    filled = filled[0]
    own = slice(mesh.rank * c, (mesh.rank + 1) * c)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return DomainSheathState(
        p=p_o[0], v=v_o[0], q=q_o[0], m=m_o[0], species=s_o[0],
        active=torch.where(filled, ACTIVE, LOST_RIGHT).to(torch.int32),
        filled=filled, e=zeros((c,)), j=j0[own].to(device), e_prev=zeros((c,)),
        rng=_key(seed), exit_hist=zeros((2, cfg.exit_hist_bins)),
        step=torch.zeros((), dtype=torch.int32, device=device), step_host=0)


def make_step(cfg: DomainSheathConfig, mesh: SlabMesh,
              reinject_draws: Optional[Callable] = None):
    """This rank's step: state -> (state, StepMetrics), the metrics summed
    over the ranks (the same on every rank).

    ``reinject_draws(step, n)``, when given, replaces the sampler: it
    returns this rank's {"x": new positions in global grid coordinates,
    "z": three re-injection normals, and with gamma > 0 "u_therm": the
    acceptance uniforms and "z_therm": three thermostat normals}, (n,)
    tensors on the state's device (the CPU tests pass the JAX engine's
    draws); the engine's path never does."""
    _check_ported(cfg)
    _check_mesh(cfg, mesh)
    grid = cfg.grid
    ng, dx, dt = grid.ng, grid.dx, cfg.dt
    dt_dx = dt / dx
    cells = float(grid.num_cells)
    c = cfg.cells_per_shard
    d_tot = cfg.num_shards
    d = mesh.rank
    h = cfg.halo
    hw = h + 1  # CIC right node; the sheath advance has no smoother
    ext_n = c + 2 * hw + 1
    first, last = d == 0, d == d_tot - 1
    lo = float(np.float32(d * c))
    right_wall = cells - lo  # the walls in this rank's coordinates
    left_wall = 0.0 - lo
    wall = dx * cfg.p2c / dt  # the wall surface-charge current per charge
    vmax, bins = cfg.exit_hist_vmax, cfg.exit_hist_bins
    total = mesh.all_reduce_sum
    tag = d << 16  # the rank's Philox stream; rank 0 draws one device's

    def clamp_loc(pl):
        return torch.clamp(pl, -float(h), float(c + h))

    def do_migrate(fields, filled):
        return migrate(fields, filled, d, ng=ng, cells_per_shard=c,
                       num_shards=d_tot, cap=cfg.migrate_cap, mesh=mesh,
                       periodic=False)

    def reinject(state, filled, u, vy, vz):
        """Thermostat (PIC_L_DD.py:420-427) and re-injection over the
        global domain (PIC_L_DD.py:429-450): (p, u, vy, vz)."""
        m, species, act = state.m, state.species, state.active
        m_safe = torch.where(filled, m, 1.0)
        kbti = torch.full_like(m, cfg.kbti)
        kbt = torch.where(species == 1, torch.full_like(m, cfg.kbte), kbti)
        sig = torch.sqrt(kbt / m_safe)
        sigth = torch.sqrt(kbti / m_safe) if cfg.gamma > 0.0 else None
        lost = filled & (act != ACTIVE)
        if reinject_draws is not None:
            dr = reinject_draws(state.step_host, state.p.shape[0])
            hit = zt = None
            if cfg.gamma > 0.0:
                hit = filled & (act == ACTIVE) & (dr["u_therm"] < cfg.gamma)
                zt = dr["z_therm"]
            return cuda_rng.reinject_apply(state.p, u, vy, vz, lost, sig,
                                           dr["x"], dr["z"], hit, sigth, zt)
        # the kernel re-injects the rows whose status is not 1: free slots
        # pass as active and are put back after a thermostat
        act_f = torch.where(filled, act, ACTIVE).to(torch.float32)
        outs = cuda_rng.sheath_reinject(state.rng, state.step_host, state.p,
                                        u, vy, vz, act_f, sig, sigth,
                                        cells=cells, gamma=cfg.gamma, tag=tag)
        if cfg.gamma > 0.0:
            outs = tuple(torch.where(filled, o, a)
                         for o, a in zip(outs, (state.p, u, vy, vz)))
        return outs

    def mix(es, eh, k, aux):
        if cfg.picard_accel == "anderson":
            return anderson_mix(es, eh, k, aux, reduce=total)
        if cfg.picard_accel == "anderson2":
            return anderson2_mix(es, eh, k, aux, reduce=total)
        return eh, aux

    def step(state: DomainSheathState):
        dev = state.p.device
        step_i = state.step_host
        filled = state.filled
        q, m, species = state.q, state.m, state.species
        e0 = state.e
        u, vy, vz = (state.v[:, k].contiguous() for k in range(3))
        p_g, u, vy, vz = reinject(state, filled, u, vy, vz)

        # re-injected particles go to the rank owning their new position
        (p_g, u, vy, vz, q, m, sp_f), filled, mig1, drop1 = do_migrate(
            [p_g, u, vy, vz, q, m, species.to(torch.float32)], filled)
        species = sp_f.to(torch.int32)
        active = torch.where(filled, ACTIVE, LOST_RIGHT).to(torch.int32)

        p0l = torch.where(filled, p_g - lo, 0.0)
        u0 = torch.where(filled, u, 0.0)
        qm = torch.where(filled, q / torch.where(filled, m, 1.0), 0.0)
        wq = q * (cfg.p2c / dx)
        recording = vmax > 0.0 and step_i >= cfg.record_exit_after_step

        def currents(xh, uh, x1, u1, act):
            """The half-step and end-of-step currents of the active rows
            on the extended slab, folded along the chain, with the wall
            surface-charge terms and the edge fold on the end ranks
            (PIC_L_DD.py:41-67): (jh, j1)."""
            is_act = filled & (act == ACTIVE)
            w = torch.where(is_act, wq, 0.0)
            ext = torch.stack([
                cuda_cic.deposit_det(clamp_loc(xh) + hw, w * uh, ext_n,
                                     periodic=False),
                cuda_cic.deposit_det(clamp_loc(x1) + hw, w * u1, ext_n,
                                     periodic=False)])
            jj = halo_fold(ext, c, hw, mesh, periodic=False)
            lost_q = total(torch.stack([
                torch.sum(torch.where(filled & (act == LOST_LEFT), q, 0.0)),
                torch.sum(torch.where(filled & (act == LOST_RIGHT), q, 0.0))]))
            if first:
                jj[:, 0] += wall * lost_q[0] + jj[:, 1]
            if last:
                jj[:, c - 1] += -wall * lost_q[1] + jj[:, c - 2]
            return jj[0], jj[1]

        es = (e0 + 0.5 * (e0 - state.e_prev)
              if cfg.picard_init == "extrapolate" else e0)
        aux = mix_init(e0, cfg.picard_accel)
        hist = torch.zeros_like(state.exit_hist)
        r = torch.full((), math.inf, dtype=e0.dtype, device=dev)
        psl, x1, u1, e1, j1 = p0l, p0l, u0, e0, state.j
        k, going = 0, cfg.maxiter > 0
        while going:
            is_act = filled & (active == ACTIVE)
            e_ext = halo_extend(es, hw, mesh, periodic=False)
            e_p = torch.where(
                is_act, gather(e_ext, clamp_loc(psl) + hw, periodic=False), 0.0)
            accel = qm * e_p
            x1 = p0l + dt_dx * u0 + (0.5 * dt * dt_dx) * accel
            u1 = u0 + dt * accel
            x1 = torch.where(is_act, x1, 0.0)
            u1 = torch.where(is_act, u1, 0.0)
            xh = torch.where(is_act, 0.5 * (p0l + x1), 0.0)
            uh = torch.where(is_act, 0.5 * (u0 + u1), 0.0)
            # wall absorption on any of (x0, xh, x1) (PIC_L_DD.py:493-505)
            right = is_act & ((p0l >= right_wall) | (xh >= right_wall)
                              | (x1 >= right_wall))
            left = is_act & ((p0l <= left_wall) | (xh <= left_wall)
                             | (x1 <= left_wall))
            active = torch.where(right, LOST_RIGHT, active)
            active = torch.where(left, LOST_LEFT, active).to(torch.int32)
            if recording:
                vout = torch.where(right, u0, torch.where(left, -u0, 0.0))
                idx = torch.clamp(((vout + vmax) * (bins / (2.0 * vmax))
                                   ).to(torch.int32), 0, bins - 1)
                flat = torch.clamp(species - 1, 0, 1) * bins + idx
                upd = histogram_add(flat, torch.where(right | left, 1.0, 0.0),
                                    2 * bins, method=cfg.deposit_method)
                hist = hist + upd.reshape(2, bins)
            jh, j1 = currents(xh, uh, x1, u1, active)
            e1 = e0 + (dt / EPSILON_0) * (total(torch.sum(jh)) / ng - jh)
            eh = 0.5 * (e1 + e0)
            r_sq = torch.sum((es - eh) ** 2)
            es, aux = mix(es, eh, k, aux)
            sums = total(torch.stack([r_sq, torch.sum(es * es)]))
            r = torch.sqrt(sums[0])
            psl = xh
            k += 1
            going = k < cfg.maxiter
            if going:
                # the one host read of the pass: r and ||es|| together
                r_h, n_h = torch.sqrt(sums).tolist()
                going = picard_keep(cfg, r_h, n_h, torch.float32)

        is_act = filled & (active == ACTIVE)
        # survivors migrate to their owners; absorbed slots wait mid-slab
        p1 = torch.where(is_act, x1 + lo, lo + 0.5)
        v1 = [torch.where(is_act, a, 0.0) for a in (u1, vy, vz)]
        (p2, u2, vy2, vz2, q2, m2, sp2, act2), filled, mig2, drop2 = do_migrate(
            [p1, *v1, q, m, species.to(torch.float32),
             active.to(torch.float32)], filled)
        active2 = act2.to(torch.int32)

        phi = integrate_neg_trapz(mesh.all_gather(e1), dx)
        phi = phi - torch.max(phi)
        exit_hist = state.exit_hist + (total(hist) if recording else hist)
        fsum = total(torch.stack([
            torch.sum(e1 * e1),
            torch.sum(torch.where(filled, m2, 0.0) * (u2 * u2)),
            torch.sum(j1)]))
        counts = total(torch.stack([
            torch.sum(filled & (active2 == s), dtype=torch.int32)
            for s in (ACTIVE, LOST_LEFT, LOST_RIGHT)] + [torch.sum(
                is_act & ((x1 < -h) | (x1 > c + h)), dtype=torch.int32)]))
        metrics = StepMetrics(
            field_energy=0.5 * EPSILON_0 * dx * fsum[0],
            kinetic_energy=cfg.p2c * 0.5 * fsum[1],
            current_bias=fsum[2] / ng,
            picard_iters=torch.full((), k, dtype=torch.int32, device=dev),
            picard_residual=r,
            n_active=counts[0], n_lost_left=counts[1], n_lost_right=counts[2],
            n_migrated=mig1 + mig2,
            n_dropped=drop1 + drop2,
            n_halo_clamped=counts[3],
            phi=phi,
        )
        new_state = state.replace(
            p=p2, v=torch.stack([u2, vy2, vz2], dim=-1), q=q2, m=m2,
            species=sp2.to(torch.int32), active=active2, filled=filled, e=e1,
            j=j1, e_prev=e0, exit_hist=exit_hist, step=state.step + 1,
            step_host=step_i + 1)
        return new_state, metrics

    return step
