"""Bounded two-species 1d3v implicit sheath engine (the counterpart of
``pypic_tpu/engines/sheath.py``; gen-2, PIC_L_DD.py ``main_i``).

Electrons and ions between two absorbing walls ("DD" = Dirichlet-
Dirichlet, not domain decomposition). One step:

1. re-injection and thermostat at step start (PIC_L_DD.py:420-450): rows
   absorbed in the previous step take a fresh uniform position and a
   species-temperature Maxwellian velocity; with probability gamma an
   active row's three velocity components are resampled to the ion
   temperature;
2. the Picard loop (PIC_L_DD.py:458-533): bounded gather of the field
   guess, Crank-Nicolson push of the active rows (only u is accelerated),
   the wall check on (x0, xh, x1) flipping the status to LOST_RIGHT (0) or
   LOST_LEFT (-1), the current deposit with the wall surface charge and
   the edge fold, the Ampere advance E1 = E0 + (dt/eps0)(<jh> - jh), the
   residual ||es - eh||_2 and optional Anderson(1) mixing. The loop runs
   while r > tol and r > tol_floor eps ||es|| (eps of the working dtype)
   and k < maxiter;
3. the exit-velocity histograms per species from the status transitions,
   binned by the step-start u (after ``record_exit_after_step``);
4. phi = -cumulative trapezoid of E1, shifted to max 0.

Backends, as the JAX engine's, with CUDA in the place of the TPU:

* fused (``backend='fused'``, or 'auto' on a CUDA state with n >= 8192):
  each Picard pass is one ``sheath_picard`` launch (``ops/cuda_sheath``),
  and one ``sheath_finalize`` launch over the converged field gives
  (x1, u1, act1, j1);
* composed: the bounded ``gather`` kernel, a tensor-op push and wall
  check, and two ``deposit_det`` launches a pass (jh and j1) with the
  wall charge added as sums; x1, u1 and j1 come from the last iterate.

Every current and histogram on the card is summed in a fixed order (the
pass kernels, and ``cuda_cic.deposit_det`` in the place of ``deposit``):
the loop's floor exit compares a residual at round-off level, which the
float atomics' changing order would hold above the threshold (module
``ops.cuda_sheath``). Both backends run any ng up to
``cuda_cic.LARGE_MAX_NG`` on the card, in float32 and in float64: the
thread columns hold ng floats up to 1,760 nodes (the composed deposits,
1,815) and ng doubles up to 880 (907); above them the kernels sum in
fixed point, one int64 word a term in float32 and two in float64, whose
bits no order changes (csrc/sheath.cu's header, csrc/cic_common.cuh),
and the composed backend's gather reads the field from device memory
above 58,112 nodes (29,056 in float64).

The re-injection is the Philox kernel ``ops.cuda_rng.sheath_reinject``
(``rng_sampler`` 'auto' and 'pallas'), keyed by the state's two key words
at counters (row, step, j, 0): the key never changes, the step picks the
draws. ``rng_sampler='hash'`` (and 'auto' under ``axis_name``) draws the
JAX engine's counter-based uniforms and normals instead
(``sources.hash_uniforms``, ``hash_normals``: the ``hash_batch`` kernel,
four seeds a step from ``sources.step_seed``), then applies the same
masked update.

Data parallel (``cfg.axis_name`` set, ``make_step(cfg, mesh=mesh)``; see
``parallel.dataparallel``): each rank holds a block of the particles. The
current deposits, wall surface-charge terms included, are summed over the
ranks before the edge fold, on both backends; the exit histograms, the
kinetic energy and the counters are summed too. So the Picard loop
iterates on the replicated field and its one host read a pass reads the
same residual on every rank. The hash draws take the slot offset
rank x local n, so every rank draws what one device draws for its slots.

The loop's exit depends on data, so a pass reads r and ||es|| on the
host in one transfer (none after the pass that reaches maxiter); nothing
else syncs. The step number and the key live on the host in the state.

Quirks of the JAX engine kept: absorbed rows carry zero u, vy, vz (and
their x1) until re-injection; the kinetic energy uses the raw u1 before
the status masks it. A float64 state (``init_state(..., dtype=
torch.float64)``) runs on either device, through the same wrappers: the
plain versions on the CPU and the double kernels on the card, the
scalars in the state's dtype, the hash draws in it (as the JAX engine's,
which passes ``p0.dtype.type``), the Philox re-injection's draws in
float32 times the float64 sigmas (as the TPU kernel's). The TPU pass
keeps a float32 current accumulator for a float64 state, which is TPU
layout: the port's sums are float64.

``picard_accel`` 'anderson', 'anderson2' and 'andersonM' (M > 2) mix the
Picard iterate over 1, 2 or M histories (``ops.accel``; the (M, M) solve
stays on the card), on both backends. ``deposit_method`` takes JAX's
values; the engine's deposits sum in a fixed order whatever it says
(``deposit_det``, which 'scatter' and 'matmul' pick anyway): the loop's
floor exit reads the residual at round-off level.

The 'threefry' sampler raises ``NotImplementedError`` from ``init_state``
and ``make_step``, with the reason.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import devices
from ..constants import EPSILON_0
from .. import sources
from ..grid import GridSpec
from ..ops import cuda_cic, cuda_rng, cuda_sheath
from ..ops.accel import (anderson2_mix, anderson_depth, anderson_m_mix,
                         anderson_mix, mix_init)
from ..ops.cic import DEPOSIT_METHODS, gather
from ..ops.fd import integrate_neg_trapz
from ..parallel.dataparallel import ParticleAxis

ACTIVE = 1
LOST_RIGHT = 0  # absorbed at x >= L (PIC_L_DD.py:495-496)
LOST_LEFT = -1  # absorbed at x <= 0 (PIC_L_DD.py:500-501)

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SheathConfig:
    """Same fields, defaults and validation as
    ``pypic_tpu.engines.sheath.SheathConfig``; see its comments for what
    each option means. 'auto' resolves with CUDA in the place of the TPU
    (module docstring)."""

    grid: GridSpec  # bc='dirichlet-dirichlet', ng nodes, dx = L/(ng-1)
    dt: float
    p2c: float
    kbte: float  # electron kB T [J] for re-injection sampling
    kbti: float  # ion kB T [J] for re-injection + thermostat sampling
    tol: float = 1e-5  # PIC_L_DD.py:317
    tol_floor: float = 0.5
    maxiter: int = 20  # PIC_L_DD.py:318
    gamma: float = 0.0  # thermostat resampling probability (PIC_L_DD.py:331)
    deposit_method: str = "auto"
    backend: str = "auto"  # 'auto' | 'fused' | 'composed'
    exit_hist_bins: int = 64
    exit_hist_vmax: float = 0.0  # [m/s]; 0 disables recording
    record_exit_after_step: int = 2000  # PIC_L_DD.py:497
    picard_init: str = "field"  # 'field' | 'extrapolate'
    picard_accel: str = "none"  # 'none' | 'anderson' | 'anderson2' | 'andersonM'
    rng_sampler: str = "auto"  # 'auto' | 'pallas' (Philox here)
    axis_name: Optional[str] = None

    def __post_init__(self):
        for f in ("dt", "p2c", "kbte", "kbti", "tol", "tol_floor", "gamma",
                  "exit_hist_vmax"):
            object.__setattr__(self, f, float(getattr(self, f)))
        for f in ("maxiter", "exit_hist_bins", "record_exit_after_step"):
            object.__setattr__(self, f, int(getattr(self, f)))
        if self.picard_init not in ("field", "extrapolate"):
            raise ValueError(f"unknown picard_init {self.picard_init!r}")
        if self.picard_accel not in ("none", "anderson", "anderson2"):
            if anderson_depth(self.picard_accel) is None:
                raise ValueError(
                    f"unknown picard_accel {self.picard_accel!r}"
                )
        if self.rng_sampler not in ("auto", "pallas", "hash", "threefry"):
            raise ValueError(f"unknown rng_sampler {self.rng_sampler!r}")
        if self.axis_name is not None:
            if self.rng_sampler == "pallas":
                raise ValueError(
                    "rng_sampler='pallas' is not supported under "
                    "data-parallel sharding (hardware-PRNG draws are not "
                    "shard-invariant); use 'hash' or 'auto'"
                )
            if self.rng_sampler == "threefry":
                raise ValueError(
                    "data-parallel full-capacity re-injection needs "
                    "rng_sampler='hash' (slot-offset counters give "
                    "shard-invariant draws; a replicated threefry key "
                    "would draw the SAME randoms on every shard) — 'auto' "
                    "resolves to hash here"
                )


@dataclasses.dataclass
class SheathState:
    """The JAX state's fields, flat (n,) particle tensors. ``rng`` is the
    Philox key, two 32-bit words on the host (the JAX state's key data);
    the draws of step s use counters (row, s, j, 0), so the key never
    changes. ``step_host`` is ``step`` on the host (read once when a state
    is built without it), so that a step reads nothing else back."""

    p: torch.Tensor  # (n,) x in grid coordinates
    u: torch.Tensor  # (n,) x velocity (the only field-accelerated component)
    vy: torch.Tensor  # (n,)
    vz: torch.Tensor  # (n,)
    q: torch.Tensor  # (n,) charge [C]
    m: torch.Tensor  # (n,) mass [kg]
    species: torch.Tensor  # (n,) int32: 1 = electron, 2 = ion
    active: torch.Tensor  # (n,) int32 in {1, 0, -1}
    e: torch.Tensor  # (ng,) field [V/m]
    j: torch.Tensor  # (ng,) current density [A/m^2]
    e_prev: torch.Tensor  # (ng,) previous-step field
    rng: Tuple[int, int]  # Philox key words
    exit_hist: torch.Tensor  # (2, bins) outgoing-velocity histograms
    step: torch.Tensor  # () int32
    step_host: Optional[int] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.step_host is None:
            self.step_host = int(self.step.item())
        self.rng = tuple(int(k) & _MASK32 for k in self.rng)

    def replace(self, **changes) -> "SheathState":
        if "step" in changes:
            changes.setdefault("step_host", None)
        return dataclasses.replace(self, **changes)

    @property
    def v(self) -> torch.Tensor:
        """(n, 3) stacked velocity view (diagnostics and tests)."""
        return torch.stack([self.u, self.vy, self.vz], dim=-1)


class StepMetrics(NamedTuple):
    field_energy: torch.Tensor  # sum(eps0 E^2 dx / 2) (PIC_L_DD.py:548)
    kinetic_energy: torch.Tensor  # sum(m u^2 / 2) p2c, per-particle mass
    current_bias: torch.Tensor  # <j> (PIC_L_DD.py:551)
    picard_iters: torch.Tensor
    picard_residual: torch.Tensor
    n_active: torch.Tensor
    n_lost_left: torch.Tensor
    n_lost_right: torch.Tensor
    phi: torch.Tensor  # (ng,) potential from integrated E


# checkpoints of older JAX states stored the (n, 3) ``v`` leaf; split it on
# restore (checkpoint.load(migrate=...), wired up by the CLI's --resume)
CHECKPOINT_MIGRATIONS = {
    ".v": lambda a: {".u": a[:, 0], ".vy": a[:, 1], ".vz": a[:, 2]},
}


# the hash sampler's four draws a step, in the order of their seeds
HASH_STREAMS = ("therm_u", "therm_v", "reinj_x", "reinj_v")



def _check_ported(cfg: SheathConfig) -> None:
    """Raise NotImplementedError for the sampler the port does not
    reproduce, and ValueError for an unknown deposit method."""
    if cfg.deposit_method not in DEPOSIT_METHODS:
        raise ValueError(f"unknown deposit method {cfg.deposit_method!r}")
    todo = {
        "rng_sampler='threefry'": (
            cfg.rng_sampler == "threefry",
            "it draws jax.random's own streams, which the port does not "
            "reproduce; 'auto' and 'pallas' draw the Philox kernel's"),
    }
    for what, (hit, why) in todo.items():
        if hit:
            raise NotImplementedError(f"{what} is not ported yet: {why}")


def picard_keep(cfg, r: float, es_norm: float, dtype) -> bool:
    """The Picard loop's test on the host, in the working dtype's rounding:
    r > tol and r > (tol_floor eps) ||es|| (``cfg`` has ``tol`` and
    ``tol_floor``; the slab engine ``parallel.domain_sheath`` shares it)."""
    if dtype == torch.float32:
        f = np.float32
        keep = f(r) > f(cfg.tol)
        floor = f(f(cfg.tol_floor * np.finfo(np.float32).eps) * f(es_norm))
    else:
        keep = r > cfg.tol
        floor = cfg.tol_floor * float(torch.finfo(dtype).eps) * es_norm
    if cfg.tol_floor > 0.0:
        keep = keep and r > floor
    return bool(keep)


def init_state(x, v3, q, m, species, cfg: SheathConfig, seed: int = 0,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str | None = None) -> SheathState:
    """Wrap initializer output (host arrays): positions divided by dx in
    x's own precision, then cast to ``dtype``; j0 from one bounded
    deposit of the loaded particles, E0 = 0 (the reference's initial
    Poisson solve is commented out, PIC_L_DD.py:385-389). ``device``
    defaults to the current CUDA device; without a card, pass
    ``device='cpu'``. The Philox key is the JAX key data of
    ``PRNGKey(seed)``: (seed >> 32, seed & 0xffffffff)."""
    _check_ported(cfg)
    grid = cfg.grid
    ng = grid.ng
    device = devices.resolve(device)
    cuda_cic.check_engine_dtype("sheath", device, dtype)
    p = (torch.as_tensor(np.asarray(x), device=device) / grid.dx).to(dtype)
    v3 = torch.as_tensor(np.asarray(v3), device=device).to(dtype)
    q = torch.as_tensor(np.asarray(q), device=device).to(dtype)
    m = torch.as_tensor(np.asarray(m), device=device).to(dtype)
    w = q * (cfg.p2c / grid.dx)
    u = v3[:, 0].contiguous()
    j0 = cuda_cic.deposit_det(p, w * u, ng, periodic=False)
    seed = int(seed)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return SheathState(
        p=p, u=u, vy=v3[:, 1].contiguous(), vz=v3[:, 2].contiguous(), q=q, m=m,
        species=torch.as_tensor(np.asarray(species, np.int32), device=device),
        active=torch.full(p.shape, ACTIVE, dtype=torch.int32, device=device),
        e=zeros((ng,)), j=j0.to(dtype), e_prev=zeros((ng,)),
        rng=((seed >> 32) & _MASK32, seed & _MASK32),
        exit_hist=zeros((2, cfg.exit_hist_bins)),
        step=zeros((), torch.int32), step_host=0,
    )


def make_step(cfg: SheathConfig, reinject_draws: Optional[Callable] = None,
              mesh=None, hash_seeds: Optional[Callable] = None):
    """Build the step: state -> (state, StepMetrics). ``mesh``: the rank's
    ``SlabMesh`` under ``cfg.axis_name`` (data parallel; None is one
    rank).

    ``reinject_draws(step, n)``, when given, replaces the sampler: it
    returns {"x": the new positions in grid coordinates, "z": three
    re-injection normals, and with gamma > 0 "u_therm": the acceptance
    uniforms and "z_therm": three thermostat normals}, (n,) tensors on the
    state's device. The CPU tests pass the JAX engine's own draws through
    it; the engine's path never does.

    ``hash_seeds(step)``, when given, replaces the hash sampler's seeds: a
    dict of ``HASH_STREAMS`` to uint32 seeds (the CPU tests pass the JAX
    engine's ``seed_from_key`` of its key splits).
    """
    _check_ported(cfg)
    ax = ParticleAxis(cfg.axis_name, mesh)
    use_hash = cfg.rng_sampler == "hash" or (cfg.rng_sampler == "auto"
                                             and cfg.axis_name is not None)
    grid = cfg.grid
    ng, dx, dt = grid.ng, grid.dx, cfg.dt
    dt_dx = dt / dx
    cells = float(grid.num_cells)
    dt_eps = dt / EPSILON_0
    wall = dx * cfg.p2c / dt  # the wall surface-charge current per charge
    vmax, bins = cfg.exit_hist_vmax, cfg.exit_hist_bins

    def _use_fused(state) -> bool:
        if cfg.backend not in ("auto", "fused", "composed"):
            raise ValueError(f"unknown backend {cfg.backend!r}")
        if cfg.backend != "auto":
            return cfg.backend == "fused"
        return state.p.is_cuda and state.p.shape[0] >= 8192

    accel_m = anderson_depth(cfg.picard_accel)

    def _mix(es, eh, k, aux):
        # the field is whole on every rank under axis_name: the inner
        # products need no sum over the ranks
        if accel_m is not None:
            return anderson_m_mix(es, eh, k, aux, accel_m)
        if cfg.picard_accel == "anderson":
            return anderson_mix(es, eh, k, aux)
        if cfg.picard_accel == "anderson2":
            return anderson2_mix(es, eh, k, aux)
        return eh, aux

    def _fold(j):
        """The edge fold j[0] += j[1]; j[-1] += j[-2], in place on a fresh
        current."""
        j[0] += j[1]
        j[-1] += j[-2]
        return j

    def _hist_update(hist, act_prev, act_new, u0, species):
        """Exit-velocity histograms from the status transitions, binned by
        the step-start u0, one deposit over every row."""
        right = (act_prev == ACTIVE) & (act_new == LOST_RIGHT)
        left = (act_prev == ACTIVE) & (act_new == LOST_LEFT)
        vout = torch.where(right, u0, torch.where(left, -u0, 0.0))
        idx = torch.clamp(((vout + vmax) * (bins / (2.0 * vmax))).to(torch.int32),
                          0, bins - 1)
        flat = torch.clamp(species - 1, 0, 1) * bins + idx
        weight = torch.where(right | left, 1.0, 0.0).to(hist.dtype)
        upd = cuda_cic.deposit_det(flat.to(hist.dtype), weight, 2 * bins,
                                   periodic=False)
        return hist + ax.sum(upd).reshape(2, bins)

    def _reinject_hash(state, sig, sigth):
        """The thermostat and re-injection on the hash sampler (the JAX
        engine's 'hash' branch): slot ids offset by rank x n, the draws
        in the state's dtype (JAX passes ``p0.dtype.type``)."""
        step_i, act, dtype = state.step_host, state.active, state.p.dtype
        n, dev = state.p.shape[0], state.p.device
        seeds = (hash_seeds(step_i) if hash_seeds is not None else
                 {name: sources.step_seed(state.rng, step_i, k)
                  for k, name in enumerate(HASH_STREAMS)})
        off = ax.rank * n
        draw = dict(device=dev, dtype=dtype)
        hit = zt = None
        if cfg.gamma > 0.0:
            u_th = sources.hash_uniforms(seeds["therm_u"], n, 1, off, **draw)[0]
            hit = (act == ACTIVE) & (u_th < cfg.gamma)
            zt = sources.hash_normals(seeds["therm_v"], n, 2, off, **draw)
        x_new = (sources.hash_uniforms(seeds["reinj_x"], n, 1, off, **draw)[0]
                 * float(cuda_cic.real(dtype)(cells)))
        z = sources.hash_normals(seeds["reinj_v"], n, 2, off, **draw)
        return cuda_rng.reinject_apply(state.p, state.u, state.vy, state.vz,
                                       act != ACTIVE, sig, x_new, z, hit,
                                       sigth, zt)

    def _reinject(state, sig, sigth):
        """Thermostat and re-injection: (p0, u0, vy0, vz0)."""
        step_i, act = state.step_host, state.active
        if reinject_draws is not None:
            d = reinject_draws(step_i, state.p.shape[0])
            hit = zt = None
            if cfg.gamma > 0.0:
                hit = (act == ACTIVE) & (d["u_therm"] < cfg.gamma)
                zt = d["z_therm"]
            return cuda_rng.reinject_apply(
                state.p, state.u, state.vy, state.vz, act != ACTIVE, sig,
                d["x"], d["z"], hit, sigth, zt)
        if use_hash:
            return _reinject_hash(state, sig, sigth)
        return cuda_rng.sheath_reinject(
            state.rng, step_i, state.p, state.u, state.vy, state.vz,
            act.to(state.p.dtype), sig, sigth, cells=cells, gamma=cfg.gamma)

    def step(state: SheathState):
        dev, dtype = state.p.device, state.p.dtype
        cuda_cic.check_engine_dtype("sheath", dev, dtype)
        fused = _use_fused(state)
        q, m, species = state.q, state.m, state.species
        e0 = state.e
        recording = vmax > 0.0 and state.step_host >= cfg.record_exit_after_step

        # Maxwellian sigmas sqrt(kB T / m), divided tensor by tensor (a
        # Python number over a tensor is a reciprocal and a product)
        kbti = torch.full_like(m, cfg.kbti)
        kbt = torch.where(species == 1, torch.full_like(m, cfg.kbte), kbti)
        sig = torch.sqrt(kbt / m)
        sigth = torch.sqrt(kbti / m) if cfg.gamma > 0.0 else None
        p0, u0, vy0, vz0 = _reinject(state, sig, sigth)

        qm = q / m
        w = q * (cfg.p2c / dx)
        es = (e0 + 0.5 * (e0 - state.e_prev)
              if cfg.picard_init == "extrapolate" else e0)
        aux = mix_init(e0, cfg.picard_accel)
        hist = state.exit_hist
        r = torch.full((), math.inf, dtype=dtype, device=dev)
        k, going = 0, cfg.maxiter > 0

        def advance(es, jh, k, aux):
            """Ampere advance, residual, mixing and the exit test of one
            pass: (e1, es_next, r, aux, going)."""
            e1 = e0 + dt_eps * (torch.mean(jh) - jh)
            eh = 0.5 * (e1 + e0)
            r = torch.linalg.norm(es - eh)
            es, aux = _mix(es, eh, k, aux)
            going = k + 1 < cfg.maxiter
            if going:
                # the one host read of the pass: r and ||es|| together
                r_h, n_h = torch.stack([r, torch.linalg.norm(es)]).tolist()
                going = picard_keep(cfg, r_h, n_h, dtype)
            return e1, es, r, aux, going

        if fused:
            act_f = torch.ones_like(p0)  # every row is active after re-injection
            ps, e1 = p0, e0
            while going:
                xh, act1, jh = cuda_sheath.sheath_picard(
                    es, ps, p0, u0, qm, w, act_f, dt=dt, dx=dx)
                jh = _fold(ax.sum(jh))
                if recording:
                    hist = _hist_update(hist, act_f, act1, u0, species)
                e1, es, r, aux, going = advance(es, jh, k, aux)
                ps, act_f = xh, act1
                k += 1
            x1, u1, act1, j1 = cuda_sheath.sheath_finalize(
                es, ps, p0, u0, qm, w, act_f, dt=dt, dx=dx)
            j1 = _fold(ax.sum(j1))
            if recording:
                hist = _hist_update(hist, act_f, act1, u0, species)
            active = act1.to(torch.int32)
        else:
            c = 0.5 * dt * dt_dx  # a Python float, as the JAX composed route's

            def currents(pos, vel, act):
                """The deposit of the active rows' current and the wall
                surface-charge terms (PIC_L_DD.py:41-67), before the sum
                over the ranks and the edge fold."""
                wv = torch.where(act == ACTIVE, w, 0.0)
                j = cuda_cic.deposit_det(pos, wv * vel, ng, periodic=False)
                j[0] += wall * torch.sum(torch.where(act == LOST_LEFT, q, 0.0))
                j[-1] += -wall * torch.sum(torch.where(act == LOST_RIGHT, q, 0.0))
                return j

            active = torch.ones_like(state.active)
            ps, x1, u1, e1, j1 = p0, p0, u0, e0, state.j
            while going:
                is_act = active == ACTIVE
                e_p = torch.where(is_act, gather(es, ps, periodic=False), 0.0)
                accel = qm * e_p
                x1 = p0 + dt_dx * u0 + c * accel
                u1 = u0 + dt * accel
                x1 = torch.where(is_act, x1, 0.0)
                u1 = torch.where(is_act, u1, 0.0)
                xh = torch.where(is_act, 0.5 * (p0 + x1), 0.0)
                uh = torch.where(is_act, 0.5 * (u0 + u1), 0.0)
                right = is_act & ((p0 >= cells) | (xh >= cells) | (x1 >= cells))
                left = is_act & ((p0 <= 0.0) | (xh <= 0.0) | (x1 <= 0.0))
                act_new = torch.where(right, LOST_RIGHT, active)
                act_new = torch.where(left, LOST_LEFT, act_new)
                if recording:
                    hist = _hist_update(hist, active, act_new, u0, species)
                active = act_new
                jh, j1 = (_fold(j) for j in ax.sum_many(
                    [currents(xh, uh, active), currents(x1, u1, active)]))
                e1, es, r, aux, going = advance(es, jh, k, aux)
                ps = xh
                k += 1

        is_active = active == ACTIVE
        # absorbed rows carry zero state until re-injection (PIC_L_DD.py:
        # 459-467); the kinetic energy below uses the raw u1, as the JAX
        # engine's
        u1s = torch.where(is_active, u1, 0.0)
        vy1 = torch.where(is_active, vy0, 0.0)
        vz1 = torch.where(is_active, vz0, 0.0)
        phi = integrate_neg_trapz(e1, dx)
        phi = phi - torch.max(phi)
        kinetic = ax.sum(cfg.p2c * 0.5 * torch.sum(m * u1 * u1))
        counts = [torch.sum(is_active, dtype=torch.int32),
                  torch.sum(active == LOST_LEFT, dtype=torch.int32),
                  torch.sum(active == LOST_RIGHT, dtype=torch.int32)]
        if ax.mesh is not None:
            counts = ax.sum(torch.stack(counts)).unbind(0)
        metrics = StepMetrics(
            field_energy=0.5 * EPSILON_0 * dx * torch.sum(e1 * e1),
            kinetic_energy=kinetic,
            current_bias=torch.mean(j1),
            picard_iters=torch.full((), k, dtype=torch.int32, device=dev),
            picard_residual=r,
            n_active=counts[0],
            n_lost_left=counts[1],
            n_lost_right=counts[2],
            phi=phi,
        )
        new_state = state.replace(
            p=x1, u=u1s, vy=vy1, vz=vz1, active=active, e=e1, j=j1,
            e_prev=e0, exit_hist=hist, step=state.step + 1,
            step_host=state.step_host + 1)
        return new_state, metrics

    return step
