"""Magnetized Boltzmann-electron sheath engine (the counterpart of
``pypic_tpu/engines/magnetized.py``; gen-4, pygcpic.py).

One step of the cycle shared by the reference's ``pic_iead``
(pygcpic.py:1200-1294) and ``pic_bca_aps`` (pygcpic.py:1449-1632; the
surface model runs between steps, ``engines.bca_driver``):

1. deposit of the ion charge and number densities, and the adaptive
   Boltzmann reference-density update (pygcpic.py:841-905): the first
   step pins n0 = 0.9 <n>, later steps evolve it from trapz(exp(phi/Te)),
   the wall factors and the particle ledger;
2. optional binomial smoothing of rho (pygcpic.py:1491);
3. the Newton Boltzmann Poisson solve: with Dirichlet-Dirichlet walls on
   rho from the wall-referenced warm start; with a Dirichlet-Neumann grid
   (``dirichlet_neumann_test``, pygcpic.py:1968-2093) on the number
   density from the previous phi as it is, at the reference's tol 1e-3 /
   maxiter 100 (pygcpic.py:1079-1080);
4. E = -grad phi, the bounded CIC gather (the reference's mirrored
   intra-cell weights by default) and the Boris-Buneman push in the
   constant B (pygcpic.py:460-507); with ``pusher='gc'`` the charged
   particles (mode 1) move as guiding centers (RK4, [v_par, mu, 0] in v)
   and the rest by Boris;
5. wall deactivation and the wall-impact energy-angle (IEAD) histograms
   per species (pygcpic.py:668-689, 1239-1262), guiding centers from the
   6D velocity rebuilt with a random gyro-phase (pygcpic.py:553-596);
   with ``impact_buffer_size`` > 0, the step's wall impacts as packed
   (cap, 7) rows for the surface model (pygcpic.py:1516-1527);
6. with ``bca_escape``, wall-born particles that reach the mid-domain
   band length/2 +/- length/8 leave (pygcpic.py:1529-1541) into the
   escape histograms ``iead_out`` (and, with the impact buffer, packed
   (cap, 4) escape rows);
7. with ``ionization``, the MCC attempt (``ops.ionization``;
   pygcpic.py:350-458) at the number density gathered at the new
   positions; under ``pusher='gc'`` an ionized neutral is promoted to GC
   packing;
8. re-activation of inactive slots from the volumetric source
   (pygcpic.py:691-720, 1248-1254); with 'capped-source' only while the
   active ionized source-species count is below ``source_n``
   (pygcpic.py:1543-1549: at react_batch 0 with the reference timing the
   admission re-counts at each pending slot's turn, an exclusive running
   minimum over the slots, ``prefix_min``; otherwise the first
   ``deficit`` by rank); with ``reactivate='flux'``, of the first ``flux_limit`` inactive
   slots from the wall-flux source (pygcpic.py:2055-2060), crediting the
   particle ledger; under GC the charged newcomers enter in GC packing.

``make_inject`` places the surface model's products (neutral, wall-born,
6D) into free slots between steps without crediting the ledger
(pygcpic.py:1599-1625, 1616).

Backends, as the JAX engine's, with CUDA in the place of the TPU:

* fused (``backend='auto'`` on a CUDA state with n >= 8192, Boris
  pusher): one ``deposit2`` sweep for rho and n and one
  ``boris_gather_push`` sweep;
* composed (and always under ``pusher='gc'``): two ``deposit`` launches,
  the ``gather`` kernel and the tensor-op pushers;

(On the card ``deposit2`` and the carried sweep run up to
``cuda_cic.LARGE_MAX_NG`` nodes, with global float atomics above the
29,056 and 19,370 nodes their shared histograms hold; the fused push and
the gather hold 58,112, the single ``deposit`` too: ROADMAP item 10.)
* carried (``carried_deposit='on'``, whatever ``backend`` says, as the JAX
  engine's branch order has it): the step opens from the rho and n the
  state carries, and the push is the ``boris_gather_push_deposit`` sweep,
  which deposits the next step's rho and n at the new positions. The
  step's later changes are patched in with one ``deposit2`` launch over
  the packed rows: the escapes' tents subtracted, the ionization charge
  added, the re-activated rows of the ``react_batch`` table added;
  ``make_inject`` patches the injected rows the same way. Ionization
  events past ``carried_ion_cap`` revert (``n_ion_suppressed``), escapes
  past it wait a step (``n_escape_deferred``). ``prime_carry`` (and
  ``init_state``) seed the carry from the particles. The carry is exact
  while ``carry_clamped`` and those two stay 0: a clamped tent lands in
  the grid at the gather window's edge and is counted.

The ionization attempt gathers the number density with the ``gather``
kernel, and the IEAD and escape histograms are ``deposit`` launches over
every particle; the impact and escape rows, the escapes and the
ionization branches are tensor operations.

The Newton solve is a one-launch kernel of ``ops.cuda_newton``
(``boltzmann_dirichlet``, or ``boltzmann_dn`` on a D-N grid) for
``newton_backend`` 'pallas', and for 'auto' on a CUDA float32 state, at
any ng (one CTA, a row a thread up to 1,024 nodes, the large path's
blocks of rows above), as the JAX engine's 'auto' takes its Pallas kernel
on the TPU at any ng. 'xla', and 'auto' on the CPU, take the op-composed
Thomas loop of ``ops.poisson`` (the JAX engine's 'xla' route), which
reads its residual on the host once an iteration; on the card it is
counted in ``THOMAS_SOLVES``.

The draws come from the Philox kernels, keyed by the state's two key
words and the host step: ``ops.cuda_rng.source_batch``
(``sources.sample_source_batch``) at counter (slot, step, 0, 0) for the
source (with ``react_batch`` > 0, a table of that many draws: the slot
of re-activation rank j takes row j, counter (j, step, 0, 0), and at
most ``react_batch`` slots re-activate a step),
``ops.cuda_rng.philox_uniforms`` with ``FLUX_TAG``
(``sources.sample_flux_batch``) for the flux, with ``GYRO_TAG`` for the
gyro-phases and with ``ION_TAG`` for the ionization attempt; 'auto' and
'pallas' take them ('pallas' with 'flux' raises, as in the JAX config).
With the default backends a step on the card makes no host sync.

The step's host-side facts (the step number for the first-step branch of
the n0 update and the Philox counters, the key, the shapes) live on the
host in the state, so nothing is read back from the card.

``source_sampler='hash'`` (and 'auto' under ``axis_name`` at
``react_batch`` 0) draws the JAX engine's counter-based batch
(``sources.sample_source_hash``, ``sample_flux_hash``: one ``hash_batch``
launch, the seed from ``sources.step_seed``).

Data parallel (``cfg.axis_name`` set, ``make_step(cfg, mesh=mesh)``; see
``parallel.dataparallel``): each rank holds a contiguous block of the
slots. The deposits, the IEAD and escape histograms, the particle ledger
and the counters are summed over the ranks, and the Newton solve runs on
the summed densities, the same on every rank. The ionization and
gyro-phase draws take the rank into their Philox tag (rank 0's equal the
one-device draws). The full-capacity re-activation batch takes the hash
sampler with slot offset rank x local n, so it is the one-device batch;
the capped policies rank the inactive slots globally, by the exclusive
prefix of the ranks' counts (``all_gather``), and the min-plus admission
takes the ranks' lost counts and minima the same way. With
``react_batch`` > 0 the table is the same on every rank (no offset). The
step's collectives stay on the device: on one rank they are the identity,
and the step still makes no host sync.

The carried deposit under ``axis_name``: the carried rho and n are the
global deposits, the same on every rank (``shard_state`` keeps them
whole). Each rank's push kernel deposits its own rows, its ionization,
escape and re-activation patches go on that partial deposit in its one
``deposit2`` launch, and the partials are summed over the ranks in one
collective a step (``ParticleAxis.sum_many``). The re-activation patch
takes the shared ``react_batch`` table's rows at this rank's global slot
ranks; the caps on ionization and escape patches (``carried_ion_cap``)
count each rank's own rows, as JAX's ``compact_rows`` does inside
``shard_map``; ``carry_clamped``, ``n_ion_suppressed`` and
``n_escape_deferred`` are summed over the ranks.

``deposit_method`` picks the standalone deposits' reduction
(``ops.cic.deposit``: the composed route's, the IEAD's and the prime's);
the fused kernels take no method, as in JAX.

The 'threefry' sampler raises ``NotImplementedError`` from ``init_state``
and ``make_step``, with the reason.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import devices, sources
from ..constants import E_CHARGE, EV_TO_K, K_BOLTZMANN, M_ELECTRON
from ..grid import DIRICHLET_NEUMANN, GridSpec
from ..ops import cuda_cic, cuda_newton, cuda_rng
from ..ops.cic import deposit, gather, histogram_add
from ..ops.fd import grad_neg_bounded, smooth_bounded
from ..ops.poisson import (solve_boltzmann_dirichlet,
                           solve_boltzmann_dirichlet_neumann)
from ..push import (boris_push_dt, from_guiding_center, gc_push_rk4,
                    to_guiding_center)
from ..ops.ionization import attempt_ionization, coefficient_table, rate_matrix
from ..parallel.dataparallel import ParticleAxis
from ..utils import compact_rows, pack_rows, place_rows

_MASK32 = 0xFFFFFFFF
# row width of prefix_min's two-level scan
PREFIX_MIN_WIDTH = 1024
# the D-N Newton envelope of the reference (pygcpic.py:1079-1080)
DN_TOL, DN_MAXITER = 1e-3, 100
# op-composed Thomas solves on a CUDA state (newton_backend 'xla', or a
# state that is not float32), by wall condition: the route reads the host
# once a Newton iteration, so a run that takes it is told apart by this
# count
THOMAS_SOLVES = {"dirichlet": 0, "dirichlet_neumann": 0}


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """Species data for re-activated particles (pygcpic.py:1251 args)."""

    mass: float
    charge_state: float
    p2c: float
    species_idx: int  # row into MagnetizedConfig.species_z
    ti: float  # sampling temperature [K]
    vx: float = 0.0


@dataclasses.dataclass(frozen=True)
class MagnetizedConfig:
    """Same fields, defaults and validation as
    ``pypic_tpu.engines.magnetized.MagnetizedConfig``; see its comments
    for what each option means. 'auto' resolves with CUDA in the place of
    the TPU (module docstring)."""

    grid: GridSpec  # 'dirichlet-dirichlet' or 'dirichlet-neumann'
    dt: float
    te: float  # electron temperature [K]
    b: Tuple[float, float, float]  # magnetic field [T] (pygcpic.py:1329)
    species_z: Tuple[int, ...]  # species_idx -> atomic number Z
    smooth_rho: bool = False
    newton_tol: float = 1e-9  # pygcpic.py:1022
    newton_maxiter: int = 1000  # pygcpic.py:1023
    newton_warm: str = "previous"
    newton_backend: str = "auto"
    ionization: bool = False
    max_charge_state: int = 3
    reactivate: str = "none"  # 'source' | 'capped-source' | 'flux' | 'none'
    source: Optional[SourceSpec] = None
    source_n: int = 0
    source_sampler: str = "auto"
    react_batch: int = 0
    carried_deposit: str = "auto"
    carried_ion_cap: int = 16384
    carried_pad: int = 2
    flux_limit: int = 0
    flux_gamma: float = 0.0
    flux_vx_pert: float = 0.0
    react_timing: str = "reference"
    iead_bins: Tuple[int, int] = (40, 40)  # (energies, angles)
    iead_energy_max: float = 0.0  # [eV]; 0 disables IEAD accumulation
    iead_angle_max: float = 90.0
    deposit_method: str = "auto"
    impact_buffer_size: int = 0
    bca_escape: bool = False
    backend: str = "auto"  # 'auto' | 'fused' | 'composed'
    pusher: str = "boris"
    gc_eom: str = "physical"
    gather_weights: str = "reference"
    eta_in_volts: bool = False
    axis_name: Optional[str] = None

    def __post_init__(self):
        for f in ("dt", "te", "newton_tol", "flux_gamma", "flux_vx_pert",
                  "iead_energy_max", "iead_angle_max"):
            object.__setattr__(self, f, float(getattr(self, f)))
        object.__setattr__(self, "b", tuple(float(v) for v in self.b))
        object.__setattr__(self, "species_z", tuple(int(z) for z in self.species_z))
        if self.source_sampler not in ("auto", "hash", "threefry", "pallas"):
            raise ValueError(f"unknown source_sampler {self.source_sampler!r}")
        if self.newton_warm not in ("extrapolate", "previous"):
            raise ValueError(f"unknown newton_warm {self.newton_warm!r}")
        if self.gather_weights not in ("reference", "cic"):
            raise ValueError(f"unknown gather_weights {self.gather_weights!r}")
        if self.newton_backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown newton_backend {self.newton_backend!r}")
        if self.pusher not in ("boris", "gc"):
            raise ValueError(f"unknown pusher {self.pusher!r}")
        if self.gc_eom not in ("physical", "reference"):
            raise ValueError(f"unknown gc_eom {self.gc_eom!r}")
        if self.pusher == "gc" and not any(v != 0.0 for v in self.b):
            raise ValueError("pusher='gc' requires a nonzero magnetic field")
        if self.pusher == "gc" and self.backend == "fused":
            raise ValueError(
                "backend='fused' does not support pusher='gc' (the GC path "
                "mixes per-particle RK4/Boris by mode — use backend='auto' "
                "or 'composed')")
        if self.source_sampler == "pallas" and self.reactivate == "flux":
            raise ValueError(
                "source_sampler='pallas' does not implement the flux-source "
                "CDF table draw — use 'auto' (the Philox flux draw here)")
        if self.react_batch < 0:
            raise ValueError("react_batch must be >= 0")
        if self.react_timing not in ("reference", "immediate"):
            raise ValueError(f"unknown react_timing {self.react_timing!r}")
        if self.carried_deposit not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown carried_deposit {self.carried_deposit!r}")
        if self.carried_deposit == "on":
            if self.pusher != "boris":
                raise ValueError("carried_deposit requires pusher='boris' "
                                 "(the GC path composes per-particle modes)")
            if self.reactivate != "none" and self.react_batch <= 0:
                raise ValueError(
                    "carried_deposit needs react_batch > 0 with "
                    "re-activation — the batch table bounds the "
                    "re-activation patch exactly")
        if self.axis_name is not None:
            if (self.react_batch == 0 and self.reactivate != "none"
                    and self.source_sampler in ("threefry", "pallas")):
                raise ValueError(
                    "data-parallel full-capacity re-activation needs "
                    "source_sampler='hash' (slot-offset counters give "
                    "shard-invariant draws; a replicated threefry key would "
                    "draw the SAME batch on every shard) — 'auto' resolves "
                    "to hash here, or set react_batch > 0 (rank-keyed "
                    "draws from a replicated table are shard-invariant for "
                    "every sampler)"
                )
            if self.impact_buffer_size > 0:
                raise ValueError(
                    "impact_buffer_size > 0 is not supported under "
                    "data-parallel sharding (host-hybrid BCA seam)"
                )


@dataclasses.dataclass
class MagnetizedState:
    """The JAX state's fields, flat (n,) particle tensors. ``rng`` is the
    Philox key, two 32-bit words on the host (the JAX state's key data);
    the draws of step s use counter (slot, s), so the key never changes.
    ``step_host`` is ``step`` on the host (read once when a state is built
    without it), so that a step needs no host read."""

    p: torch.Tensor  # (n,) x in grid coordinates
    y: torch.Tensor  # (n,) lateral position [m]
    z: torch.Tensor  # (n,) lateral position [m]
    vx: torch.Tensor  # (n,) [m/s]
    vy: torch.Tensor
    vz: torch.Tensor
    m: torch.Tensor  # (n,) mass [kg]
    charge_state: torch.Tensor  # (n,) charge number (float)
    p2c: torch.Tensor  # (n,)
    species_idx: torch.Tensor  # (n,) int32 row into cfg.species_z
    t: torch.Tensor  # (n,) particle time [s] (pygcpic r[6])
    active: torch.Tensor  # (n,) int32 {1, 0}
    at_wall: torch.Tensor  # (n,) int32
    from_wall: torch.Tensor  # (n,) int32 (BCA products)
    mode: torch.Tensor  # (n,) int32 {0: 6D, 1: guiding-center}
    phi: torch.Tensor  # (ng,) potential [V]
    phi_prev: torch.Tensor  # (ng,) previous-step potential
    # (ng,) carried rho and number density that open the next step
    # (carried_deposit='on' only; zeros otherwise)
    rho: torch.Tensor
    n: torch.Tensor
    n0: torch.Tensor  # () Boltzmann electron reference density
    p_old: torch.Tensor  # () previous trapz(exp(phi/Te)) (pygcpic.py:891)
    added: torch.Tensor  # () particle-creation ledger (pygcpic.py:1111-1117)
    rng: Tuple[int, int]  # Philox key words
    iead: torch.Tensor  # (S, ne, na) wall-impact histograms per species
    iead_out: torch.Tensor  # (S, ne, na) sheath-escape histograms
    step: torch.Tensor  # () int32
    step_host: Optional[int] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.step_host is None:
            self.step_host = int(self.step.item())
        self.rng = tuple(int(k) & _MASK32 for k in self.rng)

    def replace(self, **changes) -> "MagnetizedState":
        if "step" in changes:
            changes.setdefault("step_host", None)
        return dataclasses.replace(self, **changes)

    @property
    def v(self) -> torch.Tensor:
        """(n, 3) stacked velocity view (diagnostics and tests)."""
        return torch.stack([self.vx, self.vy, self.vz], dim=-1)

    @property
    def yz(self) -> torch.Tensor:
        """(n, 2) stacked lateral-position view."""
        return torch.stack([self.y, self.z], dim=-1)


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
    rho: torch.Tensor  # (ng,)
    phi: torch.Tensor  # (ng,)
    # (impact_buffer_size, 7) rows [energy_eV, angle_deg, species_idx,
    # side, vx_over_vth, r_lateral_m, from_wall] (side 0: the left wall)
    # and their count; zero-size when the buffer is off
    impacts: torch.Tensor
    n_impacts: torch.Tensor
    n_escaped: torch.Tensor  # wall-born particles removed mid-domain
    # carried_deposit='on' bookkeeping (the carry is exact while all three
    # stay 0): tents clamped at the gather window's edge, ionization events
    # reverted past carried_ion_cap, escapes deferred past it
    carry_clamped: torch.Tensor
    n_ion_suppressed: torch.Tensor
    n_escape_deferred: torch.Tensor
    # (impact_buffer_size, 4) escape rows [vx_over_vth, species_idx,
    # energy_eV, angle_deg] and their count (impact buffer and bca_escape)
    escapes: torch.Tensor
    n_escape_rows: torch.Tensor


# checkpoints of the stacked (n, 2)/(n, 3) leaves of older JAX states split
# on restore (checkpoint.load(migrate=...))
CHECKPOINT_MIGRATIONS = {
    ".yz": lambda a: {".y": a[:, 0], ".z": a[:, 1]},
    ".v": lambda a: {".vx": a[:, 0], ".vy": a[:, 1], ".vz": a[:, 2]},
}


def _check_ported(cfg: MagnetizedConfig) -> None:
    """Raise NotImplementedError for options whose modules are not ported
    yet."""
    todo = {
        "source_sampler='threefry'": (
            cfg.source_sampler == "threefry",
            "it draws jax.random's own streams, which the port does not "
            "reproduce; 'auto' and 'pallas' draw the Philox kernels', "
            "'hash' the counter-based sampler"),
    }
    for what, (hit, why) in todo.items():
        if hit:
            raise NotImplementedError(f"{what} is not ported yet: {why}")


def _safe_charge(charge_state):
    """charge_state with 0 replaced by 1: rows with q = 0 would divide by
    wc = 0; the callers select them away, and this keeps them finite."""
    return torch.where(charge_state != 0, charge_state, 1.0)


def _gc_pack(p, y, z, vx, vy, vz, charge_state, m, cfg: MagnetizedConfig):
    """6D (p in grid coordinates, y, z [m], v) -> GC packing: the guiding
    center in (p, y, z), [v_par, mu, 0] in (vx, vy, vz) (pygcpic.py:509-551;
    the JAX engine's _gc_pack). Returns the six tensors."""
    dx = cfg.grid.dx
    pos = torch.stack([p * dx, y, z], dim=-1)
    v = torch.stack([vx, vy, vz], dim=-1)
    x_gc, vpar, mu = to_guiding_center(pos, v, cfg.b, _safe_charge(charge_state),
                                       m, perp_floor=1e-30)
    return (x_gc[:, 0] / dx, x_gc[:, 1], x_gc[:, 2], vpar, mu,
            torch.zeros_like(vpar))


def _gc_unpack_v(a, p, y, z, vpar, mu, charge_state, m,
                 cfg: MagnetizedConfig):
    """GC packing -> the (n, 3) 6D velocity with the gyro-phase of the
    (n, 3) uniforms ``a`` (pygcpic.py:553-596), for the wall-impact IEAD."""
    pos = torch.stack([p * cfg.grid.dx, y, z], dim=-1)
    _, v6 = from_guiding_center(a, pos, vpar, mu, cfg.b,
                                _safe_charge(charge_state), m)
    return v6


def init_state(x, v3, m, charge_state, p2c, species_idx,
               cfg: MagnetizedConfig, yz=None, seed: int = 0,
               dtype: torch.dtype = torch.float32, capacity: int | None = None,
               device: torch.device | str | None = None) -> MagnetizedState:
    """Build the fixed-capacity state from host (numpy) arrays.
    ``capacity`` > n adds inactive free slots. Positions are divided by dx
    in x's own precision on the host, then cast to ``dtype``. ``device``
    defaults to the current CUDA device; without a card, pass
    ``device='cpu'``. The Philox key is the JAX key data of
    ``PRNGKey(seed)``: (seed >> 32, seed & 0xffffffff)."""
    _check_ported(cfg)
    grid = cfg.grid
    device = devices.resolve(device)
    n = np.shape(x)[0]
    cap = int(capacity) if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < initial particle count {n}")
    pad = cap - n

    def padded(arr, fill=0.0):
        arr = np.asarray(arr)
        if pad == 0:
            return arr
        shape = (pad,) + arr.shape[1:]
        return np.concatenate([arr, np.full(shape, fill, arr.dtype)])

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def put(arr, dt=np_dtype):
        return torch.from_numpy(np.array(arr, dtype=dt)).to(device)

    x = padded(np.asarray(x))
    v3 = padded(np.broadcast_to(np.asarray(v3), (n, 3)))
    m = padded(np.broadcast_to(np.asarray(m, np.float64), (n,)), fill=1.0)
    charge_state = padded(np.broadcast_to(np.asarray(charge_state, np.float64), (n,)))
    p2c = padded(np.broadcast_to(np.asarray(p2c, np.float64), (n,)))
    species_idx = padded(np.broadcast_to(np.asarray(species_idx, np.int32), (n,)))
    active0 = np.concatenate([np.ones(n, np.int32), np.zeros(pad, np.int32)])
    yz_a = np.zeros((cap, 2)) if yz is None else padded(np.asarray(yz))
    ne, na = cfg.iead_bins
    s = len(cfg.species_z)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    seed = int(seed)
    state = MagnetizedState(
        p=put(x / grid.dx),
        y=put(yz_a[:, 0]), z=put(yz_a[:, 1]),
        vx=put(v3[:, 0]), vy=put(v3[:, 1]), vz=put(v3[:, 2]),
        m=put(m), charge_state=put(charge_state), p2c=put(p2c),
        species_idx=put(species_idx, np.int32),
        t=zeros((cap,)),
        active=put(active0, np.int32),
        at_wall=zeros((cap,), torch.int32),
        from_wall=zeros((cap,), torch.int32),
        mode=zeros((cap,), torch.int32),
        phi=zeros((grid.ng,)), phi_prev=zeros((grid.ng,)),
        rho=zeros((grid.ng,)), n=zeros((grid.ng,)),
        n0=zeros(()), p_old=zeros(()), added=zeros(()),
        rng=((seed >> 32) & _MASK32, seed & _MASK32),
        iead=zeros((s, ne, na)), iead_out=zeros((s, ne, na)),
        step=zeros((), torch.int32), step_host=0,
    )
    if cfg.pusher == "gc":
        # charged active particles integrate as guiding centers; neutrals
        # (and free slots) stay 6D (the JAX init_state's packing)
        is_gc = (state.active == 1) & (state.charge_state != 0)
        packed = _gc_pack(state.p, state.y, state.z, state.vx, state.vy,
                          state.vz, state.charge_state, state.m, cfg)
        state = state.replace(
            **{k: torch.where(is_gc, g, getattr(state, k))
               for k, g in zip(("p", "y", "z", "vx", "vy", "vz"), packed)},
            mode=is_gc.to(torch.int32))
    if cfg.carried_deposit == "on":
        state = prime_carry(state, cfg)
    return state


def prime_carry(state: MagnetizedState,
                cfg: MagnetizedConfig) -> MagnetizedState:
    """(Re)compute the carried rho and n from the state's particles (the
    JAX engine's prime_carry): the entry point of carried_deposit='on' at
    initialization and on resuming from a saved state; the step keeps
    them current afterwards. Two ``deposit`` launches on the card."""
    dx, ng = cfg.grid.dx, cfg.grid.ng
    is_active = state.active == 1
    w_rho = torch.where(
        is_active, state.charge_state * E_CHARGE * state.p2c / dx, 0.0)
    w_n = torch.where(is_active, state.p2c / dx, 0.0)
    return state.replace(
        rho=deposit(state.p, w_rho, ng, periodic=False,
                    method=cfg.deposit_method).to(state.phi.dtype),
        n=deposit(state.p, w_n, ng, periodic=False,
                  method=cfg.deposit_method).to(state.phi.dtype))


def make_inject(cfg: MagnetizedConfig):
    """The injector of new particles into free slots (the JAX engine's
    make_inject): the fixed-capacity form of ``particles +=
    new_particles`` (pygcpic.py:1624-1625). The i-th valid new row claims
    the i-th free (inactive) slot; rows beyond the free slots are dropped
    and counted. The rows enter active, wall-born (``from_wall`` 1) and 6D
    (``mode`` 0: BCA products are neutral; ionization promotes them under
    GC), and the particle ledger is not credited (the reference comments
    ``grid.add_particles`` out at its injection site, pygcpic.py:1616).
    Under carried_deposit='on' the placed rows are deposited onto the
    carried rho and n (one ``deposit2`` launch).

    ``inject(state, x [m], yz, v, m, charge_state, p2c, species_idx, t,
    valid)`` takes (k,) / (k, 2) / (k, 3) numpy arrays or tensors and
    returns (state, n_injected, n_dropped), the counts as 0-d int32
    tensors on the state's device."""
    _check_ported(cfg)
    grid = cfg.grid
    dx, ng = grid.dx, grid.ng
    cells = float(grid.num_cells)

    def inject(state: MagnetizedState, x, yz, v, m, charge_state, p2c,
               species_idx, t, valid):
        dev, dtype = state.p.device, state.p.dtype

        def put(a, dt=dtype):
            return torch.as_tensor(a, device=dev).to(dt)

        x, yz, v, m, cs, p2c, t = (put(a) for a in (x, yz, v, m, charge_state,
                                                     p2c, t))
        sp = put(species_idx, torch.int32)
        valid = put(valid, torch.bool)
        n_new = torch.sum(valid, dtype=torch.int32)
        # x / dx as XLA's compiled injector and PyTorch's CUDA division by
        # a scalar take it: x times the reciprocal rounded to the dtype
        real = torch.empty((), dtype=dtype).numpy().dtype.type
        pos = x * float(real(1.0) / real(dx))
        new_fields = [pos, yz[:, 0], yz[:, 1], v[:, 0], v[:, 1], v[:, 2],
                      m, cs, p2c, sp, t]
        old_fields = [state.p, state.y, state.z, state.vx, state.vy, state.vz,
                      state.m, state.charge_state, state.p2c,
                      state.species_idx, state.t]
        updated, take, n_injected = place_rows(state.active != 1, new_fields,
                                               n_new, old_fields, valid=valid)
        new_state = state.replace(
            **dict(zip(("p", "y", "z", "vx", "vy", "vz", "m", "charge_state",
                        "p2c", "species_idx", "t"), updated)),
            active=torch.where(take, 1, state.active),
            at_wall=torch.where(take, 0, state.at_wall),
            from_wall=torch.where(take, 1, state.from_wall),
            mode=torch.where(take, 0, state.mode))
        if cfg.carried_deposit == "on":
            # the i-th valid row landed in the i-th free slot: the patch is
            # the valid rows up to the placed count
            placed = ((compact_rows(valid) < n_injected) & valid).to(dtype)
            rho_p, n_p = cuda_cic.deposit2(
                torch.clamp(pos, 0.0, cells),
                placed * cs * E_CHARGE * p2c / dx, placed * p2c / dx, ng,
                periodic=False)
            new_state = new_state.replace(rho=new_state.rho + rho_p,
                                          n=new_state.n + n_p)
        return new_state, n_injected, n_new - n_injected

    return inject


def boltzmann_n0_update(step: int, n0_prev, p_old, added, q_new, p_new, *,
                        dt, ve, n_mean):
    """Adaptive Boltzmann reference-density recurrence (pygcpic.py:889-904).
    ``step`` is the host step number; the rest are 0-d tensors. Returns
    (n0, p_new)."""
    if step == 0:
        return 0.9 * n_mean, p_new
    r_new = 2.0 * added / dt
    fn = torch.sqrt(ve * q_new * dt / p_new)
    n0 = n0_prev * (
        (1.0 - fn) * p_old / p_new + fn - fn * fn / 4.0
    ) + r_new * dt / p_new
    return n0, p_new


def mirror_gather_position(p, hi):
    """The reference's swapped-intra-cell-weight Dirichlet E gather
    (pygcpic.py:343-347) as a position transform: standard CIC weights at
    the cell-mirrored position 2 floor(p) + 1 - p (the fused kernel inlines
    the same algebra)."""
    pc = torch.clamp(p, 0.0, hi)
    return torch.clamp(2.0 * torch.floor(pc) + 1.0 - pc, 0.0, hi)


def energy_angle(m, vdx, vdy, vdz):
    """Each row's impact energy [eV] and angle to the wall normal [deg]
    (pygcpic.py:228-259)."""
    energy_ev = (0.5 * m * (vdx * vdx + vdy * vdy + vdz * vdz) / E_CHARGE)
    vyz = torch.sqrt(vdy ** 2 + vdz ** 2)
    return energy_ev, torch.atan2(vyz, torch.abs(vdx)) * (180.0 / math.pi)


def iead_traffic(species_idx, m, vdx, vdy, vdz, hit, *, bins, energy_max,
                 angle_max):
    """The wall-impact histogram's traffic (pygcpic.py:1239-1262): each
    row's flat bin species ne na + energy bin na + angle bin (energy in
    eV, angle to the wall normal in degrees) and its weight, 1 on a hit
    inside [0, emax] x [0, amax] and 0 elsewhere (impacts outside are left
    out, as np.histogram2d's range does). Returns (flat, weight)."""
    ne, na = bins
    energy_ev, angle = energy_angle(m, vdx, vdy, vdz)
    in_range = ((energy_ev >= 0.0) & (energy_ev <= energy_max)
                & (angle >= 0.0) & (angle <= angle_max))
    ei = torch.clamp((energy_ev * (ne / energy_max)).to(torch.int32), 0, ne - 1)
    ai = torch.clamp((angle * (na / angle_max)).to(torch.int32), 0, na - 1)
    flat = species_idx * (ne * na) + ei * na + ai
    return flat, torch.where(hit & in_range, 1.0, 0.0).to(vdx.dtype)


def iead_update(iead, species_idx, m, vdx, vdy, vdz, hit, *, bins,
                energy_max, angle_max, reduce=None, method: str = "auto"):
    """Wall-impact energy-angle histogram update (``iead_traffic``): one
    width-0 deposit over every particle (``ops.cic.histogram_add``, the
    deposit kernel on the card). ``reduce`` sums the update over the
    ranks (data parallel); ``method`` is ``histogram_add``'s. Returns
    iead + the update."""
    flat, weight = iead_traffic(species_idx, m, vdx, vdy, vdz, hit, bins=bins,
                                energy_max=energy_max, angle_max=angle_max)
    upd = histogram_add(flat, weight.to(iead.dtype), iead.numel(),
                        method=method)
    if reduce is not None:
        upd = reduce(upd)
    return iead + upd.reshape(iead.shape)


def prefix_min(x: torch.Tensor, width: int = PREFIX_MIN_WIDTH) -> torch.Tensor:
    """The inclusive running minimum of a 1-d integer tensor (JAX's
    ``lax.associative_scan(jnp.minimum, x)``), in two levels: ``torch.cummin``
    along rows of ``width`` (padded with the dtype's largest value), then
    each row's minimum with the running minimum of the rows before it.
    PyTorch's scan with indices runs one block a row, so a single row of
    180,000 takes 0.43 ms on an H100 (PERF.md §6, PR 15); rows of 1,024
    scan side by side."""
    n = x.shape[0]
    rows = -(-n // width)
    top = torch.iinfo(x.dtype).max
    padded = torch.full((rows * width,), top, dtype=x.dtype, device=x.device)
    padded[:n] = x
    local = torch.cummin(padded.view(rows, width), dim=1).values
    before = torch.cummin(local[:, -1], dim=0).values
    carry = torch.cat([torch.full_like(before[:1], top), before[:-1]])
    return torch.minimum(local, carry[:, None]).reshape(-1)[:n]


def make_step(cfg: MagnetizedConfig,
              source_draws: Optional[Callable] = None,
              gyro_draws: Optional[Callable] = None,
              ion_draws: Optional[Callable] = None,
              mesh=None, hash_seeds: Optional[Callable] = None):
    """Build the step: state -> (state, StepMetrics). ``mesh``: the rank's
    ``SlabMesh`` under ``cfg.axis_name`` (data parallel; None is one
    rank).

    ``source_draws(step, n)``, when given, replaces the re-activation
    sampler (the volumetric or the flux source): it returns {"x" [m],
    "vx", "vy", "vz"}, (n,) tensors on the state's device.
    ``gyro_draws(step, n)`` likewise replaces the gyro-phase uniforms of
    the GC wall-impact rebuild: an (n, 3) tensor; ``ion_draws(step, n)``
    the ionization attempt's uniforms: an (n,) tensor. The CPU tests pass
    the JAX engine's own draws through them; the engine's path never
    does. ``hash_seeds(step)`` replaces the hash sampler's seed: a dict
    {"source": uint32 seed} (the tests pass JAX's ``seed_from_key``).
    """
    _check_ported(cfg)
    ax = ParticleAxis(cfg.axis_name, mesh)
    use_hash = cfg.source_sampler == "hash" or (
        cfg.source_sampler == "auto" and ax.on and not cfg.react_batch)
    # the per-rank Philox streams of the ionization and gyro-phase draws
    # (JAX folds the axis index into their keys); rank 0's are one
    # device's
    rank_tag = ax.rank << 16
    grid = cfg.grid
    ng, dx, dt = grid.ng, grid.dx, cfg.dt
    cells = float(grid.num_cells)
    swap = cfg.gather_weights == "reference"
    dirichlet_neumann = grid.bc == DIRICHLET_NEUMANN
    gc = cfg.pusher == "gc"
    # the JAX engine's 'auto' stays off (magnetized.py:783-785)
    carried = cfg.carried_deposit == "on"
    # the reference's eta = exp(phi / Te / 11600) with Te in Kelvin
    # (pygcpic.py:890; see the JAX config's eta_in_volts)
    te_volts = (cfg.te / EV_TO_K) if cfg.eta_in_volts else (cfg.te * EV_TO_K)
    ve = float(np.sqrt(8.0 / np.pi * K_BOLTZMANN * cfg.te / M_ELECTRON))
    src = cfg.source
    # B as float32 values, as the JAX engine's f32 b vector
    b32 = tuple(float(np.float32(v)) for v in cfg.b)
    cap = cfg.impact_buffer_size
    ion_cap = cfg.carried_ion_cap
    rates = rate_matrix(cfg.species_z, cfg.te) if cfg.ionization else None
    # the impact rows' vx / vth: the thermal speed of each particle at the
    # source's sampling temperature (pygcpic.py:100; Te without a source)
    kt_samp = K_BOLTZMANN * (src.ti if src is not None else cfg.te)
    zeros_by_device = {}
    coef_by_device = {}

    def _coef(dtype, dev):
        """The ionization coefficient table, made once a device (filled in
        place: no host copy in a step)."""
        if (dtype, dev) not in coef_by_device:
            coef_by_device[(dtype, dev)] = coefficient_table(rates, dx, dt,
                                                             dtype, dev)
        return coef_by_device[(dtype, dev)]

    def _zeros(dev):
        """The step's constant zero metrics, made once a device."""
        if dev not in zeros_by_device:
            zeros_by_device[dev] = dict(
                i=torch.zeros((), dtype=torch.int32, device=dev),
                impacts=torch.zeros((0, 7), dtype=torch.float32, device=dev),
                escapes=torch.zeros((0, 4), dtype=torch.float32, device=dev))
        return zeros_by_device[dev]

    def _use_fused(state) -> bool:
        if gc:
            # the GC path mixes per-particle RK4/Boris by mode: composed
            return False
        if cfg.backend == "fused":
            return True
        if cfg.backend == "composed":
            return False
        if cfg.backend != "auto":
            raise ValueError(f"unknown backend {cfg.backend!r}")
        return state.p.is_cuda and state.p.shape[0] >= 8192

    def _newton(rho, n_dens, n0, phi_warm):
        dens = n_dens if dirichlet_neumann else rho
        kernel = dens.dtype == torch.float32 and (
            cfg.newton_backend == "pallas"
            or (cfg.newton_backend == "auto" and dens.is_cuda))
        if dirichlet_neumann:
            if kernel:
                return cuda_newton.boltzmann_dn(dens, n0, cfg.te, dx, phi_warm,
                                                tol=DN_TOL, maxiter=DN_MAXITER)
            if dens.is_cuda:
                THOMAS_SOLVES["dirichlet_neumann"] += 1
            return solve_boltzmann_dirichlet_neumann(
                dens, n0, cfg.te, dx, phi_warm, tol=DN_TOL,
                maxiter=DN_MAXITER)
        if kernel:
            return cuda_newton.boltzmann_dirichlet(
                dens, n0, cfg.te, dx, tol=cfg.newton_tol,
                maxiter=cfg.newton_maxiter, phi0=phi_warm)
        if dens.is_cuda:
            THOMAS_SOLVES["dirichlet"] += 1
        return solve_boltzmann_dirichlet(
            dens, n0, cfg.te, dx, tol=cfg.newton_tol,
            maxiter=cfg.newton_maxiter, phi0=phi_warm)

    def _draws(state, step_i: int, n: int):
        if source_draws is not None:
            return source_draws(step_i, n)
        if use_hash:
            seed = (hash_seeds(step_i)["source"] if hash_seeds is not None
                    else sources.step_seed(state.rng, step_i))
            # global slot ids at full capacity; the react_batch table is
            # the same on every rank
            off = 0 if cfg.react_batch else ax.rank * n
            if cfg.reactivate == "flux":
                return sources.sample_flux_hash(
                    seed, n, grid, src.ti, src.mass, vx=src.vx,
                    gamma=cfg.flux_gamma, vx_pert=cfg.flux_vx_pert,
                    slot_offset=off, device=state.p.device)
            return sources.sample_source_hash(
                seed, n, grid, src.ti, src.mass, vx=src.vx, slot_offset=off,
                device=state.p.device)
        if cfg.reactivate == "flux":
            return sources.sample_flux_batch(
                state.rng, step_i, n, grid, src.ti, src.mass, vx=src.vx,
                gamma=cfg.flux_gamma, vx_pert=cfg.flux_vx_pert,
                device=state.p.device)
        return sources.sample_source_batch(
            state.rng, step_i, n, grid, src.ti, src.mass, vx=src.vx,
            device=state.p.device)

    def _gyro(state, step_i: int, n: int):
        if gyro_draws is not None:
            return gyro_draws(step_i, n)
        return cuda_rng.philox_uniforms(state.rng, step_i, n, 3,
                                        cuda_rng.GYRO_TAG | rank_tag,
                                        device=state.p.device).t()

    def _ion(state, step_i: int, n: int):
        if ion_draws is not None:
            return ion_draws(step_i, n)
        return cuda_rng.philox_uniforms(state.rng, step_i, n, 1,
                                        cuda_rng.ION_TAG | rank_tag,
                                        device=state.p.device)[0]

    def _capped_take(state, active, charge_state, inactive, rank):
        """'capped-source' (pic_bca_aps's reactivate-or-delete,
        pygcpic.py:1543-1549): the inactive slots that re-activate while
        the active ionized source-species count (after this step's
        losses and ionization) is below ``source_n``.

        At react_batch 0 with the reference timing the reference re-counts
        at each pending slot's turn in its particle loop, so a countable
        particle at a higher slot lost this step still counts as active
        when a lower pending slot is considered: pending slot j is
        admitted iff the admissions before it are below allow_j = deficit
        - (countable same-step losses above j). allow does not decrease
        along the slots, which gives the admitted count before j the
        min-plus closed form rank_j + min(0, exclusive cummin of
        allow - rank - 1) (the JAX engine's associative min-scan); with no
        same-step loss it is the rank < deficit prefix, what the other
        cases take."""
        sp_src = state.species_idx == src.species_idx
        n_src_active = ax.sum(torch.sum(
            (active == 1) & sp_src & (charge_state > 0), dtype=torch.int32))
        deficit = torch.clamp(cfg.source_n - n_src_active, min=0)
        if cfg.react_timing != "reference" or cfg.react_batch:
            return inactive & (rank < deficit)
        lost_now = ((state.active == 1) & (active != 1) & sp_src
                    & (charge_state > 0)).to(torch.int32)
        n_lost = torch.sum(lost_now, dtype=torch.int32)
        suffix = n_lost - torch.cumsum(lost_now, dim=0, dtype=torch.int32)
        top = torch.iinfo(torch.int32).max
        if ax.mesh is not None:
            # the countable losses of the higher ranks' slots
            suffix = suffix + torch.sum(
                ax.gather(n_lost)[ax.rank + 1:]).to(torch.int32)
        allow = torch.clamp(deficit - suffix, min=0)
        tt = torch.where(inactive, allow - (rank + 1), top)
        m_excl = torch.cat([torch.full_like(tt[:1], top), prefix_min(tt)[:-1]])
        if ax.mesh is not None:
            # the running minimum carried in from the lower ranks' slots
            lower = torch.cat([ax.gather(torch.min(tt))[:ax.rank],
                               torch.full_like(tt[:1], top)])
            m_excl = torch.minimum(m_excl, torch.min(lower))
        return inactive & (rank + torch.clamp(m_excl, max=0) < allow)

    def _push_gc(state, is_active, is_gc, e_field):
        """The mixed push of pusher='gc': Boris for the 6D rows (neutrals),
        RK4 for the guiding centers, inactive rows held."""
        pos = mirror_gather_position(state.p, cells) if swap else state.p
        e_p = torch.where(is_active, gather(e_field, pos, periodic=False), 0.0)
        x_si = state.p * dx
        x1_b, yz1_b, v1_b = boris_push_dt(x_si, state.yz, state.v, e_p, b32,
                                          state.charge_state, state.m, dt)
        pos3 = torch.stack([x_si, state.y, state.z], dim=-1)
        zeros = torch.zeros_like(e_p)
        e3 = torch.stack([e_p, zeros, zeros], dim=-1)
        cs_safe = torch.where(is_gc, state.charge_state, 1.0)
        vpar = (torch.where(state.vx != 0.0, state.vx, 1.0)
                if cfg.gc_eom == "reference" else state.vx)
        x1_g, vpar1, _ = gc_push_rk4(pos3, vpar, state.vy, e3, b32, cs_safe,
                                     state.m, dt, eom_form=cfg.gc_eom)

        def pick(g, b_, held):
            return torch.where(is_gc, g, torch.where(is_active, b_, held))

        return (pick(x1_g[:, 0] / dx, x1_b / dx, state.p),
                pick(x1_g[:, 1], yz1_b[:, 0], state.y),
                pick(x1_g[:, 2], yz1_b[:, 1], state.z),
                pick(vpar1, v1_b[:, 0], state.vx),
                pick(state.vy, v1_b[:, 1], state.vy),
                pick(zeros, v1_b[:, 2], state.vz))

    def step(state: MagnetizedState):
        dev = state.p.device
        n = state.p.shape[0]
        step_i = state.step_host
        zero = _zeros(dev)
        fused = _use_fused(state)
        is_active = state.active == 1
        w_rho = torch.where(
            is_active, state.charge_state * E_CHARGE * state.p2c / dx, 0.0)
        w_n = torch.where(is_active, state.p2c / dx, 0.0)
        carry_clamped = zero["i"]
        if carried:
            # last step's push kernel and patches (or the prime) deposited
            # these from the same positions
            rho, n_dens = state.rho, state.n
        else:
            if fused:
                rho, n_dens = cuda_cic.deposit2(state.p, w_rho, w_n, ng,
                                                periodic=False)
            else:
                rho = deposit(state.p, w_rho, ng, periodic=False,
                              method=cfg.deposit_method)
                n_dens = deposit(state.p, w_n, ng, periodic=False,
                                 method=cfg.deposit_method)
            rho, n_dens = ax.sum_many([rho, n_dens])
        eta = torch.exp(state.phi / te_volts)
        n0, p_old = boltzmann_n0_update(
            step_i, state.n0, state.p_old, state.added,
            q_new=eta[0] + eta[-1], p_new=torch.trapezoid(eta, dx=dx),
            dt=dt, ve=ve, n_mean=torch.mean(n_dens))
        added = torch.zeros_like(state.added)  # reset (pygcpic.py:1215)
        if cfg.smooth_rho:
            rho = smooth_bounded(rho)

        phi_warm = (2.0 * state.phi - state.phi_prev
                    if cfg.newton_warm == "extrapolate" else state.phi)
        if not dirichlet_neumann:
            # wall-referenced D-D warm start: the previous converged,
            # unshifted Newton point (see the JAX engine). The D-N solve
            # starts from the shifted phi as it is, as the reference does
            # (pygcpic.py:1083).
            phi_warm = phi_warm - phi_warm[0]
        res = _newton(rho, n_dens, n0, phi_warm)
        phi = res.phi
        e_field = grad_neg_bounded(phi, dx)

        is_gc = is_active & (state.mode == 1)
        if gc:
            p1, y1, z1, vx1, vy1, vz1 = _push_gc(state, is_active, is_gc,
                                                 e_field)
        elif carried:
            # the push and the next step's deposit in one sweep (this
            # step's wall hits deposit nothing; re-activations are patched
            # in below)
            const = (0.5 * dt * E_CHARGE) * state.charge_state / state.m
            act_f = is_active.to(state.p.dtype)
            (p1, vx1, vy1, vz1, rho_carry, n_carry,
             carry_clamped) = cuda_cic.boris_gather_push_deposit(
                e_field, state.p, state.vx, state.vy, state.vz, const, act_f,
                w_rho, w_n, b=cfg.b, dt_dx=dt / dx, pad=cfg.carried_pad,
                swap_weights=swap)
            y1 = torch.where(is_active, state.y + dt * vy1, state.y)
            z1 = torch.where(is_active, state.z + dt * vz1, state.z)
        elif fused:
            const = (0.5 * dt * E_CHARGE) * state.charge_state / state.m
            act_f = is_active.to(state.p.dtype)
            p1, vx1, vy1, vz1 = cuda_cic.boris_gather_push(
                e_field, state.p, state.vx, state.vy, state.vz, const, act_f,
                b=cfg.b, dt_dx=dt / dx, swap_weights=swap)
            y1 = torch.where(is_active, state.y + dt * vy1, state.y)
            z1 = torch.where(is_active, state.z + dt * vz1, state.z)
        else:
            pos = mirror_gather_position(state.p, cells) if swap else state.p
            e_p = torch.where(is_active, gather(e_field, pos, periodic=False),
                              0.0)
            x1, yz1, v1 = boris_push_dt(state.p * dx, state.yz, state.v, e_p,
                                        b32, state.charge_state, state.m, dt)
            p1 = torch.where(is_active, x1 / dx, state.p)
            y1 = torch.where(is_active, yz1[:, 0], state.y)
            z1 = torch.where(is_active, yz1[:, 1], state.z)
            vx1 = torch.where(is_active, v1[:, 0], state.vx)
            vy1 = torch.where(is_active, v1[:, 1], state.vy)
            vz1 = torch.where(is_active, v1[:, 2], state.vz)
        t1 = torch.where(is_active, state.t + dt, state.t)

        # Dirichlet walls (pygcpic.py:668-689)
        hit = is_active & ((p1 < 0.0) | (p1 > cells))
        active = torch.where(hit, 0, state.active)
        at_wall = torch.where(hit, 1, state.at_wall)
        vdx, vdy, vdz = vx1, vy1, vz1
        if gc and (cfg.iead_energy_max > 0.0 or cap > 0):
            # the impact needs the physical 6D velocity: rebuilt with a
            # random gyro-phase (pygcpic.py:553-596)
            v6 = _gc_unpack_v(_gyro(state, step_i, n), p1, y1, z1, vx1, vy1,
                              state.charge_state, state.m, cfg)
            vdx = torch.where(is_gc, v6[:, 0], vx1)
            vdy = torch.where(is_gc, v6[:, 1], vy1)
            vdz = torch.where(is_gc, v6[:, 2], vz1)

        def histogram(hist, mask):
            return iead_update(hist, state.species_idx, state.m, vdx, vdy,
                               vdz, mask, bins=cfg.iead_bins,
                               energy_max=cfg.iead_energy_max,
                               angle_max=cfg.iead_angle_max,
                               reduce=ax.sum, method=cfg.deposit_method)

        iead = state.iead
        if cfg.iead_energy_max > 0.0:
            iead = histogram(iead, hit)

        # the wall-impact rows for the surface model (pygcpic.py:1516-1527)
        impacts, n_impacts = zero["impacts"], zero["i"]
        if cap > 0:
            energy_ev, angle = energy_angle(state.m, vdx, vdy, vdz)
            vth = torch.sqrt(kt_samp / state.m)
            rows = torch.stack(
                [energy_ev, angle, state.species_idx.to(energy_ev.dtype),
                 (p1 > cells).to(energy_ev.dtype), vdx / vth,
                 torch.sqrt(y1 * y1 + z1 * z1),
                 state.from_wall.to(energy_ev.dtype)], dim=-1)
            (impacts,), n_impacts, _ = pack_rows(hit, [rows], cap)

        # wall-born particles reaching length/2 +/- length/8 leave into the
        # escape histograms (pygcpic.py:1529-1541)
        iead_out = state.iead_out
        n_escaped = n_escape_deferred = zero["i"]
        escapes, n_escape_rows = zero["escapes"], zero["i"]
        patches = []  # carried patches: (positions, rho weights, n weights)
        if cfg.bca_escape:
            escaped = ((active == 1) & (state.from_wall == 1)
                       & (p1 > cells / 2.0 - cells / 8.0)
                       & (p1 < cells / 2.0 + cells / 8.0))
            if carried:
                # the push kernel deposited the escaped rows: subtract
                # their tents; past the cap the removal waits a step (the
                # row, still mid-domain, escapes again)
                keep = escaped & (compact_rows(escaped) < ion_cap)
                n_escape_deferred = torch.sum(escaped & ~keep,
                                              dtype=torch.int32)
                escaped = keep
                (pos_e, wr_e, wn_e), _, _ = pack_rows(escaped,
                                                      [p1, w_rho, w_n], ion_cap)
                patches.append((pos_e, -wr_e, -wn_e))
            active = torch.where(escaped, 0, active)
            if cfg.iead_energy_max > 0.0:
                iead_out = histogram(iead_out, escaped)
            n_escaped = torch.sum(escaped, dtype=torch.int32)
            if cap > 0:
                esc = torch.stack([vdx / vth, state.species_idx.to(energy_ev.dtype),
                                   energy_ev, angle], dim=-1)
                (escapes,), n_escape_rows, _ = pack_rows(escaped, [esc], cap)

        # MCC ionization (pygcpic.py:1510-1513) at the density gathered at
        # the new positions
        n_ionized = n_ion_suppressed = zero["i"]
        charge_state, mode = state.charge_state, state.mode
        if cfg.ionization:
            still_active = active == 1
            n_local = torch.where(still_active,
                                  gather(n_dens, p1, periodic=False), 0.0)
            charge_state, ionized, added_ion = attempt_ionization(
                n_local, charge_state, state.species_idx, state.p2c,
                _coef(n_local.dtype, dev), still_active,
                _ion(state, step_i, n), max_charge_state=cfg.max_charge_state)
            if carried:
                # the carry takes at most ion_cap charge deltas a step;
                # events past it revert entirely and are counted
                keep = ionized & (compact_rows(ionized) < ion_cap)
                suppressed = ionized & ~keep
                n_ion_suppressed = torch.sum(suppressed, dtype=torch.int32)
                charge_state = torch.where(suppressed, charge_state - 1.0,
                                           charge_state)
                added_ion = added_ion - 2.0 * torch.sum(
                    torch.where(suppressed, state.p2c, 0.0)).to(added.dtype)
                ionized = keep
                (pos_i, p2c_i), _, _ = pack_rows(keep, [p1, state.p2c],
                                                 ion_cap)
                patches.append((pos_i, (E_CHARGE / dx) * p2c_i,
                                torch.zeros_like(p2c_i)))
            added = added + added_ion
            n_ionized = torch.sum(ionized, dtype=torch.int32)
            if gc:
                # a neutral that gained charge is magnetized: to GC packing
                # at its current position and velocity
                promote = ionized & (mode == 0)
                packed = _gc_pack(p1, y1, z1, vx1, vy1, vz1, charge_state,
                                  state.m, cfg)
                p1, y1, z1, vx1, vy1, vz1 = (
                    torch.where(promote, g, h)
                    for g, h in zip(packed, (p1, y1, z1, vx1, vy1, vz1)))
                mode = torch.where(promote, 1, mode)

        n_react = zero["i"]
        m_arr, p2c_arr, sp_arr = state.m, state.p2c, state.species_idx
        fw = state.from_wall
        if cfg.reactivate != "none":
            # 'reference': the slots inactive at step START, so a slot lost
            # in this push waits one step (pygcpic.py:1249-1254)
            inactive = ((state.active != 1) if cfg.react_timing == "reference"
                        else (active != 1))
            # react_batch > 0: a table of that many draws, row j for the
            # slot of re-activation rank j
            n_draw = cfg.react_batch or n
            batch = _draws(state, step_i, n_draw)
            bx, bvx, bvy, bvz = (batch["x"] / dx, batch["vx"], batch["vy"],
                                 batch["vz"])
            rank = (compact_rows(inactive)
                    if cfg.react_batch or cfg.reactivate != "source" else None)
            before = 0
            if rank is not None and ax.mesh is not None:
                # the global slot rank: the blocks are contiguous, so the
                # lower ranks' inactive slots come first
                before = ax.before(torch.sum(inactive, dtype=torch.int32))
                rank = rank + before
            if cfg.reactivate == "flux":
                bvx = -torch.abs(bvx)  # pygcpic.py:2059
                take = inactive & (rank < cfg.flux_limit)
            elif cfg.reactivate == "capped-source":
                take = _capped_take(state, active, charge_state, inactive,
                                    rank)
            else:
                take = inactive
            by = torch.zeros_like(bvx)
            bz = by
            react_mode = 0
            if gc and src.charge_state != 0:
                # charged re-activated particles enter in GC coordinates
                bx, by, bz, bvx, bvy, bvz = _gc_pack(
                    bx, by, bz, bvx, bvy, bvz,
                    torch.full_like(bvx, src.charge_state),
                    torch.full_like(bvx, src.mass), cfg)
                react_mode = 1
            if cfg.react_batch:
                # surplus inactive slots wait for the next step
                take = take & (rank < cfg.react_batch)
                if carried:
                    # the taken global ranks are [before, before + n_take):
                    # the patch is the table's rows in that range (each
                    # rank patches its own slice; the sum over the ranks
                    # joins the disjoint slices)
                    ridx = torch.arange(n_draw, device=dev)
                    pmask = ((ridx >= before)
                             & (ridx < before + torch.sum(take,
                                                          dtype=torch.int32)))
                    patches.append((
                        bx, torch.where(pmask, float(src.charge_state)
                                        * E_CHARGE * float(src.p2c) / dx, 0.0),
                        torch.where(pmask, float(src.p2c) / dx, 0.0)))
                idx = torch.clamp(rank, 0, cfg.react_batch - 1).to(torch.int64)
                bx, by, bz, bvx, bvy, bvz = (
                    b_[idx] for b_ in (bx, by, bz, bvx, bvy, bvz))
            p1 = torch.where(take, bx, p1)
            y1 = torch.where(take, by, y1)
            z1 = torch.where(take, bz, z1)
            vx1 = torch.where(take, bvx, vx1)
            vy1 = torch.where(take, bvy, vy1)
            vz1 = torch.where(take, bvz, vz1)
            mode = torch.where(take, react_mode, mode)
            m_arr = torch.where(take, src.mass, m_arr)
            charge_state = torch.where(take, src.charge_state, charge_state)
            p2c_arr = torch.where(take, src.p2c, p2c_arr)
            sp_arr = torch.where(take, src.species_idx, sp_arr)
            # step * dt rounded as the JAX engine's float32 product
            t1 = torch.where(take, float(np.float32(step_i) * np.float32(dt)), t1)
            active = torch.where(take, 1, active)
            at_wall = torch.where(take, 0, at_wall)
            fw = torch.where(take, 0, fw)
            n_react = torch.sum(take, dtype=torch.int32)
            added = added + (2.0 * src.p2c) * torch.sum(take.to(added.dtype))

        if patches:
            # the step's changes after the push, on the carry in one launch
            # (rho and n of each row at its one position)
            pos, wr, wn = (torch.cat(c) for c in zip(*patches))
            patch = cuda_cic.deposit2(pos, wr.to(pos.dtype), wn.to(pos.dtype),
                                      ng, periodic=False)
            rho_carry = rho_carry + patch[0]
            n_carry = n_carry + patch[1]

        counts = [torch.sum(active == 1, dtype=torch.int32),
                  torch.sum(hit, dtype=torch.int32), n_ionized, n_react,
                  n_escaped, carry_clamped, n_ion_suppressed,
                  n_escape_deferred]
        if ax.mesh is not None:
            # the global ledger (the next step's n0 update reads it) and
            # counters
            added = ax.sum(added)
            counts = ax.sum(torch.stack(counts)).unbind(0)
            if carried:
                # the ranks' partial carries: the global deposits that open
                # the next step, in one collective
                rho_carry, n_carry = ax.sum_many([rho_carry, n_carry])
        metrics = StepMetrics(
            n0=n0,
            phi_max=torch.max(phi),
            newton_iters=res.iterations,
            newton_residual=res.residual,
            n_active=counts[0],
            n_hit_wall=counts[1],
            n_ionized=counts[2],
            n_reactivated=counts[3],
            added=added,
            rho=rho,
            phi=phi,
            impacts=impacts,
            n_impacts=n_impacts,
            n_escaped=counts[4],
            carry_clamped=counts[5],
            n_ion_suppressed=counts[6],
            n_escape_deferred=counts[7],
            escapes=escapes,
            n_escape_rows=n_escape_rows,
        )
        new_state = state.replace(
            p=p1, y=y1, z=z1, vx=vx1, vy=vy1, vz=vz1, m=m_arr,
            charge_state=charge_state, p2c=p2c_arr, species_idx=sp_arr, t=t1,
            active=active, at_wall=at_wall, from_wall=fw, mode=mode, phi=phi,
            phi_prev=state.phi, rho=rho_carry if carried else state.rho,
            n=n_carry if carried else state.n, n0=n0, p_old=p_old,
            added=added, iead=iead, iead_out=iead_out,
            step=state.step + 1, step_host=step_i + 1,
        )
        return new_state, metrics

    return step
