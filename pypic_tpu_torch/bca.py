"""Binary-collision-approximation (F-TRIDYN) surface coupling (the
counterpart of ``pypic_tpu/bca.py``: numpy on the host, the same
``default_rng`` calls, so the same seed gives the same rows).

The reference couples to an *external Fortran binary* through
``fractal_tridyn.utils.generate_ftridyn_input.tridyn_interface``
(pygcpic.py:1308, 1389-1390): per step it hands the wall-impact
(energy, angle) lists to F-TRIDYN and gets back sputtered + reflected
particle rows ``[energy, ca, cb, cg, m_amu, Z]`` consumed by
``particle_from_energy_angle_coordinates`` (pygcpic.py:34-68, 1599-1620).
F-TRIDYN is not shipped with the reference (SURVEY.md §2) — this module is
the interface seam:

* ``NullBCA`` — the coupling disabled (the reference's ``run_tridyn=False``
  path, pygcpic.py:1767).
* ``BinaryCollisionModel`` — a self-contained empirical surface model for
  testing/standalone runs: reflection with probability R(E) and sputtering
  with a Bohdansky-style yield Y(E) above a threshold, emitting cosine-
  distributed wall-species atoms at a few eV. Not F-TRIDYN — a physically
  plausible stand-in with the same row contract.
* ``FTridynBCA`` — calls the real external package when installed; it
  raises ImportError without it.
* ``particles_from_energy_angle`` — vectorized
  ``particle_from_energy_angle_coordinates`` (pygcpic.py:34-68) + the wall
  side/direction assignment of the injection loop (pygcpic.py:1605-1615).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Tuple

import numpy as np

from .constants import E_CHARGE, M_PROTON


class BCAInterface(Protocol):
    def run(self, energies_ev, angles_deg, num_histories: int = 100
            ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (sputtered, reflected) arrays of rows [E_eV, ca, cb, cg, m_amu, Z]."""
        ...

    def run_from_iead(self, energy_edges, angle_edges, iead,
                      num_histories: int = 100
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Histogram-driven channel (pygcpic.py:1299-1300
        ``run_tridyn_simulations_from_iead``): consume a 2D (energy, angle)
        wall-impact histogram instead of per-impact lists — the pic_iead
        end-of-run post-process path."""
        ...


def _iead_to_impacts(energy_edges, angle_edges, iead):
    """Expand an (ne, na) count histogram to per-impact bin-center
    (energies, angles) lists — the from-IEAD channel reconstructs impacts at
    bin centers (edges as produced by np.histogram2d, pygcpic.py:1259)."""
    energy_edges = np.asarray(energy_edges, np.float64)
    angle_edges = np.asarray(angle_edges, np.float64)
    iead = np.asarray(iead)
    if energy_edges.size == iead.shape[0]:  # centers given, not edges
        e_cent = energy_edges
    else:
        e_cent = 0.5 * (energy_edges[:-1] + energy_edges[1:])
    if angle_edges.size == iead.shape[1]:
        a_cent = angle_edges
    else:
        a_cent = 0.5 * (angle_edges[:-1] + angle_edges[1:])
    counts = np.rint(iead).astype(np.int64)
    ee, aa = np.meshgrid(e_cent, a_cent, indexing="ij")
    reps = counts.reshape(-1)
    return np.repeat(ee.reshape(-1), reps), np.repeat(aa.reshape(-1), reps)


class NullBCA:
    """Coupling disabled (pygcpic.py:1767 run_tridyn=False)."""

    def run(self, energies_ev, angles_deg, num_histories: int = 100):
        empty = np.zeros((0, 6))
        return empty, empty

    def run_from_iead(self, energy_edges, angle_edges, iead,
                      num_histories: int = 100):
        empty = np.zeros((0, 6))
        return empty, empty


@dataclasses.dataclass
class BinaryCollisionModel:
    """Empirical reflection + sputtering surface model (F-TRIDYN stand-in).

    Yield: Bohdansky-like Y(E) = y0 (1 - (Eth/E)^(2/3)) (1 - Eth/E)^2 above
    threshold Eth; reflection probability r0 exp(-E/E_r) with reflected
    energy fraction drawn uniform. Emitted atoms: wall species at a
    Thompson-ish energy (few eV), cosine-distributed directions.
    """

    wall_m_amu: float = 10.81  # boron (pygcpic.py:1363-1367)
    wall_z: int = 5
    incident_m_amu: float = 1.0
    incident_z: int = 1
    y0: float = 0.1
    e_threshold_ev: float = 20.0
    r0: float = 0.5
    e_reflect_ev: float = 50.0
    binding_ev: float = 3.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def _emit_rows(self, count, m_amu, z, energies):
        if count == 0:
            return np.zeros((0, 6))
        # cosine-distributed outgoing directions; ca = |cos| toward plasma
        u = self._rng.uniform(0.0, 1.0, count)
        ca = np.sqrt(u)
        phi = self._rng.uniform(0.0, 2 * np.pi, count)
        s = np.sqrt(1.0 - ca**2)
        cb = s * np.cos(phi)
        cg = s * np.sin(phi)
        return np.stack(
            [energies, ca, cb, cg, np.full(count, m_amu), np.full(count, z)],
            axis=-1,
        )

    def run(self, energies_ev, angles_deg, num_histories: int = 100):
        e = np.asarray(energies_ev, np.float64)
        if e.size == 0:
            z = np.zeros((0, 6))
            return z, z
        # sputtering
        frac = np.zeros_like(e)
        above = e > self.e_threshold_ev
        ratio = np.where(above, self.e_threshold_ev / np.maximum(e, 1e-9), 1.0)
        frac[above] = (
            self.y0 * (1.0 - ratio[above] ** (2.0 / 3.0)) * (1.0 - ratio[above]) ** 2
        )
        sputter_counts = self._rng.binomial(1, np.clip(frac, 0, 1))
        n_sput = int(sputter_counts.sum())
        e_sput = self._rng.exponential(self.binding_ev, n_sput) + self.binding_ev
        sputtered = self._emit_rows(n_sput, self.wall_m_amu, self.wall_z, e_sput)
        # reflection
        p_ref = self.r0 * np.exp(-e / self.e_reflect_ev)
        refl_mask = self._rng.uniform(size=e.shape) < p_ref
        e_ref = e[refl_mask] * self._rng.uniform(0.3, 0.9, int(refl_mask.sum()))
        reflected = self._emit_rows(
            int(refl_mask.sum()), self.incident_m_amu, self.incident_z, e_ref
        )
        return sputtered, reflected

    def run_from_iead(self, energy_edges, angle_edges, iead,
                      num_histories: int = 100):
        """Histogram-driven channel: reconstruct per-impact (E, theta) at the
        bin centers and run the same surface model (the reference's
        run_tridyn_simulations_from_iead, pygcpic.py:1299-1300)."""
        e, a = _iead_to_impacts(energy_edges, angle_edges, iead)
        return self.run(e, a, num_histories=num_histories)


class FTridynBCA:
    """The real external F-TRIDYN coupling (pygcpic.py:1389-1390,
    1571-1572). Requires the ``fractal_tridyn`` package + Fortran binary on
    the host; raises ImportError otherwise."""

    def __init__(self, source_symbol: str, wall_symbol: str):
        import fractal_tridyn.utils.generate_ftridyn_input as gen  # noqa: F401

        self._iface = gen.tridyn_interface(source_symbol, wall_symbol)

    def run(self, energies_ev, angles_deg, num_histories: int = 100):
        sput, refl = self._iface.run_tridyn_simulations_from_list(
            list(np.asarray(energies_ev)), list(np.asarray(angles_deg)),
            number_histories=num_histories,
        )
        # the reference thins by ::number_histories (pygcpic.py:1599-1602)
        return (
            np.asarray(sput[::num_histories], np.float64).reshape(-1, 6),
            np.asarray(refl[::num_histories], np.float64).reshape(-1, 6),
        )

    def run_from_iead(self, energy_edges, angle_edges, iead,
                      num_histories: int = 100):
        """pic_iead's end-of-run channel (pygcpic.py:1299-1300)."""
        sput, refl = self._iface.run_tridyn_simulations_from_iead(
            np.asarray(energy_edges), np.asarray(angle_edges),
            np.asarray(iead), number_histories=num_histories,
        )
        return (
            np.asarray(sput[::num_histories], np.float64).reshape(-1, 6),
            np.asarray(refl[::num_histories], np.float64).reshape(-1, 6),
        )


def postprocess_iead(
    iead, energy_max_ev: float, angle_max_deg: float,
    model_source_wall: "BCAInterface", model_wall_wall: "BCAInterface",
    num_histories: int = 100,
):
    """pic_iead's end-of-run surface post-process (pygcpic.py:1296-1305):
    feed the accumulated per-species IEAD histograms through the BCA — the
    source-species IEAD through the source->wall interface and the
    wall-species IEAD through wall->wall — and derive the
    deposited/reflected/sputtered budget the reference prints
    (pygcpic.py:1301-1305).

    Args:
        iead: (2, ne, na) histograms — row 0 source species (D), row 1 wall
            species (B), the layout of MagnetizedState.iead for the pic_iead
            preset.
        energy_max_ev / angle_max_deg: histogram ranges (pygcpic.py:1259:
            range=[[0, 4 phi_f], [0, 90]]).

    Returns:
        dict with the reference's printed budget plus the raw product rows.
    """
    iead = np.asarray(iead)
    s, ne, na = iead.shape
    e_edges = np.linspace(0.0, energy_max_ev, ne + 1)
    a_edges = np.linspace(0.0, angle_max_deg, na + 1)
    src_s, src_r = model_source_wall.run_from_iead(
        e_edges, a_edges, iead[0], num_histories=num_histories
    )
    wall_s, wall_r = model_wall_wall.run_from_iead(
        e_edges, a_edges, iead[1], num_histories=num_histories
    )
    num_incident_wall = float(iead[1].sum())
    num_reflected_wall = len(wall_r)
    return dict(
        num_incident_source=float(iead[0].sum()),
        num_incident_wall=num_incident_wall,
        num_deposited_wall=num_incident_wall - num_reflected_wall,
        num_reflected_wall=num_reflected_wall,
        num_sputtered=len(wall_s) + len(src_s),
        source_sputtered=src_s, source_reflected=src_r,
        wall_sputtered=wall_s, wall_reflected=wall_r,
    )


def particles_from_energy_angle(
    rows: np.ndarray, sides: np.ndarray, dt: float, length: float,
    p2c: float, rng: np.random.Generator,
):
    """Vectorized particle_from_energy_angle_coordinates (pygcpic.py:34-68)
    with the wall-side direction forcing of the injection loop
    (pygcpic.py:1605-1615: left wall -> vx > 0, right wall -> vx < 0).

    Args:
        rows: (k, 6) [E_eV, ca, cb, cg, m_amu, Z].
        sides: (k,) 0 = left wall, 1 = right wall.
        dt: timestep (for the randomized sub-step start offset).
        length: domain length [m].
        p2c: computational weight for the new particles.
        rng: numpy Generator.

    Returns:
        dict of arrays {x, yz, v, m, charge_state, p2c, z} (SI), charge 0
        (BCA products are neutral, pygcpic.py:1614-1615).
    """
    rows = np.asarray(rows, np.float64).reshape(-1, 6)
    k = rows.shape[0]
    if k == 0:
        return dict(
            x=np.zeros(0), yz=np.zeros((0, 2)), v=np.zeros((0, 3)),
            m=np.zeros(0), charge_state=np.zeros(0), p2c=np.zeros(0),
            z=np.zeros(0, np.int32),
        )
    energy, ca, cb, cg, m_amu, z = rows.T
    m = m_amu * M_PROTON
    u = np.stack([ca, cb, cg], axis=-1)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    speed = np.sqrt(2.0 * energy * E_CHARGE / m)
    v = speed[:, None] * u
    # force direction off the wall (pygcpic.py:1607-1613)
    sides = np.asarray(sides).astype(bool)
    v[:, 0] = np.where(sides, -np.abs(v[:, 0]), np.abs(v[:, 0]))
    x0 = np.where(sides, length, 0.0)
    x = x0 + rng.uniform(0.0, 1.0, k) * v[:, 0] * dt  # pygcpic.py:63
    return dict(
        x=x, yz=np.zeros((k, 2)), v=v, m=m,
        charge_state=np.zeros(k), p2c=np.full(k, p2c),
        z=z.astype(np.int32),
    )
