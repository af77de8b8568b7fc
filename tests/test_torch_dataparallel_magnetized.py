"""Data parallel, the magnetized engine: its re-activation policies on
two gloo ranks against the port's one-rank run and ``pypic_tpu``'s
single-device run (tests/test_magnetized.py:492, 608, 638, 1009), with
the helpers and tolerances of tests/test_torch_dataparallel.py.

* 'source' (pic_iead at 2,400 particles, 15 steps) and 'capped-source'
  (pic_bca_aps at ppc 4, 2,400 particles in 3,600 slots, source_n + 64,
  12 steps; ionization, escape and impact buffer off, as JAX's test) on
  the hash sampler with JAX's seeds: the full-capacity batch at slot
  offset rank x n, the capped admission by global slot rank (min-plus);
* 'flux' (the D-N row, 4,000 particles, 25 steps), hash with JAX's seeds;
* react_batch 512 (pic_iead, 10 steps) with JAX's threefry table replayed:
  the table is the same on every rank, the ranks global.

The capped-source case runs at newton_tol 1e-6 on both sides: the
preset's 1e-9 lies under the float32 residual floor, and the port's CPU
Newton loop reads its residual on the host once an iteration (1,000
iterations on some steps).
"""

import dataclasses as dc

import jax
import numpy as np
import pytest

from pypic_tpu import presets as jpresets
from pypic_tpu import sources as jsources
from pypic_tpu.constants import (E_CHARGE, EPSILON_0, EV_TO_K, K_BOLTZMANN,
                                 M_PROTON)
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.runner import run as jrun

from pypic_tpu_torch import interop
from pypic_tpu_torch.engines import magnetized
from test_torch_dataparallel import (_check_pair, _jrows, _numpy, _seed,
                                     magnetized_keys, run_cases, tcfg)


def flux_setup():
    """tests/test_magnetized.py:638's D-N 'flux' row."""
    density = 1e19
    n, ng, dt = 4000, 200, 2e-10
    ti = te = 10.0 * EV_TO_K
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = JGridSpec(ng, 200.0 * debye, "dirichlet-neumann")
    p2c = density * grid.length / n
    rng = np.random.default_rng(2)
    x = rng.uniform(0, grid.length, n)
    vth = np.sqrt(K_BOLTZMANN * ti / M_PROTON)
    v = rng.normal(0, vth, (n, 3))
    v[:, 0] = -np.abs(v[:, 0])
    src = jmag.SourceSpec(mass=M_PROTON, charge_state=1.0, p2c=p2c,
                          species_idx=0, ti=ti)
    cfg = jmag.MagnetizedConfig(
        grid, dt, te, b=(0.0, 0.0, 0.0), species_z=(1,), reactivate="flux",
        source=src, flux_limit=40, flux_gamma=0.5, flux_vx_pert=-3.0,
        source_sampler="hash")
    return cfg, jmag.init_state(x, v, M_PROTON, 1.0, p2c, 0, cfg, seed=5)



def _magnetized_cases():
    cases = {}
    fields = interop._MAGNETIZED_FIELDS + ("rng",)

    def add(name, jc, st, steps, tables=False):
        _, m = jrun(jmag.make_step(jc), st, steps)
        keys = magnetized_keys(st.rng, steps)
        seeds = {s: {"source": _seed(k)} for s, k in enumerate(keys)}
        draws = None
        if tables:  # the threefry react_batch table JAX draws a step
            src = jc.source
            draws = {s: {q: np.asarray(a) for q, a in jsources.sample_source_6d(
                k, jc.react_batch, jc.grid, src.ti, src.mass, vx=src.vx,
                components=True).items()} for s, k in enumerate(keys)}
        cases[name] = ("magnetized", _numpy(st, fields),
                       tcfg(jc, magnetized.MagnetizedConfig,
                            axis_name="particles"), steps, seeds, draws,
                       _jrows(m))

    pre = jpresets.pic_iead(n_per_species=400)  # n = 2400
    add("magnetized source", dc.replace(pre.config, source_sampler="hash"),
        pre.state, 15)
    add("magnetized react_batch",
        dc.replace(pre.config, source_sampler="threefry", react_batch=512),
        pre.state, 10, tables=True)
    bca = jpresets.pic_bca_aps(ppc=4)  # n = 2400 in 3600 slots
    add("magnetized capped-source",
        dc.replace(bca.config, impact_buffer_size=0, bca_escape=False,
                   ionization=False, source_n=bca.meta["source_n"] + 64,
                   source_sampler="hash", newton_tol=1e-6), bca.state, 12)
    add("magnetized flux", *flux_setup(), 25)
    return cases


CASE_NAMES = ["magnetized source", "magnetized react_batch",
              "magnetized capped-source", "magnetized flux"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(_magnetized_cases(), tmp_path_factory.mktemp("dp"))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_two_ranks_match_one_rank(runs, name):
    r = runs[name]
    for other in r["ranks"][1:]:  # the same Newton counts on every rank
        assert other == r["ranks"][0]
    _check_pair(name, r["one"], r["two"])


@pytest.mark.parametrize("name", CASE_NAMES)
def test_one_rank_matches_jax_single_device(runs, name):
    r = runs[name]
    _check_pair(name, {k: v.tolist() for k, v in r["jax"].items()}, r["one"])


@pytest.mark.parametrize("name", CASE_NAMES)
def test_two_ranks_match_jax_single_device(runs, name):
    r = runs[name]
    _check_pair(name, {k: v.tolist() for k, v in r["jax"].items()}, r["two"])
