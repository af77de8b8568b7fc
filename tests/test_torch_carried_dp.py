"""The carried magnetized deposit under data parallelism
(``engines.magnetized`` with ``carried_deposit='on'`` and ``axis_name``)
against ``pypic_tpu``'s ``make_data_parallel_step`` on 2 CPU devices and
the port's one rank without ``axis_name``: pic_iead at 2,400 particles,
react_batch 512, ionization off (as JAX's dry-run mode 10), 10 steps,
JAX's threefry react_batch tables replayed through ``source_draws`` on 2
gloo ranks. phi_max rtol 5e-4 (tests/test_torch_dataparallel.py's), the
active and re-activated counts within 4 a step, the carry clamps within
2%, no suppressed or deferred patch; the carried rho and n the same bits
on both ranks and within 1e-4 of the one-rank carry's largest node.
"""

import dataclasses as dc

import jax
import numpy as np
import pytest

from pypic_tpu import presets as jpresets
from pypic_tpu import sources as jsources
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.parallel import dataparallel as jdp, make_mesh

from pypic_tpu_torch import interop
from pypic_tpu_torch.engines import magnetized
from pypic_tpu_torch.parallel import make_mesh as tmake_mesh, spawn
import _torch_ranks
from test_torch_dataparallel import magnetized_keys, tcfg


def _rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


CARRIED_STEPS = 10


@pytest.fixture(scope="module")
def carried_dp(tmp_path_factory):
    pre = jpresets.pic_iead(n_per_species=400)  # n = 2400
    jc = dc.replace(pre.config, carried_deposit="on", react_batch=512,
                    source_sampler="threefry", ionization=False,
                    axis_name="particles")
    st = jmag.prime_carry(pre.state, jc)
    mesh = make_mesh(2, axis="particles")
    step = jax.jit(jdp.make_data_parallel_step(jmag.make_step, jc, mesh,
                                               example_state=st))
    jst = jdp.shard_state(st, mesh)
    rows = {}
    for _ in range(CARRIED_STEPS):
        jst, m = step(jst)
        for k, val in m._asdict().items():
            if np.ndim(val) == 0:
                rows.setdefault(k, []).append(np.asarray(val).item())
    keys = magnetized_keys(st.rng, CARRIED_STEPS)
    src = jc.source
    draws = {s: {q: np.asarray(a) for q, a in jsources.sample_source_6d(
        k, jc.react_batch, jc.grid, src.ti, src.mass, vx=src.vx,
        components=True).items()} for s, k in enumerate(keys)}
    state = {k: np.asarray(getattr(st, k))
             for k in interop._MAGNETIZED_FIELDS + ("rng",)}
    cfg = tcfg(jc, magnetized.MagnetizedConfig, source_sampler="auto")
    two = spawn.run(2, _torch_ranks.dp_carried, state, cfg, CARRIED_STEPS,
                    draws, device="cpu",
                    tmp_dir=tmp_path_factory.mktemp("carried_dp"))
    one = _torch_ranks.dp_carried(tmake_mesh(device="cpu"), state,
                                  dc.replace(cfg, axis_name=None),
                                  CARRIED_STEPS, draws)
    return rows, two, one


def _carried_close(ref, got):
    np.testing.assert_allclose(got["phi_max"], ref["phi_max"], rtol=5e-4)
    act = np.abs(np.asarray(got["n_active"]) - ref["n_active"]).max()
    assert act <= 4
    assert sum(got["n_reactivated"]) > 0
    assert np.abs(np.asarray(got["n_reactivated"])
                  - ref["n_reactivated"]).max() <= 4
    assert abs(sum(got["carry_clamped"]) - sum(ref["carry_clamped"])) <= max(
        4, 0.02 * sum(ref["carry_clamped"]))
    assert sum(got["n_ion_suppressed"]) == sum(got["n_escape_deferred"]) == 0


def test_carried_two_ranks_match_jax_data_parallel(carried_dp):
    rows, two, _ = carried_dp
    _carried_close(rows, two[0][0])


def test_carried_two_ranks_match_one_rank(carried_dp):
    rows, two, one = carried_dp
    assert two[1][0] == two[0][0]  # the sums reach every rank
    _carried_close(one[0], two[0][0])
    # the carry is global: both ranks hold the same bits, within float32
    # summation order of the one-rank carry
    np.testing.assert_array_equal(two[0][1], two[1][1])
    assert _rel(one[1], two[0][1]) <= 1e-4
