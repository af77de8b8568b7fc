"""The port's counter-based 'hash' sampler against ``pypic_tpu.sources``:
``hash_uniforms``, ``hash_normals``, ``sample_source_6d_hash`` and
``sample_flux_6d_hash`` on the same seeds (the JAX samplers seeded by
``seed_from_key``, the port's by that seed as a number).

* The uniforms are bit-equal for every seed, stream count and offset,
  including an offset whose slot ids wrap past 2^32 and a slot whose
  uniform rounds to 1 (the float32 sum rounds to even, as in JAX).
* The normals and the samplers' outputs agree at float32 rounding: within
  TOL_REL of the largest magnitude (the Box-Muller logarithm, root, sine
  and cosine are float32 functions in JAX and float64 functions rounded
  once in the port's plain version).
* Shard invariance: two offset halves joined equal the whole, bit for bit.

The card's kernel (``hash_batch``) against the plain version is a card
test (``tests/test_torch_cuda.py``) and a phase of ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import sources as jsources
from pypic_tpu.constants import EV_TO_K, M_PROTON
from pypic_tpu.grid import GridSpec as JGridSpec

from pypic_tpu_torch import sources
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import cuda_cic, cuda_rng

TOL_REL = 2e-6

# (seed, n, streams, offset)
CASES = [
    (44, 1000, 2, 669_265 - 500),  # stream 0 of slot 669,265 rounds to 1
    (0, 1, 1, 0),
    (123, 1000, 4, 0),
    (0xFFFFFFFF, 777, 8, 2**32 - 300),  # slot ids wrap past 2^32
    (7, 513, 2, 12_345),
    (0x9E3779B9, 64, 16, 2**31),
]


@pytest.mark.parametrize("seed, n, streams, offset", CASES)
def test_uniforms_bit_equal_to_jax(seed, n, streams, offset):
    ref = np.asarray(jsources.hash_uniforms(jnp.uint32(seed), n, streams,
                                            offset=offset))
    got = sources.hash_uniforms(seed, n, streams, offset, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    # ((h >> 8) + 1/2) 2^-24 in float32: the sum rounds to even above
    # 2^23, so a uniform can be 1 (never 0)
    assert (got > 0).all() and (got <= 1).all()


@pytest.mark.parametrize("seed, n, streams, offset",
                         [c for c in CASES if c[2] % 2 == 0])
def test_normals_match_jax(seed, n, streams, offset):
    ref = np.asarray(jsources.hash_normals(jnp.uint32(seed), n, streams // 2,
                                           offset=offset))
    got = sources.hash_normals(seed, n, streams // 2, offset,
                               device="cpu").numpy()
    assert got.shape == ref.shape == (streams, n)
    assert np.abs(got - ref).max() <= TOL_REL * np.abs(ref).max()


def _samplers(slot_offset):
    grid = (51, 5e-4, "dirichlet-dirichlet")
    key = jax.random.PRNGKey(3)
    seed = int(jsources.seed_from_key(key))
    kw = dict(ti=10.0 * EV_TO_K, mass=M_PROTON)
    return [
        (jsources.sample_source_6d_hash(key, 300, JGridSpec(*grid), vx=3e4,
                                        slot_offset=slot_offset,
                                        components=True, **kw),
         sources.sample_source_hash(seed, 300, GridSpec(*grid), vx=3e4,
                                    slot_offset=slot_offset, device="cpu",
                                    **kw)),
        (jsources.sample_flux_6d_hash(key, 300, JGridSpec(*grid), gamma=0.4,
                                      vx_pert=-2.0, slot_offset=slot_offset,
                                      components=True, **kw),
         sources.sample_flux_hash(seed, 300, GridSpec(*grid), gamma=0.4,
                                  vx_pert=-2.0, slot_offset=slot_offset,
                                  device="cpu", **kw)),
    ]


@pytest.mark.parametrize("slot_offset", [0, 4096])
def test_samplers_match_jax(slot_offset):
    for ref, got in _samplers(slot_offset):
        assert sorted(ref) == sorted(got)
        for k in ref:
            r = np.asarray(ref[k], np.float64)
            g = got[k].double().numpy()
            assert np.abs(g - r).max() <= TOL_REL * np.abs(r).max(), k


@pytest.mark.parametrize("normals", [False, True])
def test_offset_halves_join_to_the_whole(normals):
    whole = cuda_rng.hash_batch(99, 1000, 4, offset=2**32 - 500,
                                normals=normals, device="cpu")
    halves = [cuda_rng.hash_batch(99, 500, 4, offset=2**32 - 500 + 500 * r,
                                  normals=normals, device="cpu")
              for r in range(2)]
    assert torch.equal(torch.cat(halves, dim=1), whole)


def test_cpu_runs_the_plain_version_and_launches_nothing():
    cuda_cic.reset_launch_counts()
    got = cuda_rng.hash_batch(5, 100, 6, offset=3, normals=True, device="cpu")
    assert torch.equal(got, cuda_rng.hash_batch_plain(5, 100, 6, 3, True))
    assert cuda_cic.LAUNCHES["hash_batch"] == 0


@pytest.mark.parametrize("kw, match", [
    (dict(n=0, streams=1), "n must be"),
    (dict(n=8, streams=17), "streams"),
    (dict(n=8, streams=3, normals=True), "even"),
])
def test_bad_shapes_raise(kw, match):
    n, streams = kw.pop("n"), kw.pop("streams")
    with pytest.raises(ValueError, match=match):
        cuda_rng.hash_batch(1, n, streams, device="cpu", **kw)


def test_step_seeds_differ_by_step_stream_and_key():
    seeds = {sources.step_seed((0, 1), s, k) for s in range(50)
             for k in range(4)}
    assert len(seeds) == 200
    assert sources.step_seed((0, 1), 3) != sources.step_seed((0, 2), 3)
    assert all(0 <= x < 2**32 for x in seeds)
