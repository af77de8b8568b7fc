"""The port's ``viz`` and the ``diagnostics`` helpers the CLI calls,
against ``pypic_tpu``'s on the same inputs (made from a seed with numpy):
``first_peak_index`` the same index, ``write_run_outputs`` the same bytes,
the histograms the counts and edges of ``jnp.histogram2d`` and
``jnp.histogram`` exactly (values on the edges, on the last edge and
outside the range; on the CPU the counts go through the deposit's plain
version), and each of viz's eight functions writing a figure with JAX's
signature.
"""

import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import diagnostics as jdiag, viz as jviz

from pypic_tpu_torch import diagnostics, viz

VIZ = ("summary_figure", "sheath_figure", "iead_figure", "bca_figure",
       "save_frames", "convert", "load_particle_dump", "phase_space_replay")


def _on_edges(rng, lo, hi, bins, n=3000):
    """float32 samples over [lo - 30%, hi + 30%] with every edge of JAX's
    (0, bins] range and the last edge twice among them."""
    x = rng.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo), n)
    x = x.astype(np.float32)
    _, edges = jnp.histogram(jnp.asarray(x), bins=bins, range=(lo, hi))
    edges = np.asarray(edges)
    x[:bins + 1] = edges
    x[-1] = edges[-1]
    x[-2] = np.nextafter(edges[-1], np.float32(np.inf))  # just outside
    return x


def test_first_peak_index_matches_jax():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, 200)
    for _ in range(5):
        series = (np.exp(-rng.uniform(0.1, 0.5) * t)
                  * (np.sin(rng.uniform(2, 4) * t) ** 2 + 1e-3))
        dt = t[1] - t[0]
        idx = diagnostics.first_peak_index(torch.from_numpy(series), dt)
        assert idx == jdiag.first_peak_index(series, dt) > 0
    assert diagnostics.first_peak_index(np.arange(5.0), 1.0) == 0


def test_write_run_outputs_same_bytes(tmp_path):
    rng = np.random.default_rng(1)
    energy = rng.normal(size=40).astype(np.float32)
    current = rng.normal(size=40).astype(np.float32)
    params = dict(wp=np.float64(5.6e6), G=3.8e6, dt=5e-9, Ng=50, L=0.35)
    for mod, d in ((jdiag, tmp_path / "jax"), (diagnostics, tmp_path / "port")):
        mod.write_run_outputs(str(d), energy, current, params)
    for name in ("E2.txt", "J.txt", "parameters.out"):
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name


@pytest.mark.parametrize("seed", range(4))
def test_velocity_histogram_equals_jax(seed):
    rng = np.random.default_rng(seed)
    lo, hi = sorted(rng.normal(size=2) * rng.uniform(0.5, 20))
    bins = int(rng.integers(5, 200))
    v = _on_edges(rng, lo, hi, bins)
    h_ref, e_ref = jnp.histogram(jnp.asarray(v), bins=bins, range=(lo, hi))
    h, edges = diagnostics.velocity_histogram(torch.from_numpy(v), bins,
                                              (lo, hi))
    np.testing.assert_array_equal(edges.numpy(), np.asarray(e_ref))
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_ref))
    assert h.dtype == torch.float32 and h.sum() < v.size  # some dropped


@pytest.mark.parametrize("seed", range(4))
def test_phase_space_histogram_equals_jax(seed):
    rng = np.random.default_rng(10 + seed)
    ng_x, nv = int(rng.integers(5, 120)), int(rng.integers(5, 60))
    x_range = (0.0, float(rng.uniform(0.5, 3.0)))
    v_range = (-float(rng.uniform(1, 8)), float(rng.uniform(1, 8)))
    p = _on_edges(rng, *x_range, ng_x)
    v = _on_edges(rng, *v_range, nv)[rng.permutation(p.size)]
    h_ref, xe_ref, ve_ref = jnp.histogram2d(
        jnp.asarray(p), jnp.asarray(v), bins=(ng_x, nv),
        range=[list(x_range), list(v_range)])
    h, xe, ve = diagnostics.phase_space_histogram(
        torch.from_numpy(p), torch.from_numpy(v), ng_x, nv, x_range, v_range)
    np.testing.assert_array_equal(xe.numpy(), np.asarray(xe_ref))
    np.testing.assert_array_equal(ve.numpy(), np.asarray(ve_ref))
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_ref))
    assert h.shape == (ng_x, nv)


def test_histogram_exactness_limit_raises(monkeypatch):
    """float32 counts are exact below 2^24 a bin; past EXACT_COUNT inputs
    the wrapper reads the largest bin once and raises at the limit (the
    limit lowered here so that a small input reaches it)."""
    assert diagnostics.EXACT_COUNT == 2 ** 24
    v = torch.zeros(64)
    monkeypatch.setattr(diagnostics, "EXACT_COUNT", 64)
    with pytest.raises(OverflowError, match="exact"):
        diagnostics.velocity_histogram(v, 4, (-1.0, 1.0))
    with pytest.raises(OverflowError, match="exact"):
        diagnostics.phase_space_histogram(v, v, 4, 4, (-1, 1), (-1, 1))
    h, _ = diagnostics.velocity_histogram(v[:63], 4, (-1.0, 1.0))
    assert float(h.max()) == 63  # under the limit: no read, no raise


def test_viz_signatures_equal_jax():
    for name in VIZ:
        assert (inspect.signature(getattr(viz, name))
                == inspect.signature(getattr(jviz, name))), name


def _figure(name, tmp_path):
    """Call viz's ``name`` on seeded inputs; returns the file it wrote."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1.0, 500)
    v = rng.normal(0, 1.0, 500)
    g = lambda: rng.normal(size=32)  # noqa: E731
    iead = rng.poisson(3.0, (2, 16, 12)).astype(np.float64)

    def frame(i, path):
        viz.summary_figure(path, x, v + 0.1 * i, 1.0, np.exp(np.arange(10.0)),
                           np.arange(10.0), 1.0, None, g(), g(), 1.0)

    def dump():
        path = tmp_path / "particle_output.txt"
        with open(path, "w") as f:
            for t in range(4):
                np.savetxt(f, np.stack([x[:100] + 0.01 * t, v[:100]], -1),
                           delimiter=",")
        return str(path)

    if name == "summary_figure":
        return viz.summary_figure(
            str(tmp_path / "sum.png"), x, v, 1.0, np.exp(np.arange(10.0)),
            np.arange(10.0), 1.0, 0.5, g(), g(), 1.0, system="two-stream")
    if name == "sheath_figure":
        return viz.sheath_figure(
            str(tmp_path / "sheath.png"), x, v, np.full(500, 1e-27),
            np.where(np.arange(500) < 250, 1, 2), g(), g(), g(), 1.0)
    if name == "iead_figure":
        return viz.iead_figure(str(tmp_path / "iead.png"), iead, 40.0, 90.0,
                               ["D", "B"])
    if name == "bca_figure":
        return viz.bca_figure(str(tmp_path / "bca.png"), x, v, 1.0, g(), g(),
                              iead, iead[::-1], 40.0, 90.0, 1.0, ["D", "B"])
    if name == "save_frames":
        frames = viz.save_frames(str(tmp_path), "ps", frame, [0, 2])
        assert len(frames) == 2 and os.path.getsize(frames[0]) > 1000
        return frames[1]
    if name == "convert":
        viz.save_frames(str(tmp_path), "ps", frame, [0, 2])
        return viz.convert(str(tmp_path), "ps", 0, 4, 2,
                           str(tmp_path / "out.gif"))
    if name == "load_particle_dump":
        xs, vs = viz.load_particle_dump(dump(), 100)
        assert xs.shape == vs.shape == (4, 100)
        np.testing.assert_allclose(xs[2], x[:100] + 0.02)
        return viz.phase_space_replay(str(tmp_path / "dump.gif"), xs, vs)
    xs, vs = viz.load_particle_dump(dump(), 100)
    return viz.phase_space_replay(str(tmp_path / "replay.gif"), xs, vs)


@pytest.mark.parametrize("name", VIZ)
def test_viz_writes_its_figure(tmp_path, name):
    """Each of the eight functions writes a PNG or GIF over 1,000 B."""
    path = _figure(name, tmp_path)
    assert path.endswith((".png", ".gif")) and os.path.getsize(path) > 1000
