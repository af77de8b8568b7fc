"""The port's command line (``pypic_tpu_torch.cli``, ``--device cpu``)
against the JAX package's (``pypic_tpu.cli``) on the CPU: the same
presets and flags, the same files, metric rows and text dumps at the
step tolerances of tests/test_torch_implicit.py; checkpoints resumed
across the two CLIs both ways; the resume branches, the refusals and the
pic_iead outputs of tests/test_io.py; every preset at a small size; two
gloo ranks of a domain preset (rank 0 alone writes, the checkpoint loads
into the JAX preset's state at shards=2). ``main(argv)`` runs in-process
but in one test, which runs ``python -m pypic_tpu_torch.cli``.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from pypic_tpu import bca as jbca, checkpoint as jckpt, presets as jpresets
from pypic_tpu.cli import main as jmain

from pypic_tpu_torch import checkpoint, presets
from pypic_tpu_torch.cli import main as tmain
from pypic_tpu_torch.parallel import spawn
import _torch_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = ["--particles", "4000", "--steps", "40", "--plot", "--plot-every", "10",
       "--checkpoint-every", "20"]
# rows 0-2 at the three-step tolerances of tests/test_torch_implicit.py:
# 87-128 (field energy rtol 1e-5, current bias 1e-4 of its largest value);
# all 40 rows: field energy rtol 1e-5 (measured 2.8e-7 two-stream, 9.5e-7
# bump-on-tail), current bias 2e-4 of its largest value (measured 4.2e-5
# two-stream: the bias is a mean of near-cancelling currents, 6.3e-7
# bump-on-tail)
FE_RTOL_3, BIAS_3 = 1e-5, 1e-4
FE_RTOL_ALL, BIAS_ALL = 1e-5, 2e-4


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _rows(d):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _col(rows, k):
    return np.array([r[k] for r in rows], np.float64)


def _params(d):
    with open(os.path.join(d, "parameters.out")) as f:
        return {k: float(v) for k, v in (line.split() for line in f)}


@pytest.fixture(scope="module", params=["two_stream", "bump_on_tail"])
def periodic_runs(request, tmp_path_factory):
    """The same run through both CLIs: (preset, JAX outdir, port outdir)."""
    base = tmp_path_factory.mktemp(request.param)
    j, t = str(base / "jax"), str(base / "port")
    jmain(["run", request.param, *RUN, "--outdir", j, "--clean"])
    tmain(["run", request.param, *RUN, "--outdir", t, "--clean",
           "--device", "cpu"])
    return request.param, j, t


def test_periodic_files_rows_and_dumps_match_jax(periodic_runs):
    _, j, t = periodic_runs
    assert _files(t) == _files(j)
    rj, rt = _rows(j), _rows(t)
    assert len(rt) == len(rj) == 40  # scalar rows stay full-cadence
    assert rt[0].keys() == rj[0].keys()
    fe_j, fe_t = _col(rj, "field_energy"), _col(rt, "field_energy")
    np.testing.assert_allclose(fe_t[:3], fe_j[:3], rtol=FE_RTOL_3)
    np.testing.assert_allclose(fe_t, fe_j, rtol=FE_RTOL_ALL)
    e2_j, e2_t = (np.loadtxt(os.path.join(d, "E2.txt")) for d in (j, t))
    np.testing.assert_allclose(e2_t, e2_j, rtol=FE_RTOL_ALL)
    np.testing.assert_array_equal(e2_t, fe_t.astype(np.float32))
    cb_j, cb_t = (np.loadtxt(os.path.join(d, "J.txt")) for d in (j, t))
    scale = np.abs(cb_j).max()
    np.testing.assert_allclose(cb_t[:3], cb_j[:3], rtol=0, atol=BIAS_3 * scale)
    np.testing.assert_allclose(cb_t, cb_j, rtol=0, atol=BIAS_ALL * scale)
    np.testing.assert_array_equal(_col(rt, "picard_iters"),
                                  _col(rj, "picard_iters"))
    pj, pt = _params(j), _params(t)
    assert pt.keys() == pj.keys()
    for k in pj:
        assert pt[k] == pytest.approx(pj[k], rel=1e-12), k
    for d in (j, t):
        assert os.path.getsize(os.path.join(d, "summary.png")) > 1000
        m = np.load(os.path.join(d, "metrics.npz"))
        assert m["field_energy"].shape == (40,)


def test_checkpoints_resume_both_ways(periodic_runs, tmp_path, capsys):
    """The port resumes the JAX CLI's step-20 checkpoint and the JAX CLI
    the port's; each resumed run's 20 rows agree with the other CLI's
    uninterrupted rows 20-39 at the 40-row tolerance."""
    name, j, t = periodic_runs
    for main, src, ref, extra in ((tmain, j, t, ["--device", "cpu"]),
                                  (jmain, t, j, [])):
        out = tmp_path / f"from_{os.path.basename(src)}"
        os.makedirs(out / "checkpoints")
        shutil.copy(os.path.join(src, "checkpoints", "state_0000000020.npz"),
                    out / "checkpoints")
        capsys.readouterr()
        main(["run", name, "--particles", "4000", "--steps", "20",
              "--checkpoint-every", "20", "--resume", "--outdir", str(out),
              *extra])
        assert "resumed from step 20" in capsys.readouterr().err
        np.testing.assert_allclose(_col(_rows(str(out)), "field_energy"),
                                   _col(_rows(ref), "field_energy")[20:],
                                   rtol=FE_RTOL_ALL)


def test_sheath_dd_deterministic_metrics_match_jax(tmp_path):
    """sheath_dd through both CLIs: the same files and keys, 40 rows; the
    first row (before a re-injection's draw takes effect: the JAX engine
    draws from jax.random, the port from Philox) at the step tolerance,
    its losses equal; on every row the population invariant."""
    argv = ["run", "sheath_dd", "--particles", "4000", "--steps", "40"]
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    jmain([*argv, "--outdir", j])
    tmain([*argv, "--outdir", t, "--device", "cpu"])
    assert _files(t) == _files(j)
    rj, rt = _rows(j), _rows(t)
    assert len(rt) == len(rj) == 40 and rt[0].keys() == rj[0].keys()
    for k in ("field_energy", "kinetic_energy"):
        assert rt[0][k] == pytest.approx(rj[0][k], rel=1e-5), k
    for k in ("n_active", "n_lost_left", "n_lost_right"):
        assert rt[0][k] == rj[0][k], k
    for rows in (rj, rt):
        assert all(r["n_active"] + r["n_lost_left"] + r["n_lost_right"]
                   == 4000 for r in rows)
    assert _params(t) == pytest.approx(_params(j), rel=1e-12)


def test_resume_reprimes_carried_rho_only_when_stale(tmp_path, capsys):
    """tests/test_io.py:425-470 in the port's terms (one rank): resuming
    with carried_rho='on' from a carried-off checkpoint re-primes rho; a
    carried-written checkpoint is resumed untouched."""
    base = ["run", "domain_explicit", "--particles", "8000", "--steps", "8",
            "--checkpoint-every", "4", "--device", "cpu"]
    off, on = str(tmp_path / "off"), str(tmp_path / "on")
    tmain(base + ["--outdir", off, "--clean"])
    capsys.readouterr()
    tmain(base + ["--opt", "carried_rho=on", "--outdir", off, "--resume"])
    err = capsys.readouterr().err
    assert "resumed from step 8" in err and "re-primed carried rho" in err
    tmain(base + ["--opt", "carried_rho=on", "--outdir", on, "--clean"])
    capsys.readouterr()
    tmain(base + ["--opt", "carried_rho=on", "--outdir", on, "--resume"])
    err = capsys.readouterr().err
    assert "resumed from step 8" in err and "re-primed" not in err
    for d in (off, on):
        rows = _rows(d)
        assert len(rows) == 8 and rows[-1]["n_halo_clamped"] == 0
        assert all(np.isfinite(r["field_energy"]) for r in rows)


@pytest.mark.parametrize("argv, match", [
    (["explicit_landau", "--opt", "not_a_kwarg=1"], "--opt"),
    (["explicit_landau", "--opt", "nosep"], "KEY=VALUE"),
    (["two_stream", "--replicas", "2"], "domain_implicit only"),
    (["pic_iead_dd", "--migrate-every", "4"], "domain presets only"),
    (["two_stream", "--migrate-every", "4"], "domain presets only"),
    (["landau_damping", "--opt", "migrate_every=4"], "domain presets only"),
    (["domain_implicit", "--shards", "2"], "torchrun"),
])
def test_refusals_exit_naming_their_cause(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        tmain(["run", *argv, "--particles", "2000", "--steps", "1",
               "--device", "cpu", "--outdir", str(tmp_path)])


def test_figures_without_matplotlib_exit_before_the_run(tmp_path,
                                                        monkeypatch):
    """--plot and --gif need matplotlib (and imageio): where the Python
    lacks them the run exits at once, before any step, naming them."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name in ("matplotlib", "imageio") else real(name, *a)))
    for flag, match in (("--plot", "matplotlib"), ("--gif", "imageio")):
        with pytest.raises(SystemExit, match=match):
            tmain(["run", "two_stream", "--particles", "2000", "--steps", "1",
                   flag, "--device", "cpu", "--outdir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "metrics.jsonl")


def test_run_without_a_card_raises_naming_device(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        tmain(["run", "two_stream", "--particles", "2000", "--steps", "1",
               "--outdir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "metrics.jsonl")


def test_list_is_jax_list(capsys):
    """The port's ``list`` and presets are JAX's, in JAX's order."""
    tmain(["list"])
    port = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    jmain(["list"])
    jax = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert port == jax
    assert list(presets.PRESETS) == list(jpresets.PRESETS)


SMALL = {
    "landau_damping": ["--particles", "2000"],
    "two_stream": ["--particles", "2000"],
    "bump_on_tail": ["--particles", "2000"],
    "explicit_landau": ["--particles", "2000"],
    "sheath_dd": ["--particles", "2000"],
    "pic_iead": ["--opt", "n_per_species=100", "--opt", "ng=100"],
    "pic_iead_gc": ["--opt", "n_per_species=30", "--opt", "ng=40"],
    "pic_bca_aps": ["--opt", "ppc=2"],
    "dirichlet_neumann_test": ["--particles", "2000", "--opt", "ng=100"],
    "domain_implicit": ["--particles", "2000"],
    "domain_explicit": ["--particles", "2000", "--opt",
                        "field_solve=distributed"],
    "pic_iead_dd": ["--opt", "n_per_species=30", "--opt", "ng=40"],
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_every_preset_runs_small(tmp_path, name):
    assert set(SMALL) == set(presets.PRESETS)
    tmain(["run", name, *SMALL[name], "--steps", "3", "--plot",
           "--device", "cpu", "--outdir", str(tmp_path)])
    rows = _rows(str(tmp_path))
    assert len(rows) == 3
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert float(open(tmp_path / "time.out").read()) > 0


def test_pic_iead_dump_gif_plot_and_bca_postprocess(tmp_path):
    """tests/test_io.py:209-262 on the port: 30 steps with the particle
    dump every 10, the gif, the figures and the surface post-process,
    whose budget closes and whose numbers are JAX's postprocess_iead of
    the run's own final IEAD."""
    out = str(tmp_path / "plots")
    tmain(["run", "pic_iead", "--steps", "30", "--outdir", out, "--clean",
           "--dump-particles", "100", "--dump-every", "10", "--gif",
           "--bca-postprocess", "--plot", "--checkpoint-every", "30",
           "--device", "cpu"])
    from pypic_tpu_torch import viz

    xs, vs = viz.load_particle_dump(os.path.join(out, "particle_output.txt"),
                                    100)
    assert xs.shape == vs.shape == (3, 100)
    for name in ("phase_space.gif", "iead.png", "bca_dashboard.png"):
        assert os.path.getsize(os.path.join(out, name)) > 1000, name
    with open(os.path.join(out, "bca_postprocess.json")) as f:
        stats = json.load(f)
    assert (stats["num_deposited_wall"] + stats["num_reflected_wall"]
            == stats["num_incident_wall"])
    pre = presets.pic_iead(device="cpu")
    final, manifest = checkpoint.load(
        os.path.join(out, "checkpoints", "final.npz"), pre.state)
    assert manifest["step"] == 30
    cfg = pre.config
    ref = jbca.postprocess_iead(
        final.iead.numpy(), cfg.iead_energy_max, cfg.iead_angle_max,
        jbca.BinaryCollisionModel(incident_m_amu=2.0, incident_z=1),
        jbca.BinaryCollisionModel(incident_m_amu=10.81, incident_z=5))
    ref = {k: v for k, v in ref.items() if np.isscalar(v)}
    assert stats.keys() == ref.keys()
    for k in ref:
        assert stats[k] == pytest.approx(float(ref[k]), rel=1e-12), k


def test_module_entry_point_runs_as_a_subprocess(tmp_path):
    out = str(tmp_path / "plots")
    res = subprocess.run(
        [sys.executable, "-m", "pypic_tpu_torch.cli", "run", "landau_damping",
         "--particles", "2000", "--steps", "5", "--device", "cpu",
         "--outdir", out, "--clean"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "5 steps x 2000 particles" in res.stderr
    assert len(_rows(out)) == 5


def test_two_gloo_ranks_checkpoint_and_resume(tmp_path):
    """domain_implicit on two gloo ranks: rank 0 alone writes, nothing is
    dropped, the step-20 checkpoint loads into the JAX preset's state at
    shards=2, and a resume from it runs 10 finite steps."""
    out = str(tmp_path / "plots")
    argv = ["run", "domain_implicit", "--device", "cpu", "--particles",
            "8192", "--checkpoint-every", "10", "--outdir", out]
    wrote = spawn.run(2, _torch_ranks.cli, argv + ["--steps", "20", "--clean"],
                      device="cpu", tmp_dir=str(tmp_path))
    assert wrote[1] == [] and wrote[0]
    assert all(os.path.realpath(p).startswith(os.path.realpath(out))
               for p in wrote[0]), wrote[0]
    rows = _rows(out)
    assert len(rows) == 20 and rows[-1]["n_dropped"] == 0
    assert all(np.isfinite(r["field_energy"]) for r in rows)
    ck = os.path.join(out, "checkpoints", "state_0000000020.npz")
    jpre = jpresets.domain_implicit(n=8192, shards=2)
    jst, manifest = jckpt.load(ck, jpre.state)
    assert manifest["step"] == 20 and int(np.asarray(jst.step)) == 20
    assert int(np.asarray(jst.alive).sum()) == 8192
    wrote = spawn.run(2, _torch_ranks.cli, argv + ["--steps", "10",
                                                   "--resume"],
                      device="cpu", tmp_dir=str(tmp_path))
    assert wrote[1] == []
    rows = _rows(out)
    assert len(rows) == 10
    assert all(np.isfinite(r["field_energy"]) for r in rows)
    assert rows[-1]["n_dropped"] == 0


def test_pic_iead_dd_two_gloo_ranks_checkpoint_and_resume(tmp_path):
    """``run pic_iead_dd --shards 2`` on two gloo ranks with checkpoints,
    then ``--resume`` (JAX's tests/test_io.py:42-86 in the port's terms):
    rank 0 alone writes the metrics, the checkpoints and the IEAD figure;
    12 finite rows, nothing dropped; the step-12 checkpoint loads into the
    JAX preset's state at shards=2; the resume runs 6 finite steps from
    step 12."""
    out = str(tmp_path / "plots")
    argv = ["run", "pic_iead_dd", "--device", "cpu", "--shards", "2",
            "--opt", "n_per_species=50", "--opt", "ng=64",
            "--checkpoint-every", "6", "--outdir", out]
    wrote = spawn.run(2, _torch_ranks.cli, argv + ["--steps", "12", "--clean",
                                                   "--plot"],
                      device="cpu", tmp_dir=str(tmp_path))
    assert wrote[1] == [] and wrote[0]
    for f in ("time.out", "metrics.npz", "metrics.jsonl"):
        assert os.path.exists(os.path.join(out, f)), f
    assert os.path.getsize(os.path.join(out, "iead.png")) > 1000
    assert not os.path.exists(os.path.join(out, "bca_dashboard.png"))
    rows = _rows(out)
    assert len(rows) == 12 and rows[-1]["n_dropped"] == 0
    assert all(np.isfinite(r["phi_max"]) for r in rows)
    ck = os.path.join(out, "checkpoints", "state_0000000012.npz")
    jpre = jpresets.pic_iead_dd(n_per_species=50, ng=64, shards=2)
    jst, manifest = jckpt.load(ck, jpre.state)
    assert manifest["step"] == 12 and int(np.asarray(jst.step)) == 12
    wrote = spawn.run(2, _torch_ranks.cli, argv + ["--steps", "6",
                                                   "--resume"],
                      device="cpu", tmp_dir=str(tmp_path))
    assert wrote[1] == []
    rows = _rows(out)
    assert len(rows) == 6 and all(np.isfinite(r["phi_max"]) for r in rows)
    assert rows[-1]["n_dropped"] == 0


def test_bump_on_tail_preset_matches_jax():
    """pypic.py:834-843 in both packages: the same config and the same
    initial particles and fields (the same numpy draws)."""
    from pypic_tpu_torch import interop

    jpre = jpresets.bump_on_tail(n=3000)
    tpre = presets.bump_on_tail(n=3000, device="cpu")
    for k in ("dt", "p2c", "tol", "maxiter"):
        assert getattr(tpre.config, k) == getattr(jpre.config, k), k
    assert tpre.config.grid.length == jpre.config.grid.length
    assert tpre.config.grid.ng == jpre.config.grid.ng == 50
    assert tpre.meta["system"] == jpre.meta["system"] == "bump-on-tail"
    got = interop.implicit_state_to_numpy(tpre.state)
    for k in ("p", "v"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jpre.state, k)))
    for k in ("e", "j"):
        ref = np.asarray(getattr(jpre.state, k), np.float64)
        np.testing.assert_allclose(got[k], ref, rtol=0,
                                   atol=5e-5 * np.abs(ref).max())


@pytest.mark.parametrize("preset", ["domain_implicit", "domain_explicit"])
def test_migrate_every_runs_jax_supersteps(tmp_path, capsys, preset):
    """--migrate-every 2 through both CLIs (tests/test_io.py:347): the
    superstep advances two steps a call, --steps 5 rounds up to 6 and the
    checkpoint cadence 3 to 4, as JAX's CLI says; the same files, one
    metric row a step (field energy rtol 1e-4, the migration counts equal:
    0 on one slab), the same checkpoint steps, and a resume from step 6
    that runs two more."""
    argv = ["run", preset, "--particles", "8192", "--steps", "5",
            "--migrate-every", "2", "--checkpoint-every", "3"]
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    err = {}
    for name, main, extra in (("jax", jmain, ["--shards", "1"]),
                              ("port", tmain, ["--device", "cpu"])):
        out = j if name == "jax" else t
        main(argv + extra + ["--outdir", out, "--clean"])
        err[name] = capsys.readouterr().err
    for msg in ("steps rounded up to 6 (multiple of --migrate-every 2)",
                "checkpoint cadence rounded up to 4 (multiple of "
                "--migrate-every 2)"):
        assert msg in err["jax"] and msg in err["port"], msg
    assert "\n6 steps x " in err["jax"] and "\n6 steps x " in err["port"]
    assert _files(t) == _files(j)
    assert "checkpoints/state_0000000004.npz" in _files(t)
    rj, rt = _rows(j), _rows(t)
    assert len(rt) == len(rj) == 6 and rt[0].keys() == rj[0].keys()
    np.testing.assert_allclose(_col(rt, "field_energy"),
                               _col(rj, "field_energy"), rtol=1e-4)
    for k in ("n_migrated", "n_dropped", "n_alive"):
        np.testing.assert_array_equal(_col(rt, k), _col(rj, k))
    tmain(argv[:5] + ["2"] + argv[6:] + ["--device", "cpu", "--outdir", t,
                                         "--resume"])
    err = capsys.readouterr().err
    assert "resumed from step 6" in err
    assert len(_rows(t)) == 2
