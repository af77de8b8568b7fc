"""Checkpoints of pypic_tpu_torch against pypic_tpu's: the same .npz
container and manifest (format 2, the JAX state's leaf paths), so a
checkpoint written by either package loads into the other's state; resume
on the CPU (the plain kernel versions, a fixed summation order) is bit
for bit; the manager's cadence, ``keep`` and asynchronous writer follow
tests/test_checkpoint.py:130-139, 366-433. Every comparison here is
exact.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from pypic_tpu import checkpoint as jckpt
from pypic_tpu import presets as jpresets
from pypic_tpu.engines import magnetized as jmag

from pypic_tpu_torch import bca, checkpoint, interop, presets
from pypic_tpu_torch.engines import bca_driver, magnetized
from pypic_tpu_torch.runner import run

PPC = 4


def _assert_states_equal(a, b):
    da = interop.magnetized_state_to_numpy(a)
    db = interop.magnetized_state_to_numpy(b)
    assert da.keys() == db.keys()
    for k in da:
        assert da[k].dtype == db[k].dtype, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    assert a.step_host == b.step_host and a.rng == b.rng


def _port_pre():
    """The port's preset and its config with the Newton kernel's plain
    version (the PCR loop of the card's kernel)."""
    pre = presets.pic_bca_aps(ppc=PPC, device="cpu")
    return pre, dataclasses.replace(pre.config, newton_backend="pallas")


@pytest.fixture(scope="module")
def jax_mid():
    """The JAX preset's state after 3 steps (the key split 3 times, the
    step at 3, the carried fields zero)."""
    jpre = jpresets.pic_bca_aps(ppc=PPC)
    step = jax.jit(jmag.make_step(jpre.config))
    st = jpre.state
    for _ in range(3):
        st, _ = step(st)
    return jpre, st


def test_jax_checkpoint_loads_into_port_state(tmp_path, jax_mid):
    """A JAX-written checkpoint into the port's template: every field
    equal to the JAX state's, the key words the JAX key data, step_host
    rebuilt from step; the manifest's leaf paths are the port's."""
    _, jst = jax_mid
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jst, step=3)
    template = presets.pic_bca_aps(ppc=PPC, seed=9, device="cpu").state
    st, manifest = checkpoint.load(path, template)
    assert manifest["step"] == 3
    assert manifest["leaf_paths"] == checkpoint._flatten_with_paths(template)[0]
    got = interop.magnetized_state_to_numpy(st)
    for k in interop._MAGNETIZED_FIELDS:
        ref = np.asarray(getattr(jst, k))
        assert got[k].dtype == ref.dtype, k
        np.testing.assert_array_equal(got[k], ref, err_msg=k)
    np.testing.assert_array_equal(got["rng"], np.asarray(jst.rng))
    assert st.step_host == 3


def test_port_checkpoint_loads_into_jax_state(tmp_path):
    """A port-written checkpoint (after 3 steps of the port) into the
    JAX template: every leaf equal."""
    pre, cfg = _port_pre()
    st, _ = run(magnetized.make_step(cfg), pre.state, 3)
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, st, step=3, extra={"run": "port"})
    template = jpresets.pic_bca_aps(ppc=PPC, seed=9).state
    jst, manifest = jckpt.load(path, template)
    assert manifest["extra"] == {"run": "port"}
    d = interop.magnetized_state_to_numpy(st)
    for k in interop._MAGNETIZED_FIELDS + ("rng",):
        ref = np.asarray(getattr(jst, k))
        assert d[k].dtype == ref.dtype, k
        np.testing.assert_array_equal(d[k], ref, err_msg=k)


def test_port_resume_is_bit_exact_on_the_cpu(tmp_path):
    """run(6) == run(3); save; load into a fresh template; run(3), through
    ionization, the escape, the impact rows, 'capped-source' and an
    injection: every field equal bit for bit (the CPU's plain versions
    sum in a fixed order)."""
    pre, cfg = _port_pre()
    step = magnetized.make_step(cfg)
    inject = magnetized.make_inject(cfg)
    mid, _ = run(step, pre.state, 3)
    k = 6
    rng = np.random.default_rng(0)
    mid, n_inj, _ = inject(
        mid, rng.uniform(0.1, 0.9, k).astype(np.float32) * cfg.grid.length,
        np.zeros((k, 2), np.float32), (rng.normal(size=(k, 3)) * 1e4).astype(np.float32),
        np.full(k, 10.81 * 1.67e-27, np.float32), np.zeros(k, np.float32),
        np.full(k, 1e10, np.float32), np.ones(k, np.int32),
        np.zeros(k, np.float32), np.ones(k, bool))
    assert int(n_inj) == k
    full, m_full = run(step, mid, 3)
    path = str(tmp_path / "mid.npz")
    checkpoint.save(path, mid, step=3)
    template = presets.pic_bca_aps(ppc=PPC, seed=5, device="cpu").state
    restored, _ = checkpoint.load(path, template)
    _assert_states_equal(restored, mid)
    resumed, m_res = run(step, restored, 3)
    _assert_states_equal(resumed, full)
    for a, b in zip(m_full, m_res):
        assert torch.equal(a, b)


def test_checkpoint_migrations_split_stacked_leaves(tmp_path, jax_mid):
    """A checkpoint with the older stacked ``.v`` (n, 3) and ``.yz`` (n,
    2) leaves restores through CHECKPOINT_MIGRATIONS; without them the
    unknown leaves are refused."""
    _, jst = jax_mid
    paths, leaves = checkpoint._flatten_with_paths(
        interop.magnetized_state_from_numpy(
            {k: np.asarray(getattr(jst, k)) for k in
             interop._MAGNETIZED_FIELDS + ("rng",)}, "cpu"))
    arrays = dict(zip(paths, checkpoint._to_host(leaves)))
    old = {p: a for p, a in arrays.items()
           if p not in (".vx", ".vy", ".vz", ".y", ".z")}
    old[".v"] = np.stack([arrays[".vx"], arrays[".vy"], arrays[".vz"]], -1)
    old[".yz"] = np.stack([arrays[".y"], arrays[".z"]], -1)
    path = str(tmp_path / "old.npz")
    checkpoint._write_npz(path, list(old), list(old.values()), 3, None)
    template = presets.pic_bca_aps(ppc=PPC, device="cpu").state
    with pytest.raises(ValueError, match="not in the template"):
        checkpoint.load(path, template)
    st, _ = checkpoint.load(path, template,
                            migrate=magnetized.CHECKPOINT_MIGRATIONS)
    for k in ("vx", "vy", "vz", "y", "z"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), arrays["." + k])
    assert set(magnetized.CHECKPOINT_MIGRATIONS) == set(jmag.CHECKPOINT_MIGRATIONS)


def test_load_refuses_shape_mismatch_and_fills_absent_leaves(tmp_path, capsys):
    """A leaf of another shape is refused; a leaf the checkpoint lacks
    takes the template's value (with a note on stderr)."""
    pre, _ = _port_pre()
    other = presets.pic_bca_aps(ppc=PPC + 1, device="cpu").state
    path = str(tmp_path / "other.npz")
    checkpoint.save(path, other, step=0)
    with pytest.raises(ValueError, match="leaf .p"):
        checkpoint.load(path, pre.state)
    paths, leaves = checkpoint._flatten_with_paths(pre.state)
    keep = [i for i, p in enumerate(paths) if p != ".iead_out"]
    path = str(tmp_path / "partial.npz")
    checkpoint._write_npz(path, [paths[i] for i in keep],
                          [checkpoint._to_host(leaves)[i] for i in keep], 0, None)
    st, _ = checkpoint.load(path, pre.state)
    assert "leaf .iead_out absent" in capsys.readouterr().err
    _assert_states_equal(st, pre.state)


def test_manager_cadence_and_gc(tmp_path):
    """tests/test_checkpoint.py:130-139: every 5, keep 2, steps 1-20 ->
    [15, 20]; restore the latest; a strided caller saves at each
    boundary it crosses."""
    pre, _ = _port_pre()
    mgr = checkpoint.CheckpointManager(str(tmp_path / "c"), every=5, keep=2)
    for s in range(1, 21):
        mgr.maybe_save(pre.state, s)
    assert mgr.steps() == [15, 20] and mgr.latest() == 20
    restored, manifest = mgr.restore(pre.state)
    assert manifest["step"] == 20
    _assert_states_equal(restored, pre.state)
    strided = checkpoint.CheckpointManager(str(tmp_path / "s"), every=5, keep=0)
    saved = [s for s in range(3, 22, 3) if strided.maybe_save(pre.state, s)]
    assert saved == [6, 12, 15, 21] and strided.steps() == saved


def test_async_checkpoint_bit_exact_and_ordered(tmp_path):
    """tests/test_checkpoint.py:366-389: async and sync managers over 6
    steps save at the same steps, keep the same files and restore equal
    states."""
    pre, cfg = _port_pre()
    step = magnetized.make_step(cfg)
    mgr_a = checkpoint.CheckpointManager(str(tmp_path / "a"), every=2, keep=2,
                                         async_write=True)
    mgr_s = checkpoint.CheckpointManager(str(tmp_path / "s"), every=2, keep=2)
    s = pre.state
    for i in range(1, 7):
        s, _ = step(s)
        assert mgr_a.maybe_save(s, i) == mgr_s.maybe_save(s, i)
    mgr_a.close()
    assert mgr_a.steps() == mgr_s.steps() == [4, 6]
    ra, _ = mgr_a.restore(pre.state)
    rs, _ = mgr_s.restore(pre.state)
    _assert_states_equal(ra, rs)
    _assert_states_equal(ra, s)


def test_async_checkpoint_restore_waits_for_pending(tmp_path):
    """tests/test_checkpoint.py:392-407: restore() of a write still in
    flight drains the writer first."""
    pre, _ = _port_pre()
    mgr = checkpoint.CheckpointManager(str(tmp_path), every=1, async_write=True)
    assert mgr.maybe_save(pre.state, 1)
    restored, manifest = mgr.restore(pre.state)
    assert manifest["step"] == 1
    _assert_states_equal(restored, pre.state)
    mgr.close()


def test_async_checkpoint_writer_error_surfaces(tmp_path, monkeypatch):
    """tests/test_checkpoint.py:410-433: a writer failure is raised on the
    next save, and the cadence rolls back so the window is retried."""
    pre, _ = _port_pre()
    mgr = checkpoint.CheckpointManager(str(tmp_path), every=1, async_write=True)

    def boom(*a, **k):
        raise OSError("disk on fire")

    real_write = checkpoint._write_npz
    monkeypatch.setattr(checkpoint, "_write_npz", boom)
    assert mgr.maybe_save(pre.state, 1)
    with pytest.raises(OSError, match="disk on fire"):
        mgr.maybe_save(pre.state, 2)
    monkeypatch.setattr(checkpoint, "_write_npz", real_write)
    assert mgr.maybe_save(pre.state, 2)
    mgr.close()
    assert mgr.steps() == [2]


def test_run_bca_checkpoints_every_boundary(tmp_path):
    """run_bca with a manager (every 2, blocks of 3 steps over 9): a save
    at each crossed boundary; the last checkpoint restores the returned
    state bit for bit, its manifest in the JAX container's format."""
    pre, cfg = _port_pre()
    mgr = checkpoint.CheckpointManager(str(tmp_path), every=2, keep=0)
    fin, stats, _ = bca_driver.run_bca(
        pre.state, cfg, 9, bca.BinaryCollisionModel(seed=1),
        bca.BinaryCollisionModel(incident_m_amu=10.81, incident_z=5, seed=2),
        seed=3, pic_steps_per_bca=3, checkpoint_manager=mgr)
    assert mgr.steps() == [3, 6, 9]
    restored, manifest = mgr.restore(pre.state)
    _assert_states_equal(restored, fin)
    with np.load(mgr._path(9)) as data:
        raw = json.loads(str(data["__manifest__"]))
    assert raw["format_version"] == 2 and raw["step"] == 9
    assert raw["leaf_paths"][0] == ".p" and ".rng" in raw["leaf_paths"]


def test_sheath_checkpoint_migrations_split_stacked_v(tmp_path):
    """A sheath_dd checkpoint in the older layout (one (n, 3) ``.v`` leaf in
    place of ``.u``, ``.vy``, ``.vz``) restores through the sheath
    engine's CHECKPOINT_MIGRATIONS, whose keys are JAX's; without them
    the unknown leaf is refused."""
    from pypic_tpu.engines import sheath as jsheath

    from pypic_tpu_torch.engines import sheath

    st0 = presets.sheath_dd(n=600, device="cpu").state
    paths, leaves = checkpoint._flatten_with_paths(st0)
    arrays = dict(zip(paths, checkpoint._to_host(leaves)))
    old = {p: a for p, a in arrays.items() if p not in (".u", ".vy", ".vz")}
    old[".v"] = np.stack([arrays[".u"], arrays[".vy"], arrays[".vz"]], -1)
    path = str(tmp_path / "old_sheath.npz")
    checkpoint._write_npz(path, list(old), list(old.values()), 0, None)
    template = presets.sheath_dd(n=600, seed=4, device="cpu").state
    with pytest.raises(ValueError, match="not in the template"):
        checkpoint.load(path, template)
    st, _ = checkpoint.load(path, template,
                            migrate=sheath.CHECKPOINT_MIGRATIONS)
    for k in ("u", "vy", "vz", "p", "active"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), arrays["." + k])
    assert set(sheath.CHECKPOINT_MIGRATIONS) == set(jsheath.CHECKPOINT_MIGRATIONS)
