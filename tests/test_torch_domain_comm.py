"""The port's slab communication (``pypic_tpu_torch.parallel.domain``)
against JAX's ``shard_map`` programs: ``halo_extend`` and ``halo_fold`` at
1, 2 and 4 gloo ranks against 1, 2 and 4 of conftest's 8 CPU devices, on
the ring and on the chain (JAX's ``ring_perms(periodic=False)``: zero
halos at the ends, also at one rank), and ``migrate`` (a multi-hop route,
tests/test_domain.py:267, and a bucket too small, whose drops are
counted; the bounded route on the chain, three slabs a hop at a time with
nothing wrapping) at 2 and 4: slot for slot equal, counts exact. The ranks run ``tests/_torch_ranks.py`` in processes of their own
(``parallel.spawn``, ``file://`` rendezvous under tmp_path); one spawn a
world size carries every check of that size.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from pypic_tpu.parallel import domain, make_mesh

from pypic_tpu_torch.parallel import mesh as tmesh, spawn
import _torch_ranks

NG, HW = 64, 3
CAP_MULTIHOP = 4


def _jax_halo(s, own, ext, periodic=True):
    c = NG // s
    perm_r, perm_l = domain.ring_perms(s, periodic)

    def f(o, e):
        return (domain.halo_extend(o, HW, "slabs", perm_r, perm_l),
                domain.halo_fold(e, c, HW, "slabs", perm_r, perm_l))

    out = jax.shard_map(f, mesh=make_mesh(s, axis="slabs"),
                        in_specs=(P("slabs"), P("slabs")),
                        out_specs=(P("slabs"), P("slabs")), check_vma=False)(
        jnp.asarray(own.reshape(-1)), jnp.asarray(ext.reshape(-1)))
    return [np.asarray(o).reshape(s, -1) for o in out]


def _jax_migrate(s, p, tags, alive, cap, periodic=True):
    c = NG // s

    def f(p, tags, alive):
        d = lax.axis_index("slabs")
        (p2, t2), alive2, n_mig, n_drop = domain.migrate(
            [p, tags], alive, d, ng=NG, cells_per_shard=c, num_shards=s,
            cap=cap, ax="slabs", periodic=periodic)
        return p2, t2, alive2, n_mig, n_drop

    out = jax.shard_map(
        f, mesh=make_mesh(s, axis="slabs"),
        in_specs=(P("slabs"),) * 3,
        out_specs=(P("slabs"),) * 3 + (P(), P()), check_vma=False)(
        *(jnp.asarray(a.reshape(-1)) for a in (p, tags, alive)))
    return ([np.asarray(o).reshape(s, -1) for o in out[:3]]
            + [int(out[3]), int(out[4])])


def _halo_inputs(s, seed):
    rng = np.random.default_rng(seed)
    c = NG // s
    own = rng.normal(size=(s, c)).astype(np.float32)
    ext = rng.normal(size=(s, c + 2 * HW + 1)).astype(np.float32)
    return own, ext


def _multihop_inputs(s):
    """Each shard sends particle i one to i + 1 slabs away (hops of 1 to
    s/2 each way, some multi-hop), a permutation per i, so no slot
    overflows (tests/test_domain.py:267)."""
    rng = np.random.default_rng(0)
    c = NG // s
    n_per = min(4, s)
    p = np.zeros((s, n_per), np.float32)
    tags = np.zeros((s, n_per), np.float32)
    for dd in range(s):
        for i in range(n_per):
            p[dd, i] = ((dd + i + 1) % s) * c + rng.uniform(0, c)
            tags[dd, i] = dd * n_per + i
    return p, tags, np.ones((s, n_per), bool)


def _overflow_inputs(s, n=96, cap=5):
    """Half the particles of each shard misrouted, a bucket of ``cap``:
    overflow dropped and counted; a quarter of the slots free."""
    rng = np.random.default_rng(1)
    p = rng.uniform(0, NG, (s, n)).astype(np.float32)
    c = NG // s
    home = (np.arange(s)[:, None] * c + rng.uniform(0, c, (s, n))).astype(np.float32)
    stay = rng.random((s, n)) < 0.5
    p = np.where(stay, home, p)
    alive = rng.random((s, n)) < 0.75
    p = np.where(alive, p, 0.0).astype(np.float32)
    tags = np.arange(s * n, dtype=np.float32).reshape(s, n)
    return p, tags, alive, cap


@pytest.fixture(scope="module", params=[1, 2, 4])
def world(request, tmp_path_factory):
    """One spawn of ``request.param`` gloo ranks with every check of that
    size, beside the JAX results on as many CPU devices."""
    s = request.param
    own, ext = _halo_inputs(s, seed=s)
    jobs = [("halo", dict(own=own, ext=ext, hw=HW))]
    refs = {"halo": _jax_halo(s, own, ext)}
    mh = _multihop_inputs(s)
    ov = _overflow_inputs(s)
    jobs += [("migrate", dict(p=mh[0], tags=mh[1], alive=mh[2], ng=NG,
                              cap=CAP_MULTIHOP)),
             ("migrate", dict(p=ov[0], tags=ov[1], alive=ov[2], ng=NG,
                              cap=ov[3]))]
    refs["multihop"] = _jax_migrate(s, *mh, CAP_MULTIHOP)
    refs["overflow"] = _jax_migrate(s, *ov)
    # the chain: zero halos at its ends; the bounded route
    jobs += [("halo", dict(own=own, ext=ext, hw=HW, periodic=False)),
             ("migrate", dict(p=mh[0], tags=mh[1], alive=mh[2], ng=NG,
                              cap=CAP_MULTIHOP, periodic=False))]
    refs["chain_halo"] = _jax_halo(s, own, ext, periodic=False)
    refs["chain_multihop"] = _jax_migrate(s, *mh, CAP_MULTIHOP, periodic=False)
    got = spawn.run(s, _torch_ranks.batch, jobs, device="cpu",
                    tmp_dir=tmp_path_factory.mktemp(f"ranks{s}"))
    return s, refs, got


def _joined(got, job, part):
    return np.stack([rank[job][part] for rank in got])


def test_halo_extend_and_fold_match_shard_map(world):
    s, refs, got = world
    np.testing.assert_array_equal(_joined(got, 0, 0), refs["halo"][0])
    np.testing.assert_array_equal(_joined(got, 0, 1), refs["halo"][1])


def test_migrate_multihop_matches_shard_map(world):
    s, refs, got = world
    ref = refs["multihop"]
    for part in range(3):
        np.testing.assert_array_equal(_joined(got, 1, part), ref[part])
    assert all(rank[1][3:] == (ref[3], ref[4]) for rank in got)
    # one shard: nothing to route, zero counts (domain.py:213-219)
    assert ref[4] == 0 and (ref[3] > 0) == (s > 1)
    c = NG // s
    p2, alive2 = _joined(got, 1, 0), _joined(got, 1, 2)
    owner = np.clip(np.floor(p2).astype(int), 0, NG - 1) // c
    assert (owner == np.arange(s)[:, None])[alive2].all()
    assert alive2.sum() == p2.size


def test_migrate_overflow_counted_matches_shard_map(world):
    s, refs, got = world
    ref = refs["overflow"]
    for part in range(3):
        np.testing.assert_array_equal(_joined(got, 2, part), ref[part])
    assert all(rank[2][3:] == (ref[3], ref[4]) for rank in got)
    assert (ref[4] > 0) == (s > 1)
    p, tags, alive, _ = _overflow_inputs(s)
    assert _joined(got, 2, 2).sum() == alive.sum() - ref[4]


def test_chain_halo_extend_and_fold_match_shard_map(world):
    """The chain's halos bit-equal to JAX's chain perms: the end ranks'
    outer halos are zeros (one rank: both), and what an end rank
    deposited past its wall is dropped."""
    s, refs, got = world
    ext_ref, fold_ref = refs["chain_halo"]
    np.testing.assert_array_equal(_joined(got, 3, 0), ext_ref)
    np.testing.assert_array_equal(_joined(got, 3, 1), fold_ref)
    assert (ext_ref[0, :HW] == 0).all() and (ext_ref[-1, -(HW + 1):] == 0).all()
    if s > 1:  # inside the chain the halos are the neighbours' nodes
        own, _ = _halo_inputs(s, seed=s)
        np.testing.assert_array_equal(ext_ref[1, :HW], own[0, -HW:])


def test_chain_migrate_multihop_matches_shard_map(world):
    """The bounded route (dest > d right, dest < d left; JAX's
    domain.py:253-256): fields and counts equal to JAX's, every particle
    on its owner, nothing crossing the wrap link; at 4 ranks the
    particles of slab 3 bound for slab 0 travel three slabs (and slots
    full in transit drop, counted, as in JAX)."""
    s, refs, got = world
    ref = refs["chain_multihop"]
    for part in range(3):
        np.testing.assert_array_equal(_joined(got, 4, part), ref[part])
    assert all(rank[4][3:] == (ref[3], ref[4]) for rank in got)
    c = NG // s
    p2, alive2 = _joined(got, 4, 0), _joined(got, 4, 2)
    owner = np.clip(np.floor(p2).astype(int), 0, NG - 1) // c
    assert (owner == np.arange(s)[:, None])[alive2].all()
    # slots full in transit drop (counted), as in JAX: nothing else is lost
    assert alive2.sum() == p2.size - ref[4]
    assert (ref[3] > 0) == (s > 1)


def test_one_rank_chain_exchange_gives_zeros():
    """One rank on a chain receives zeros on both sides, never its own
    tensors (those would fold the right wall onto the left)."""
    mesh = tmesh.make_mesh(device="cpu")
    a, b = torch.arange(1.0, 4.0), torch.arange(1.0, 5.0)
    fl, fr = mesh.ring_exchange(a, b, periodic=False)
    assert torch.equal(fl, torch.zeros(3)) and torch.equal(fr, torch.zeros(4))
    assert mesh.ring_exchange(None, b, periodic=False)[0] is None


def test_one_rank_mesh_is_local():
    """No process group: a one-rank mesh whose ring exchange hands the
    rank its own tensors and whose collectives are the identity; migrate
    runs no round and returns zero counts."""
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.staged_bytes) == (0, 1, 0)
    a, b = torch.arange(3.0), torch.arange(4.0)
    fl, fr = mesh.ring_exchange(a, b)
    assert fl is a and fr is b
    assert mesh.all_reduce_sum(a) is a and mesh.all_gather(b) is b
    p = torch.tensor([1.0, 50.0])
    out, alive, n_mig, n_drop = _torch_ranks.domain.migrate(
        [p], torch.ones(2, dtype=torch.bool), 0, ng=NG, cells_per_shard=NG,
        num_shards=1, cap=1, mesh=mesh)
    assert out[0] is p and int(n_mig) == int(n_drop) == 0


def test_make_mesh_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.make_mesh()
    assert tmesh.make_mesh(device="cpu").device.type == "cpu"


def test_bootstrap_reads_nothing_without_its_variables(monkeypatch):
    for k in ("PYPIC_COORDINATOR", "PYPIC_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.maybe_initialize_distributed() is False


@pytest.mark.parametrize("cap", [1, 7, 64])
def test_pack_and_place_rows_match_jax(cap):
    """``pack_rows`` and ``place_rows`` fill slot for slot as
    ``pypic_tpu.utils.packing`` does, with the same counts (a bucket that
    overflows, one that does not)."""
    from pypic_tpu.utils import pack_rows as jpack, place_rows as jplace

    from pypic_tpu_torch.utils import pack_rows, place_rows

    rng = np.random.default_rng(cap)
    n = 40
    mask = rng.random(n) < 0.4
    fields = [rng.normal(size=n).astype(np.float32),
              rng.normal(size=n).astype(np.float32)]
    ref = jpack(jnp.asarray(mask), [jnp.asarray(f) for f in fields], cap)
    got = pack_rows(torch.from_numpy(mask), [torch.from_numpy(f) for f in fields],
                    cap)
    for r, g in zip(ref[0], got[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (int(got[1]), int(got[2])) == (int(ref[1]), int(ref[2]))
    free = rng.random(n) < 0.3
    ref = jplace(jnp.asarray(free), [jnp.asarray(b) for b in ref[0]], ref[1],
                 [jnp.asarray(f) for f in fields])
    got = place_rows(torch.from_numpy(free), got[0], got[1],
                     [torch.from_numpy(f) for f in fields])
    for r, g in zip(ref[0], got[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(got[2]) == int(ref[2])
