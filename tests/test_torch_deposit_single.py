"""Row 4 (the single deposit, its histogram form and the deterministic
deposit) and row 20 (the source batch), on the CPU.

``cuda_cic.deposit_launch_shape(n, ng, False, sms, hists=1)`` fixes the
single deposit's grid on the card: wide from 4 x 1,024 x SMs rows (one
1,024-thread block an SM over a contiguous range, lane columns halved
until shared memory holds them, capped by the wrapper's ``cols``), the
first port's grid below. ``cuda_sheath.launch_shape(n, ng, sms,
field=False)`` fixes the deterministic deposit's. Both must cover every
row once and raise above their ceilings. The port's ``histogram_add`` and
``iead_update`` (plain versions: the tensors lie on the CPU) must equal the
JAX package's exactly at the IEAD's shape (integer counts sum exactly in
float32); the carrier's bounded deposit with dead slots agrees with JAX's
at the float32 tolerance of tests/test_torch_kernels.py (2e-5 of the
largest node); the source batch's outputs are contiguous rows equal to the
plain version's at a ragged n; the split tool's cuts apply to the
kernel sources; and ``tools/sheath.py composed_exits`` replays saved
states of the composed sheath loop to the passes their run took.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.ops import cic as jcic

from pypic_tpu_torch import presets
from pypic_tpu_torch.engines import magnetized
from pypic_tpu_torch.ops import _build, cic, cuda_cic, cuda_rng, cuda_sheath
from pypic_tpu_torch.runner import run
from pypic_tpu_torch.tools import magnetized as mrow
from pypic_tpu_torch.tools import resident_split

WIDE_FROM = 4 * 1024 * 132  # 540,672 rows on an H100 SXM
NS = (1, 50_000, WIDE_FROM - 1, WIDE_FROM, 999_996, 1_000_003)
CEILING = cuda_cic.SMEM_LIMIT // 4  # one column of one histogram: 58,112
NGS = (200, 227, 3200, CEILING)
SMS = (132, 114)  # H100 SXM, H100 PCIe
IEAD_BINS = 2 * 40 * 40


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("ng", NGS)
@pytest.mark.parametrize("n", NS)
def test_single_launch_shape_covers_the_rows_once(n, ng, sms):
    shape = cuda_cic.deposit_launch_shape(n, ng, False, sms, hists=1)
    block = cuda_cic.deposit_row_blocks(n, ng, False, sms, hists=1)
    assert block.shape == (n,)
    assert block.min() >= 0 and block.max() < shape.blocks
    counts = np.bincount(block, minlength=shape.blocks)
    assert (counts > 0).all()  # every block gets rows
    if n >= 4 * 1024 * sms:  # wide: one block an SM, contiguous, in order
        assert (shape.rows, shape.blocks, shape.threads) == (4, sms, 1024)
        assert (np.diff(block) >= 0).all()
        assert np.flatnonzero(np.diff(block)).size == sms - 1
        assert counts.min() >= 4 * shape.threads
    else:  # narrow: the first port's grid
        assert (shape.rows, shape.threads, shape.cols) == (1, 256, 1)
        assert shape.blocks <= 8 * sms
    assert shape.smem == 4 * shape.cols * ng <= cuda_cic.SMEM_LIMIT
    assert shape == cuda_cic.deposit_launch_shape(n, ng, False, sms, hists=1)


def test_single_columns_halve_until_they_fit():
    """32 lane columns where they fit (ng 200, 227: 25.6 and 29.1 KB), 16
    at the IEAD's 3,200 bins (204.8 KB), 1 at the ceiling; ``max_cols``
    (the wrapper's ``cols``, ``histogram_add``'s 1) caps them; one node
    above the ceiling is the large mode (cols 0, no shared memory), and
    the raise is above LARGE_MAX_NG."""
    cols = {ng: cuda_cic.deposit_launch_shape(999_996, ng, False, 132, hists=1).cols
            for ng in NGS}
    assert cols == {200: 32, 227: 32, 3200: 16, CEILING: 1}
    for cap in (1, 2, 4, 8, 16):
        assert cuda_cic.deposit_launch_shape(999_996, 3200, False, 132, hists=1,
                                             max_cols=cap).cols == cap
    assert cic.HISTOGRAM_COLS == 1
    above = cuda_cic.deposit_launch_shape(999_996, CEILING + 1, False, 132, hists=1)
    assert (above.cols, above.smem) == (0, 0)
    with pytest.raises(ValueError, match="LARGE_MAX_NG"):
        cuda_cic.deposit_launch_shape(999_996, cuda_cic.LARGE_MAX_NG + 1, False, 132,
                                      hists=1)
    with pytest.raises(ValueError, match="max_cols"):
        cuda_cic.deposit_launch_shape(999_996, 3200, False, 132, hists=1, max_cols=3)
    with pytest.raises(ValueError, match="histograms"):
        cuda_cic.deposit_launch_shape(999_996, 3200, True, 132, hists=1)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("ng", (51, 128, 1815))
@pytest.mark.parametrize("n", (1, 1_000_000, 1_000_003))
def test_det_launch_shape_covers_the_rows_once(n, ng, sms):
    """The deterministic deposit's grid: the sheath pass's without the
    field, contiguous ranges of a multiple of 4 rows, power-of-two blocks
    whose columns fit beside det_flush's 16 static bytes; ng = 1,815 is
    the columns' ceiling (32 columns), and one node more is the large mode
    (int64 sums, no shared memory)."""
    shape = cuda_sheath.launch_shape(n, ng, sms, field=False)
    r = shape.rows_per_block
    assert r % 4 == 0 and (shape.blocks - 1) * r < n <= shape.blocks * r
    assert shape.threads & (shape.threads - 1) == 0 and 32 <= shape.threads <= 1024
    assert shape.smem == shape.threads * ng * 4
    assert shape.smem + cuda_sheath.SMALL_STATIC_BYTES <= cuda_cic.SMEM_LIMIT
    assert shape.blocks <= cuda_sheath.MAX_BLOCKS_PER_SM * sms
    if (n, ng, sms) == (1_000_000, 51, 132):  # the composed sheath current
        assert (shape.blocks, shape.threads) == (264, 512)
    assert not shape.large
    above = cuda_sheath.launch_shape(n, 1816, sms, field=False)
    assert above.large and above.smem == 0


def _iead_inputs(n, seed=5):
    """Impact velocities and masses of two species, a few impacts past the
    energy range, a hit on 1% of the rows."""
    rng = np.random.default_rng(seed)
    sp = rng.integers(0, 2, n).astype(np.int32)
    m = np.where(sp == 0, 3.34e-27, 1.8e-26).astype(np.float32)
    v = (rng.normal(size=(3, n)) * 4e4).astype(np.float32)
    v[0, :50] *= 30.0  # beyond energy_max
    hit = rng.uniform(size=n) < 0.01
    return sp, m, v, hit


def test_histogram_add_and_iead_update_equal_jax():
    """At 65,536 rows onto 3,200 bins with 0/1 weights: the port's
    histogram_add and iead_update (the plain deposit) equal JAX's
    (histogram_add through its Pallas deposit in interpret mode, and its
    default method), bit for bit."""
    n, ne, na = 65_536, 40, 40
    sp, m, v, hit = _iead_inputs(n)
    rng = np.random.default_rng(6)
    idx = rng.integers(0, IEAD_BINS, n).astype(np.int32)
    w = (rng.uniform(size=n) < 0.01).astype(np.float32)
    got = cic.histogram_add(torch.from_numpy(idx), torch.from_numpy(w), IEAD_BINS)
    for method in ("pallas", "auto"):
        ref = jcic.histogram_add(jnp.asarray(idx), jnp.asarray(w), IEAD_BINS,
                                 method=method)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    kw = dict(bins=(ne, na), energy_max=250.0, angle_max=90.0)
    iead0 = np.zeros((2, ne, na), np.float32)
    iead0[1, 3, 4] = 7.0
    ref = jmag.iead_update(jnp.asarray(iead0), jnp.asarray(sp), jnp.asarray(m),
                           *(jnp.asarray(c) for c in v), jnp.asarray(hit),
                           deposit_method="auto", allreduce=lambda x: x, **kw)
    got = magnetized.iead_update(torch.from_numpy(iead0), torch.from_numpy(sp),
                                 torch.from_numpy(m), *(torch.from_numpy(c) for c in v),
                                 torch.from_numpy(hit), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < float(got.sum()) - 7.0 < hit.sum()  # some impacts left out


def test_carrier_deposit_with_dead_slots_matches_jax():
    """The explicit carrier's rho deposit: positions on the extended slab
    (c = 200, halo 13: ext_n = 227, bounded), a twentieth of the rows dead
    slots of weight 0, against JAX's deposit (Pallas, interpret mode)
    within 2e-5 of the largest node."""
    n, ext_n = 20_000, 227
    rng = np.random.default_rng(8)
    p = rng.uniform(13.0, 213.0, n).astype(np.float32)
    p[:4] = [0.0, 226.0, 13.0, 212.999]
    w = np.full(n, 1.6e-9, np.float32)
    dead = rng.uniform(size=n) < 0.05
    w[dead] = 0.0
    got = cuda_cic.deposit(torch.from_numpy(p), torch.from_numpy(w), ext_n,
                           periodic=False)
    ref = np.asarray(jcic.deposit(jnp.asarray(p), jnp.asarray(w), ext_n,
                                  periodic=False, method="pallas"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5 * np.abs(ref).max())
    assert abs(float(got.double().sum()) - float(w.astype(np.float64).sum())) <= \
        1e-6 * float(w.sum())


def test_last_iead_traffic_is_the_last_steps_update():
    """tools/magnetized.py last_iead_traffic (the smoke's IEAD traffic):
    on pic_iead at n = 12,000 after 30 steps, its hits are the last step's
    n_hit_wall and its histogram is the last step's IEAD increment."""
    pre = presets.pic_iead(n_per_species=2000, device="cpu")
    cfg = pre.config
    step = magnetized.make_step(cfg)
    st, _ = run(step, pre.state, 29)
    before = st.iead.clone()
    st, m = run(step, st, 1)
    pos, weight, hit = mrow.last_iead_traffic(cfg, st)
    assert int(hit.sum()) == int(m.n_hit_wall[-1]) > 0
    assert pos.dtype == torch.float32 and float(pos.max()) < st.iead.numel()
    upd = cic.histogram_add(pos.to(torch.int64), weight, st.iead.numel())
    assert torch.equal(before + upd.reshape(before.shape), st.iead)


@pytest.mark.parametrize("n", (999_996, 1_000_003, 4097))
def test_source_batch_rows_are_contiguous_and_plain(n):
    """On the CPU the wrapper copies the plain batch into row-padded
    buffers (cuda_cic.padded_rows): each output a contiguous (n,) view
    starting 16-B aligned, equal to source_batch_plain's."""
    key, step = (3, 11), 5
    kw = dict(x_mu=1.5e-3, x_sigma=2.5e-4, x_wrap=3e-3, vth=2.2e4, vx=1e3)
    before = cuda_cic.LAUNCHES["source_batch"]
    got = cuda_rng.source_batch(key, step, n, device="cpu", **kw)
    assert cuda_cic.LAUNCHES["source_batch"] == before
    ref = cuda_rng.source_batch_plain(key, step, n, device="cpu", **kw)
    for g, r in zip(got, ref):
        assert g.shape == (n,) and g.is_contiguous() and g.data_ptr() % 16 == 0
        assert torch.equal(g, r)


@pytest.mark.parametrize("kernel", ["deposit", "deposit_det", "source_batch"])
def test_split_cuts_apply_to_the_new_kernel_sources(kernel):
    """tools/resident_split.py --kernel deposit|deposit_det|source_batch
    cuts stages out of csrc/cic.cu and csrc/rng.cu (cic_common.cuh inlined)
    by text edits: each anchor stands in the source as often as the edit
    says, a changed source fails loudly, and the first port's edits do not
    apply to the current sources."""
    src_name, edits, first = (
        ("rng.cu", resident_split._SOURCE_EDITS, resident_split._SOURCE_FIRST_PORT_EDITS)
        if kernel == "source_batch" else
        ("cic.cu", resident_split._SINGLE_EDITS, resident_split._SINGLE_FIRST_PORT_EDITS))
    src = resident_split._inlined(_build.CSRC_DIR / src_name)
    cut = resident_split._edited(src, edits)
    assert cut.count("#define CUT 0") == 1 and "cic_common.cuh, inlined" in cut
    anchor = edits[1][0]
    with pytest.raises(RuntimeError, match="anchor"):
        resident_split._edited(src.replace(anchor, "x"), edits)
    with pytest.raises(RuntimeError, match="anchor"):
        resident_split._edited((_build.CSRC_DIR / src_name).read_text(), first)
    table = {"deposit": resident_split.SINGLE_CUTS,
             "deposit_det": resident_split.DET_CUTS,
             "source_batch": resident_split.SOURCE_CUTS}[kernel]
    assert table["(a) full"] == 0 and all(f"CUT == {c}" in cut
                                          for c in set(table.values()) - {0})


def test_sass_loop_counts_the_widest_backward_branch(monkeypatch):
    """resident_split._sass_loop on a cuobjdump listing: the loop is the
    span of the widest backward branch, the NOPs left out; the count's
    issue time is instructions x n over SMs x 4 x 32 lanes a clock."""
    import types

    listing = "\n".join([
        "\tFunction : _ZN3foo19source_batch_kernelILb0ELb1EEEv",
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;",
        "        /*0010*/                   IMAD R2, R1, R1, RZ ;",
        "        /*0020*/                   FADD R3, R2, R2 ;",
        "        /*0030*/                   @P0 BRA 0x10 ;",
        "        /*0040*/                   EXIT ;",
        "        /*0050*/                   NOP ;",
        "\t\t..........",
    ])
    monkeypatch.setattr(_build, "_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(resident_split.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=listing))
    loop = resident_split._sass_loop(_build.CSRC_DIR / "x.so", "source_batch_kernelILb0ELb1E")
    assert (loop["instructions"], loop["loop"]) == (5, 3)
    assert resident_split.sass_issue_ms(200.0, 1_000_000, 132, 1980.0) == pytest.approx(
        200.0 * 1e6 / (132 * 4 * 32 * 1.98e9) * 1e3)


def test_composed_exits_replay_the_saved_run(tmp_path):
    """tools/sheath.py composed_exits on the CPU at a small n: each saved
    state's replay stops at the pass the composed run took from it, by
    the test its residual meets, and the deterministic deposit of its
    starting current is within 2e-5 of a float64 deposit."""
    from pypic_tpu_torch.tools import sheath as row

    res = row.composed_exits(tmp_path, device="cpu", save=True, steps=3, n=4000)
    assert len(res["steps"]) == 3
    assert res["passes_sum"] == sum(r["passes"] for r in res["steps"])
    for r in res["steps"]:
        assert r["passes"] == r["run_passes"]
        assert len(r["residuals"]) == r["passes"]
        if r["exit"] == "tol":
            assert r["residual"] <= res["tol"]
        elif r["exit"] == "floor":
            assert r["residual"] > res["tol"]
        assert r["deposit_det_rel_err"] <= 2e-5
    again = row.composed_exits(tmp_path, device="cpu", n=4000)
    assert [r["passes"] for r in again["steps"]] == [r["passes"] for r in res["steps"]]
