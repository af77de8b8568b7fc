"""A float64 state's launches and refusals, on the CPU.

Rows 1-6 (``picard_iteration`` and its shared window, both finalizes,
``deposit``, ``gather``) have double kernels: ``sweep_launch`` and
``deposit_launch_shape`` take the element's bytes (``item=8``), and their
double arrays leave shared memory at half the float32 ceilings. Every
float32 launch stays the one the frozen tables of
``tests/test_torch_large_periodic.py`` hold. The sheath engine's
wrappers (its pass and finalize, ``deposit_det``, the re-injection and
``hash_batch``) take float64 on the card too, and so do the magnetized
engine's (rows 7-9 and the Newton solves, rows 22 and 23) and the
explicit engine's (rows 13 and 14, ``tests/test_torch_float64_explicit_launch.py``).
The other wrappers (the resident kernels and the slab engines', float32
in the JAX package) refuse a float64 tensor on the card with a
``NotImplementedError`` saying so; no CUDA tensor is made here: the
wrappers are handed stand-ins that carry a CUDA device and a dtype,
which is all they read before they refuse (or, where they take the
dtype, before their shapes, where the stand-ins raise).
"""

import numpy as np
import pytest
import torch

from pypic_tpu.ops.pallas_cic import _scalars

from pypic_tpu_torch.constants import E_CHARGE, M_ELECTRON
from pypic_tpu_torch.engines import explicit, implicit, magnetized, sheath
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import (_build, cic, cuda_cic, cuda_domain, cuda_newton,
                                 cuda_rng, cuda_sheath)
from pypic_tpu_torch.tools import headline

LIMIT = cuda_cic.SMEM_LIMIT
CUDA = torch.device("cuda", 0)
# the last node of the shared mode of each row's double kernel: its
# arrays of doubles (8 B a node each) and its static bytes within
# SMEM_LIMIT; the float32 kernels' ceilings are twice these
F64_CEILINGS = {"picard_iteration": 14_528, "picard_iteration_shared": 14_527,
                "picard_finalize_nodep": 29_056, "picard_finalize": 14_528,
                "gather": 29_056}
F32_CEILINGS = {"picard_iteration": 29_056, "picard_iteration_shared": 29_054,
                "picard_finalize_nodep": 58_112, "picard_finalize": 29_056,
                "gather": 58_112}


@pytest.mark.parametrize("kernel", sorted(F64_CEILINGS))
def test_double_sweeps_leave_shared_memory_at_half_the_nodes(kernel):
    """The double kernel's shared mode holds its arrays of doubles: to the
    ceiling, then the global mode on the same grid; the float32 launch at
    the same sizes is the one it was (its own, twice as high, ceiling)."""
    arrays, static = cuda_cic.SWEEP_KERNELS[kernel]
    top = F64_CEILINGS[kernel]
    assert top == (LIMIT - static) // (8 * arrays)
    for ng in (2, 200, top - 1, top, top + 1, F32_CEILINGS[kernel], 65_536):
        got = cuda_cic.sweep_launch(kernel, 100_007_936, ng, 132, item=8)
        f32 = cuda_cic.sweep_launch(kernel, 100_007_936, ng, 132)
        assert (got.blocks, got.threads) == (f32.blocks, f32.threads) == (1056, 256)
        if ng <= top:
            assert (got.mode, got.smem) == ("shared", 8 * arrays * ng), ng
        else:
            assert (got.mode, got.smem) == ("global", 0), ng
        f32_top = F32_CEILINGS[kernel]
        assert (f32.mode, f32.smem) == (("shared", 4 * arrays * ng) if ng <= f32_top
                                        else ("global", 0)), ng
    with pytest.raises(ValueError, match="LARGE_MAX_NG"):
        cuda_cic.sweep_launch(kernel, 1000, cuda_cic.LARGE_MAX_NG + 1, 132, item=8)


@pytest.mark.parametrize("n", [1_000, 540_671, 540_672, 100_007_936])
def test_double_deposit_shape(n):
    """The single deposit's double kernel: the float32 grid (wide from
    4 x 1,024 x 132 rows, narrow below), lane columns of 8 B halved until
    a block holds them, one column to 29,056 nodes, the global mode (cols
    0) above it; at ng = 200 the float32 grid's 32 columns."""
    wide = n >= 4 * 1024 * 132
    for ng, cols in ((200, 32 if wide else 1), (908, 32 if wide else 1),
                     (909, 16 if wide else 1), (29_056, 1), (29_057, 0),
                     (65_536, 0)):
        got = cuda_cic.deposit_launch_shape(n, ng, False, 132, hists=1, item=8)
        f32 = cuda_cic.deposit_launch_shape(n, ng, False, 132, hists=1)
        assert (got.rows, got.blocks, got.threads) == (f32.rows, f32.blocks, f32.threads)
        assert got.cols == cols, ng
        assert got.smem == 8 * cols * ng
        assert got.mode == ("shared" if cols else "global")
    # the double deposit2 and carried deposit take item 8 too, at their own
    # ceilings (tests/test_torch_float64_magnetized_launch.py); other items
    # raise
    assert cuda_cic.deposit_launch_shape(n, 200, True, 132, item=8).mode == "shared"
    with pytest.raises(ValueError, match="item"):
        cuda_cic.deposit_launch_shape(n, 200, False, 132, hists=1, item=2)


def test_double_instantiations_in_the_report():
    """check_f64_kernels finds each float64 template's double
    instantiation by its mangled name (type argument 'd') and names the
    missing ones; the float ones ('f') do not count."""
    def entry(name, args):
        targs = "".join(f"Li{a}E" if isinstance(a, int) else a for a in args)
        mangled = f"_ZN12_GLOBAL__N_1{len(name)}{name}I{targs}EEvPKT_"
        return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
                "ptxas info    : Used 32 registers, used 1 barriers, 400 bytes cmem[0]")
    ints = {"picard_iteration_kernel": [0, 0, 0], "picard_finalize_kernel": [0, 0],
            "deposit_kernel": [1, 4, 1], "deposit_global_kernel": [1, 4, 1],
            "gather_kernel": [1, 0], "sheath_pass_kernel": [0, 1],
            "sheath_large_kernel": [0, 1, 1, 0], "deposit_det_kernel": [0, 1],
            "deposit_det_large_kernel": [0, 1, 0], "sheath_reinject_kernel": [5],
            "hash_batch_kernel": [1], "deposit2_kernel": [1, 4, 1],
            "deposit2_global_kernel": [1, 4, 1], "boris_kernel": [1, 0],
            "boris_deposit_kernel": [1, 4, 1], "boris_deposit_global_kernel": [1, 4, 1, 1],
            "newton_dd_kernel": [], "newton_dn_kernel": [], "newton_dd_large_kernel": [],
            "newton_dn_large_kernel": [], "leapfrog_deposit_kernel": [1],
            "explicit_cycle_kernel": []}
    full = "\n".join(entry(k, ints[k] + [t]) for k, _ in cuda_cic.F64_INSTANCES
                     for t in "fd")
    assert cuda_cic.check_f64_kernels(full) == []
    only_f = "\n".join(entry(k, ints[k] + ["f"]) for k, _ in cuda_cic.F64_INSTANCES)
    bad = cuda_cic.check_f64_kernels(only_f)
    assert len(bad) == len(cuda_cic.F64_INSTANCES)
    assert _build._kernel_of(
        "_ZN12_GLOBAL__N_123picard_iteration_kernelILb1ELb0ELi1EdEEvPKT2_"
    ) == ("picard_iteration_kernel", (1, 0, 1, "d"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_scalars_round_as_jax(dtype):
    """kernel_scalars in the state's dtype are JAX's _scalars of the same
    q/m (pallas_cic.py:1826) bit for bit, float32 and float64."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    qm = np_dtype(-E_CHARGE) / np_dtype(M_ELECTRON)
    w = np_dtype(-E_CHARGE) * np_dtype(3.7e4 / 0.05)
    import jax.numpy as jnp
    ref = np.asarray(_scalars(jnp.asarray(qm), 1e-7, 0.05, jnp.asarray(w), np_dtype)).ravel()
    got = cuda_cic.kernel_scalars(float(qm), 1e-7, 0.05, float(w), dtype)
    np.testing.assert_array_equal(np.asarray(got, np_dtype), ref)
    assert cuda_cic._inv(200, dtype) == float(np_dtype(1.0) / np_dtype(200))


class _Reached(Exception):
    """Raised by a stand-in once a wrapper reads past its dtype check."""


class _OnTheCard:
    """A stand-in for a (n,) CUDA tensor of ``dtype``: the wrappers read
    its device and dtype first and refuse before anything else; a wrapper
    that takes the dtype goes on to its shape (``dim``), which raises
    ``_Reached``."""

    device = CUDA

    def __init__(self, dtype=torch.float64):
        self.dtype = dtype

    def dim(self):
        raise _Reached


def _t(dtype=torch.float64):
    return _OnTheCard(dtype)


# each wrapper without a double kernel, called on float64 stand-ins
REFUSING = {
    "explicit_cycle_resident": lambda: cuda_cic.explicit_cycle_resident(
        _t(), _t(), _t(), 16, 2, qm=1.0, w=1.0, ke_c=1.0, jb_c=1.0, dt=1.0, dx=1.0,
        fe_c=1.0),
    "implicit_resident": lambda: cuda_cic.implicit_resident(
        _t(), _t(), _t(), _t(), _t(), 16, 2, qm=1.0, w=1.0, ke_c=1.0, dt=1.0, dx=1.0,
        tol=0.0, maxiter=4, extrapolate=False, anderson=False, fe_c=1.0, tracer=0),
    "picard_iteration_ext": lambda: cuda_domain.picard_iteration_ext(
        _t(), _t(), _t(), _t(), _t(), qm=1.0, dt=1.0, dx=1.0, lo=0.0, hi=1.0),
    "picard_finalize_ext": lambda: cuda_domain.picard_finalize_ext(
        _t(), _t(), _t(), _t(), _t(), qm=1.0, dt=1.0, dx=1.0, lo=0.0, hi=1.0,
        lo_shift=0.0, ng=16),
    "leapfrog_gather_push": lambda: cuda_domain.leapfrog_gather_push(
        _t(), _t(), _t(), qm=1.0, dt=1.0, dx=1.0),
    "explicit_domain_cycle": lambda: cuda_domain.explicit_domain_cycle(
        _t(), _t(), _t(), _t(), qm=1.0, dt=1.0, dx=1.0, lo_shifted=0.0, ext_n=16),
}


@pytest.mark.parametrize("name", sorted(REFUSING))
def test_float64_on_the_card_without_a_kernel_names_its_item(name):
    """A float64 tensor on the card, in a wrapper with no double kernel:
    NotImplementedError naming it no gap (the JAX package runs the path
    in float32 only; ROADMAP item 19), never a TypeError or a CPU
    detour."""
    assert name in cuda_cic.F64_ITEMS and name not in cuda_cic.F64_KERNELS
    with pytest.raises(NotImplementedError, match=r"item 19") as err:
        REFUSING[name]()
    assert cuda_cic.F64_ITEMS[name] in str(err.value)


# the sheath engine's wrappers with a double kernel (ROADMAP item 19a),
# called on stand-ins
SHEATH_SLICE = {
    "deposit_det": lambda dt: cuda_cic.deposit_det(_t(dt), _t(dt), 16, periodic=False),
    "sheath pass": lambda dt: cuda_sheath.sheath_picard(
        *[_t(dt)] * 7, dt=1.0, dx=1.0),
    "sheath_finalize": lambda dt: cuda_sheath.sheath_finalize(
        *[_t(dt)] * 7, dt=1.0, dx=1.0),
    "sheath_reinject": lambda dt: cuda_rng.sheath_reinject(
        (0, 1), 0, *[_t(dt)] * 6, cells=16.0),
    "hash_batch": lambda dt: cuda_rng.hash_batch(1, 16, 2, normals=True, device=CUDA,
                                                 dtype=dt),
}


@pytest.mark.parametrize("name", sorted(SHEATH_SLICE))
def test_sheath_slice_takes_float64_on_the_card(name, monkeypatch):
    """The sheath engine's wrappers with a double kernel: a float64 call on
    the card passes the dtype check and goes on to its shapes (the
    stand-ins raise there) or its launch (``hash_batch``: the library,
    stubbed to raise), as a float32 one does; float16 raises TypeError."""
    def library():
        raise _Reached
    monkeypatch.setattr(_build, "library", library)
    for dtype in (torch.float64, torch.float32):
        with pytest.raises(_Reached):
            SHEATH_SLICE[name](dtype)
    with pytest.raises(TypeError, match="float32 or float64"):
        SHEATH_SLICE[name](torch.float16)


@pytest.mark.parametrize("name", cuda_cic.F64_KERNELS)
def test_rows_1_to_6_take_float64_on_the_card(name):
    """The wrappers with a double kernel (rows 1-6 and the sheath slice's)
    pass the dtype check on the card (and float32 everywhere); float16
    raises on either device."""
    cuda_cic.check_dtype(name, CUDA, torch.float64)
    cuda_cic.check_dtype(name, CUDA, torch.float32)
    cuda_cic.check_dtype(name, torch.device("cpu"), torch.float64)
    for dev in (CUDA, torch.device("cpu")):
        with pytest.raises(TypeError, match="float32 or float64"):
            cuda_cic.check_dtype(name, dev, torch.float16)


def test_wrappers_refuse_mixed_dtypes_and_the_newton_kernels_float64():
    """One dtype a call (a float32 field with float64 particles is a
    TypeError); the chain solve takes float32 alone on either device (the
    slab engines are float32 in JAX), while the Newton wrappers take
    float64 (their plain versions here, their double kernels on the
    card) and keep it."""
    z32, z64 = torch.zeros(16), torch.zeros(16, dtype=torch.float64)
    with pytest.raises(TypeError, match="different dtypes"):
        cuda_cic.gather(z32, z64, periodic=True)
    assert cuda_cic.F32_ONLY == ("tridiag3_chain",)
    for dev in (torch.device("cpu"), CUDA):
        with pytest.raises(TypeError, match="float32 tensors"):
            cuda_cic.check_dtype("tridiag3_chain", dev, torch.float64)
    with pytest.raises(TypeError, match="float32 tensors"):
        cuda_newton.tridiag3_chain(z64, z64, z64, z64, first=True, last=True)
    res = cuda_newton.boltzmann_dirichlet(z64, 1e17, 1e4, 1e-5)
    assert res.phi.dtype == res.residual.dtype == torch.float64
    with pytest.raises(TypeError, match="different dtypes"):
        cuda_newton.boltzmann_dirichlet(z64, 1e17, 1e4, 1e-5, phi0=z32)


@pytest.mark.parametrize("engine", ["explicit", "implicit", "magnetized", "sheath"])
def test_engines_with_double_kernels_take_a_card_state(engine):
    """The engines with double kernels (rows 1-6: implicit; item 19a:
    sheath; item 19b: magnetized; item 19c: explicit) take a float64
    state on the card and on the CPU; float16 raises TypeError on the
    card. No engine is left that refuses one."""
    assert not hasattr(cuda_cic, "F64_ENGINE_ITEMS")
    for dev in (CUDA, torch.device("cpu")):
        cuda_cic.check_engine_dtype(engine, dev, torch.float64)
        cuda_cic.check_engine_dtype(engine, dev, torch.float32)
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_cic.check_engine_dtype(engine, CUDA, torch.float16)


# the magnetized engine's wrappers with a double kernel (ROADMAP item 19b:
# rows 7-9, 22 and 23), called on stand-ins
MAGNETIZED_SLICE = {
    "deposit2": lambda dt: cuda_cic.deposit2(_t(dt), _t(dt), _t(dt), 16, periodic=False),
    "boris_gather_push": lambda dt: cuda_cic.boris_gather_push(
        *[_t(dt)] * 7, b=(0.0, 1.0, 0.0), dt_dx=1.0),
    "boris_gather_push_deposit": lambda dt: cuda_cic.boris_gather_push_deposit(
        *[_t(dt)] * 9, b=(0.0, 1.0, 0.0), dt_dx=1.0),
    "boltzmann_dirichlet": lambda dt: cuda_newton.boltzmann_dirichlet(
        _t(dt), 1e17, 1e4, 1e-5, phi0=_t(dt)),
    "boltzmann_dn": lambda dt: cuda_newton.boltzmann_dn(_t(dt), 1e17, 1e4, 1e-5, _t(dt)),
}


@pytest.mark.parametrize("name", sorted(MAGNETIZED_SLICE))
def test_magnetized_slice_takes_float64_on_the_card(name):
    """The magnetized engine's wrappers with a double kernel: a float64
    call on the card passes the dtype check and goes on to its shapes
    (the stand-ins raise there), as a float32 one does; float16 raises
    TypeError; the wrapper is in F64_KERNELS and has no refusal item."""
    assert name in cuda_cic.F64_KERNELS and name not in cuda_cic.F64_ITEMS
    for dtype in (torch.float64, torch.float32):
        with pytest.raises(_Reached):
            MAGNETIZED_SLICE[name](dtype)
    with pytest.raises(TypeError, match="float32 or float64"):
        MAGNETIZED_SLICE[name](torch.float16)


def test_explicit_engine_refuses_at_init_and_step():
    """init_state checks the dtype before it builds anything, and a step
    checks the state it is given: the explicit engine takes a float64
    state on the card (ROADMAP item 19c; init_state goes past its dtype
    check to the load, a stand-in that raises there) and on the CPU, and
    refuses float16 on the card."""
    grid = GridSpec(16, 1.0, "periodic")
    cfg = explicit.ExplicitConfig(grid, 1e-9, 1.0)
    x, v = np.linspace(0.0, 0.9, 64), np.zeros(64)

    class _Rows:
        """A sequence of rows whose length raises: the load."""

        def __len__(self):
            raise _Reached

        def __getitem__(self, i):
            raise _Reached

    with pytest.raises(_Reached):
        explicit.init_state(_Rows(), v, -E_CHARGE, M_ELECTRON, cfg,
                            dtype=torch.float64, device=CUDA)
    with pytest.raises(TypeError, match="float32 or float64"):
        explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, dtype=torch.float16,
                            device=CUDA)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, dtype=torch.float64,
                             device="cpu")
    st1, _ = explicit.make_step(cfg)(st)
    assert st1.p.dtype == st1.e.dtype == st1.rho.dtype == torch.float64
    mcfg = magnetized.MagnetizedConfig(GridSpec(16, 1e-4, "dirichlet-dirichlet"),
                                       1e-10, 1e4, (0.0, 1.0, 0.0), (1,))

    class _Load:
        def __array__(self, *args, **kwargs):
            raise _Reached

    # the magnetized engine takes a float64 state on the card (ROADMAP item
    # 19b): init_state goes past its dtype check to the load
    with pytest.raises(_Reached):
        magnetized.init_state(_Load(), np.zeros((64, 3)), M_ELECTRON, 1.0, 1.0, 0,
                              mcfg, dtype=torch.float64, device=CUDA)
    mst = magnetized.init_state(x * 1e-4, np.zeros((64, 3)), M_ELECTRON, 1.0, 1.0, 0,
                                mcfg, dtype=torch.float64, device="cpu")
    assert mst.p.dtype == mst.phi.dtype == torch.float64
    # the sheath engine takes a float64 state on the card (ROADMAP item
    # 19a): init_state goes past its dtype check to the load (a stand-in
    # that raises there), and runs the same state on the CPU
    scfg = sheath.SheathConfig(GridSpec(11, 1e-4, "dirichlet-dirichlet"), 1e-10, 1e10,
                               1e-18, 1e-18)
    with pytest.raises(_Reached):
        sheath.init_state(_Load(), np.zeros((4, 3)), np.ones(4), np.ones(4),
                          np.ones(4, np.int32), scfg, dtype=torch.float64, device=CUDA)
    st = sheath.init_state(np.full(4, 1e-5), np.zeros((4, 3)), np.ones(4), np.ones(4),
                           np.ones(4, np.int32), scfg, dtype=torch.float64, device="cpu")
    assert st.p.dtype == st.j.dtype == torch.float64


def test_run_resident_takes_float32_only():
    """As the JAX engine's (whose scan carry is float32): a float64 state
    raises NotImplementedError on either device, naming it no gap."""
    grid = GridSpec(16, 1.0, "periodic")
    cfg = implicit.ImplicitConfig(grid, 1e-9, 1.0)
    st = implicit.init_state(np.linspace(0.0, 0.9, 64), np.zeros(64), -E_CHARGE,
                             M_ELECTRON, cfg, dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="float32 state only") as err:
        implicit.run_resident(cfg, st, 2)
    assert "no gap" in str(err.value)
    with pytest.raises(NotImplementedError, match="float32 state only"):
        implicit.check_resident_supported(cfg, st)


def test_explicit_run_resident_takes_float32_only():
    """Fault 8: JAX's explicit run_resident raises a TypeError on a
    float64 state (its resident scan carries float32; it raises while
    tracing), and the port's refuses the same state with a
    NotImplementedError naming it no gap, on the CPU and on the card
    (a state whose positions stand in for a card tensor), before it
    launches anything; a float32 state runs."""
    import jax.numpy as jnp

    from pypic_tpu.engines import explicit as jexplicit
    from pypic_tpu.grid import GridSpec as JGridSpec

    x, v = np.linspace(0.0, 0.9, 64), np.linspace(-1.0, 1.0, 64)
    jcfg = jexplicit.ExplicitConfig(JGridSpec(16, 1.0, "periodic"), 1e-9, 1.0)
    jst = jexplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg, dtype=jnp.float64)
    assert jst.p.dtype == jnp.float64
    with pytest.raises(TypeError, match="carry"):
        jexplicit.run_resident(jcfg, jst, 2)
    cfg = explicit.ExplicitConfig(GridSpec(16, 1.0, "periodic"), 1e-9, 1.0)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, dtype=torch.float64,
                             device="cpu")
    before = dict(cuda_cic.LAUNCHES)
    for state in (st, st.replace(p=_t())):
        with pytest.raises(NotImplementedError, match="float32 state only") as err:
            explicit.run_resident(cfg, state, 2)
        assert "no gap" in str(err.value)
        assert cuda_cic.F64_ITEMS["explicit_cycle_resident"] in str(err.value)
    assert cuda_cic.LAUNCHES == before
    st32 = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device="cpu")
    fin, m = explicit.run_resident(cfg, st32, 2)
    assert fin.p.dtype == torch.float32 and m.field_energy.shape == (2,)


def test_cic_ops_keep_the_dtype():
    """ops.cic's deposit, gather and histogram route a float64 tensor on
    the CPU to the plain versions, in float64; deposit_det's plain
    version too."""
    p = torch.tensor([0.25, 3.5, 15.9], dtype=torch.float64)
    vals = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    for method in cic.DEPOSIT_METHODS:
        out = cic.deposit(p, vals, 16, periodic=True, method=method)
        assert out.dtype == torch.float64
        np.testing.assert_allclose(float(out.sum()), -0.5, rtol=0, atol=1e-15)
    assert cic.gather(out, p, periodic=True).dtype == torch.float64


def test_headline_tool_takes_dtype_and_a_tolerance_exit():
    """tools/headline.py: --dtype for drift and profile, --tol and
    --maxiter for drift; the float64 cell starts from the float32 load
    cast before x / dx."""
    args = headline.parser().parse_args(
        ["drift", "--dtype", "float64", "--tol", "1e-13", "--maxiter", "20"])
    assert (args.dtype, args.tol, args.maxiter) == ("float64", 1e-13, 20)
    assert headline.parser().parse_args(["drift"]).tol is None
    assert headline.parser().parse_args(
        ["profile", "--out", "x", "--dtype", "float64"]).dtype == "float64"
    cfg, step, st = headline.headline_state(2048, "cpu", dtype=torch.float64,
                                            tol=1e-13, maxiter=20)
    assert (cfg.tol, cfg.maxiter, cfg.picard_accel) == (1e-13, 20, "anderson")
    c32, _, s32 = headline.headline_state(2048, "cpu")
    x, _ = headline.device_load(2048, c32.grid.length, "cpu")
    assert st.p.dtype == torch.float64 and s32.p.dtype == torch.float32
    np.testing.assert_array_equal(st.p.numpy(), x.double().numpy() / cfg.grid.dx)
    st1, m = step(st)
    assert st1.e.dtype == torch.float64 and 1 <= int(m.picard_iters) <= 20
