"""The explicit engine's float64 state on the card (rows 13 and 14), on
the CPU: the wrappers' dtype dispatch, their double launch shapes and
entry points, and the dtype of the CPU route.

``explicit_cycle`` (row 13) and ``leapfrog_gather_push_deposit`` (row 14)
have double kernels: a float64 call on the card goes past the dtype check
to its shapes, where the stand-ins of ``tests/test_torch_float64_launch.py``
raise; no CUDA tensor is made here. Row 14's double arrays leave shared
memory at half the float32 ceiling (14,528 nodes, then the global mode);
row 13's three double arrays, its 256 B of scratch and its ticket's 16
static bytes hold at most 9,674 nodes (the engine calls it at ng <=
1,024). Rows 11 and 15 stay float32 in both packages: no gap.
"""

import numpy as np
import pytest
import torch

from pypic_tpu_torch.constants import E_CHARGE, M_ELECTRON
from pypic_tpu_torch.engines import explicit
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import _build, cuda_cic, cuda_domain
from pypic_tpu_torch.runner import run
from pypic_tpu_torch.tools import two_stream

from test_torch_float64_launch import _Reached, _t

LIMIT = cuda_cic.SMEM_LIMIT
ROW14 = "leapfrog_gather_push_deposit"
# the last node of each double kernel's shared mode, and of the float32 one
ROW14_F64_TOP, ROW14_F32_TOP = 14_528, 29_056
ROW13_F64_TOP, ROW13_F32_TOP = 9_674, 14_511

# the explicit engine's wrappers with a double kernel (ROADMAP item 19c),
# called on stand-ins
EXPLICIT_SLICE = {
    ROW14: lambda dt: cuda_cic.leapfrog_gather_push_deposit(
        _t(dt), _t(dt), _t(dt), qm=1.0, w=1.0, dt=1.0, dx=1.0),
    "explicit_cycle": lambda dt: cuda_cic.explicit_cycle(
        _t(dt), _t(dt), _t(dt), 16, qm=1.0, w=1.0, dt=1.0, dx=1.0),
}


@pytest.mark.parametrize("name", sorted(EXPLICIT_SLICE))
def test_explicit_slice_takes_float64_on_the_card(name):
    """Rows 13 and 14: a float64 call on the card passes the dtype check
    and goes on to its shapes (the stand-ins raise there), as a float32
    one does; float16 raises TypeError; the wrapper is in F64_KERNELS and
    has no refusal of its own."""
    assert name in cuda_cic.F64_KERNELS and name not in cuda_cic.F64_ITEMS
    for dtype in (torch.float64, torch.float32):
        with pytest.raises(_Reached):
            EXPLICIT_SLICE[name](dtype)
    with pytest.raises(TypeError, match="float32 or float64"):
        EXPLICIT_SLICE[name](torch.float16)


def _entry(name, args):
    targs = "".join(f"Li{a}E" if isinstance(a, int) else a for a in args)
    mangled = f"_ZN12_GLOBAL__N_1{len(name)}{name}I{targs}EEvPKT_"
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            "ptxas info    : Used 40 registers, used 1 barriers, 16 bytes smem")


def test_explicit_double_kernels_are_counted_and_reported():
    """Both wrappers count their double launches under ``<name>_f64``;
    check_f64_kernels looks for the double instantiations of
    leapfrog_deposit_kernel (both modes) and explicit_cycle_kernel in the
    compiler's report, and names them when they are missing."""
    for name in (ROW14, "explicit_cycle"):
        assert cuda_cic.LAUNCHES[f"{name}_f64"] == 0
    assert {("leapfrog_deposit_kernel", 1), ("explicit_cycle_kernel", 0)} <= set(
        cuda_cic.F64_INSTANCES)
    missing = cuda_cic.check_f64_kernels("")
    assert any(m.startswith("leapfrog_deposit_kernel:") for m in missing)
    assert any(m.startswith("explicit_cycle_kernel:") for m in missing)
    floats = "\n".join([_entry("leapfrog_deposit_kernel", [0, "f"]),
                        _entry("leapfrog_deposit_kernel", [1, "f"]),
                        _entry("explicit_cycle_kernel", ["f"])])
    bad = cuda_cic.check_f64_kernels(floats)
    assert {m.split(":")[0] for m in bad} >= {"leapfrog_deposit_kernel",
                                             "explicit_cycle_kernel"}
    doubles = floats + "\n" + "\n".join([_entry("leapfrog_deposit_kernel", [1, "d"]),
                                         _entry("explicit_cycle_kernel", ["d"])])
    bad = cuda_cic.check_f64_kernels(doubles)
    assert not any(m.split(":")[0] in ("leapfrog_deposit_kernel", "explicit_cycle_kernel")
                   for m in bad)
    # the double sweep's static bytes are held by check_static_smem beside
    # the float one's (its table entry takes every instantiation)
    assert cuda_cic.STATIC_SMEM_KERNELS[ROW14] == ("leapfrog_deposit_kernel", {})


@pytest.mark.parametrize("ng", [2, 200, 4096, ROW14_F64_TOP - 1, ROW14_F64_TOP,
                                ROW14_F64_TOP + 1, ROW14_F32_TOP, ROW14_F32_TOP + 1,
                                65_536])
def test_double_sweep_leaves_shared_memory_at_half_the_nodes(ng):
    """Row 14's double kernel keeps its field and histogram (2 ng doubles)
    in shared memory to 14,528 nodes, then takes the global mode; the
    float32 launch at the same sizes is the one it was (to 29,056); the
    grid is the same in both dtypes."""
    got = cuda_cic.sweep_launch(ROW14, 100_007_936, ng, 132, item=8)
    f32 = cuda_cic.sweep_launch(ROW14, 100_007_936, ng, 132)
    assert (got.blocks, got.threads) == (f32.blocks, f32.threads) == (1056, 256)
    assert (got.mode, got.smem) == (("shared", 16 * ng) if ng <= ROW14_F64_TOP
                                    else ("global", 0))
    assert (f32.mode, f32.smem) == (("shared", 8 * ng) if ng <= ROW14_F32_TOP
                                    else ("global", 0))
    assert ROW14_F64_TOP == LIMIT // 16 and ROW14_F32_TOP == LIMIT // 8


@pytest.mark.parametrize("item,top,node_bytes", [(8, ROW13_F64_TOP, 24),
                                                  (4, ROW13_F32_TOP, 16)])
def test_double_cycle_keeps_its_own_ceiling(item, top, node_bytes):
    """Row 13's shared memory, its ticket's 16 static bytes counted: the
    double kernel's three ng-double arrays and 256 B of scratch pass at
    9,674 nodes and raise above, naming the shared memory; the float32
    kernel's four ng-float arrays at 14,511 (Fault 9: the card refused
    14,512, which the check passed). The engine calls the cycle at ng <=
    1,024 only."""
    extra = cuda_cic._CYCLE_EXTRA + cuda_cic.STATIC_INT_BYTES
    cuda_cic.check_cycle_smem(top, item)
    with pytest.raises(ValueError, match="shared memory") as err:
        cuda_cic.check_cycle_smem(top + 1, item)
    assert f"ng <= {top}" in str(err.value)
    assert node_bytes * top + extra <= LIMIT < node_bytes * (top + 1) + extra
    assert explicit.ONE_KERNEL_MAX_NG == 1024 < top


def test_rows_11_and_15_are_no_gap():
    """The slab carrier's leapfrog_gather_push (row 11) and the resident
    explicit cycle (row 15) take float32 only in the JAX package: their
    float64 refusal on the card names no gap, not an item to come."""
    for name in ("leapfrog_gather_push", "explicit_cycle_resident"):
        assert cuda_cic.F64_ITEMS[name] == cuda_cic._F64_FLOAT32
        assert name not in cuda_cic.F64_KERNELS
    calls = {
        "leapfrog_gather_push": lambda: cuda_domain.leapfrog_gather_push(
            _t(), _t(), _t(), qm=1.0, dt=1.0, dx=1.0),
        "explicit_cycle_resident": lambda: cuda_cic.explicit_cycle_resident(
            _t(), _t(), _t(), 16, 2, qm=1.0, w=1.0, ke_c=1.0, jb_c=1.0, dt=1.0,
            dx=1.0, fe_c=1.0),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match="no gap"):
            call()
    assert not hasattr(cuda_cic, "_F64_EXPLICIT")


class _Entries:
    """A stand-in library whose every entry point is its own name."""

    def __getattr__(self, name):
        return name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wrapper,stem", [(ROW14, "leapfrog_deposit"),
                                          ("explicit_cycle", "explicit_cycle")])
def test_launcher_names_the_explicit_entry_points(wrapper, stem, dtype):
    """``_launcher`` forms each wrapper's entry point from its stem and the
    dtype, and the count from the wrapper's name and the dtype: both are
    the library's launchers and counts."""
    entry, count = cuda_cic._launcher(_Entries(), wrapper, dtype,
                                      entry=None if stem == wrapper else stem)
    f64 = dtype == torch.float64
    assert entry == f"pypic_{stem}" + ("_f64" if f64 else "")
    assert count == wrapper + ("_f64" if f64 else "")
    assert entry in _build._SIGNATURES and count in cuda_cic.LAUNCHES


@pytest.mark.parametrize("stem,scalars", [("leapfrog_deposit", range(8, 12)),
                                          ("explicit_cycle", range(9, 13))])
def test_double_launchers_take_double_scalars(stem, scalars):
    """Each ``_f64`` launcher has the float launcher's arguments with its
    state scalars (qmh, dt/dx, w, 1/ng) as c_double: a double through a
    c_float slot would round to float32 on the way. The cycle's solve
    coefficient is a double in both."""
    args, ret = _build._SIGNATURES[f"pypic_{stem}_f64"]
    fargs, fret = _build._SIGNATURES[f"pypic_{stem}"]
    assert ret == fret and len(args) == len(fargs)
    for i, (a, f) in enumerate(zip(args, fargs)):
        if i in scalars:
            assert (a, f) == (_build._D, _build._F), (stem, i)
        else:
            assert a == f, (stem, i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_wrappers_keep_the_state_dtype(dtype):
    """On CPU tensors both wrappers run their plain versions in the
    tensors' dtype: p1, v1, rho1 (and the cycle's e1) come back in it."""
    rng = np.random.default_rng(3)
    ng, n = 32, 500
    p = torch.from_numpy(rng.uniform(0, ng, n)).to(dtype)
    v = torch.from_numpy(rng.normal(size=n) * 1e5).to(dtype)
    e = torch.from_numpy(rng.normal(size=ng) * 1e3).to(dtype)
    kw = dict(qm=-1.7e11, w=-3.2e-9, dt=1e-7, dx=0.05)
    out = cuda_cic.leapfrog_gather_push_deposit(e, p, v, **kw)
    assert [t.dtype for t in out] == [dtype] * 3
    out = cuda_cic.explicit_cycle(e, p, v, ng, **kw)
    assert [t.dtype for t in out] == [dtype] * 4
    assert out[2].shape == out[3].shape == (ng,)


@pytest.mark.parametrize("ng,backend", [(64, "auto"), (2048, "auto"), (64, "composed")],
                         ids=["one-kernel", "two-stage", "composed"])
def test_cpu_route_keeps_the_state_dtype(ng, backend):
    """Each branch of the engine's step keeps a float64 state float64 on
    the CPU: its rho1 and e1 (and p, v) in the state's dtype, from the
    two-stream tool's float64 state (the float32 load cast before x / dx)."""
    cfg, _, st = two_stream.state(1024, "cpu", ng=ng, dtype=torch.float64,
                                  backend=backend)
    _, _, s32 = two_stream.state(1024, "cpu", ng=ng, backend=backend)
    assert st.p.dtype == torch.float64 and s32.p.dtype == torch.float32
    np.testing.assert_array_equal(st.v.numpy(), s32.v.double().numpy())
    fin, m = run(explicit.make_step(cfg), st, 2)
    assert {t.dtype for t in (fin.p, fin.v, fin.rho, fin.e, m.field_energy)} == {
        torch.float64}


def test_two_stream_tool_takes_a_dtype():
    """tools/two_stream.py --dtype float32|float64 (the smoke's phase 45
    loads its state from it); run_cell on the CPU keeps the dtype and
    counts no kernel launch there."""
    args = two_stream.parser().parse_args(["--dtype", "float64", "--n", "4096"])
    assert (args.dtype, args.n, args.ng) == ("float64", 4096, two_stream.NG)
    assert two_stream.parser().parse_args([]).dtype == "float32"
    res = two_stream.run_cell("cpu", 2048, steps=2, warmup=1, dtype=torch.float64)
    assert res["state_dtype"] == res["dtype"] == "float64"
    assert res["launches"] == {} and abs(res["total_energy_rel_change"]) < 1e-2


def test_explicit_float64_state_on_the_card_dispatch():
    """A step on a float64 card state (its positions, velocities and field
    stand in for card tensors) goes past the step's dtype check to the
    one-kernel cycle's shapes, where the stand-ins raise."""
    cfg = explicit.ExplicitConfig(GridSpec(16, 1.0, "periodic"), 1e-9, 1.0)
    st = explicit.init_state(np.linspace(0.0, 0.9, 64), np.zeros(64), -E_CHARGE,
                             M_ELECTRON, cfg, dtype=torch.float64, device="cpu")
    with pytest.raises(_Reached):
        explicit.make_step(cfg)(st.replace(p=_t(torch.float64), v=_t(torch.float64),
                                           e=_t(torch.float64)))


def test_sass_diff_matches_kernels_by_element_type(monkeypatch, tmp_path):
    """tools/sass_diff.py: a float kernel of the parent tree is held to
    this tree's float instantiation, and a double one to the double one,
    whatever namespace hash nvcc gave their mangled names; a template that
    gained its element type matches its float instantiation."""
    from pypic_tpu_torch.tools import sass_diff

    def mangled(ns, name, typ):
        return f"_ZN{len(ns)}{ns}{len(name)}{name}" + (f"I{typ}E" if typ else "") + "Ev"

    old = {mangled("_GLOBAL__N_a", "newton_dd_kernel", "f"): ["A", "B"],
           mangled("_GLOBAL__N_a", "newton_dd_kernel", "d"): ["C", "D", "E"],
           mangled("_GLOBAL__N_a", "explicit_cycle_kernel", None): ["F"]}
    new = {mangled("_GLOBAL__N_b", "newton_dd_kernel", "f"): ["A", "B"],
           mangled("_GLOBAL__N_b", "newton_dd_kernel", "d"): ["C", "D", "E"],
           mangled("_GLOBAL__N_b", "explicit_cycle_kernel", "f"): ["F"],
           mangled("_GLOBAL__N_b", "explicit_cycle_kernel", "d"): ["G", "H"]}

    def sass(src, workdir):
        return old if "parent" in str(src) else new

    monkeypatch.setattr(sass_diff, "sass", sass)
    monkeypatch.setattr(sass_diff, "SOURCES", ("x.cu",))
    res = sass_diff.compare(tmp_path / "parent")
    assert res["float"] == {"x.cu newton_dd_kernel[]": "identical (2 instructions)",
                            "x.cu explicit_cycle_kernel[]": "identical (1 instructions)"}
    assert res["double"]["x.cu newton_dd_kernel[]"]["parent"] == "identical (3 instructions)"
    assert res["double"]["x.cu explicit_cycle_kernel[]"]["parent"] == "new"
