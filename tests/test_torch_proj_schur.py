"""K4's plain version, ``solver.proj_schur_plain``, and its wrapper on the
CPU: the projection factors' Schur-form system against the JAX package's
``normal_equations_structured`` with no IMU and an empty prior (so the
projection factors alone), on a grid with a ragged feature count (45, not a
multiple of 32), features that are not valid, observations in the start
frame (j = start, no factor), frames with no observation, and non-zero td,
rolling shutter and velocity; the relo-widened system (an inactive relo
block, NXP = 178); the wrapper's routing of CPU tensors, its refusals and
its tile choice; and the kernel's own arithmetic (``csrc/proj_schur.cuh``,
built for the host with g++ through ``proj_schur_host.cpp``) against the
plain system.

Tolerances: JAX against the port within 1e-5 of each output's largest entry
(as ``tests/test_torch_relo.py`` holds the normal equations; float32, the
two packages sum in other orders), the cost within 1e-6 relative; the
header against the plain version within 1e-5 of each output's largest
entry (float32 both, summed in other orders)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close, tn, tt
from vins_rgbd_fast_torch import native
from vins_rgbd_fast_torch.backend.state import EX_OFF, FRAMES, NP, NX, TD_OFF
from vins_rgbd_fast_torch.ops import factors, solver as tslv
from vins_rgbd_fast_tpu.backend.state import WindowState as JWindow
from vins_rgbd_fast_tpu.ops import solver as jslv

M = 45  # features: not a multiple of 32 (nor of K4's tiles)
G = np.array([0.0, 0.0, 9.805], np.float32)


def _qnorm(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _problem(seed: int, td: float, rs: float, vel: float, B: int = 2):
    """A window of B sequences (numpy float32): poses near a forward-looking
    camera path, landmarks 0.8-5 m ahead, a start frame per feature, 70 % of
    the observations present, 15 % of the features not valid."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = dict(P=(0.05 * np.arange(FRAMES)[None, :, None] + 0.02 * rng.normal(size=(B, FRAMES, 3))),
             Q=_qnorm(np.concatenate([np.ones((B, FRAMES, 1)),
                                      0.03 * rng.normal(size=(B, FRAMES, 3))], -1)),
             V=0.1 * rng.normal(size=(B, FRAMES, 3)), Ba=np.zeros((B, FRAMES, 3)),
             Bg=np.zeros((B, FRAMES, 3)), tic=0.02 * rng.normal(size=(B, 3)),
             qic=_qnorm(np.concatenate([np.ones((B, 1)), 0.02 * rng.normal(size=(B, 3))], -1)),
             td=np.full((B,), td))
    obs = rng.random((B, M, FRAMES)) < 0.7
    start = rng.integers(0, FRAMES, (B, M)).astype(np.int32)
    obs[:, :3] = False  # features 0-2 of every sequence: seen nowhere
    obs[:, 3, :] = False
    obs[:, 3, 0] = True  # feature 3: seen in its start frame 0 alone (j = start only)
    start[:, 3] = 0
    vis = dict(start=start, pts=0.3 * rng.normal(size=(B, M, FRAMES, 2)),
               vel=vel * rng.normal(size=(B, M, FRAMES, 2)),
               td_obs=0.01 * rng.normal(size=(B, M, FRAMES)),
               row_scaled=rs * rng.random((B, M, FRAMES)), obs_mask=obs,
               inv_depth=0.2 + rng.random((B, M)), depth_free=rng.random((B, M)) < 0.5,
               valid=rng.random((B, M)) < 0.85)
    x = {k: v.astype(f) for k, v in x.items()}
    vis = {k: (v.astype(f) if v.dtype == np.float64 else v) for k, v in vis.items()}
    return x, vis


def _torch(x, vis):
    return (tslv.WindowState(**{k: tt(v) for k, v in x.items()}),
            tslv.VisualData(**{k: tt(v) for k, v in vis.items()}))


def _zero_system(B: int, nxp: int, dtype=torch.float32):
    return tslv.StructuredSystem(Hpp=torch.zeros((B, nxp, nxp), dtype=dtype),
                                 Hpl=torch.zeros((B, nxp, M), dtype=dtype),
                                 dl=torch.zeros((B, M), dtype=dtype),
                                 gp=torch.zeros((B, nxp), dtype=dtype),
                                 gl=torch.zeros((B, M), dtype=dtype))


def _jax_system(x, vis, b: int, with_relo: bool):
    """JAX's system of sequence b with no IMU and an empty prior (and an
    inactive relo constraint when ``with_relo``)."""
    cfg = jslv.SolverConfig(maxf=M, with_relo=with_relo)
    relo = None
    if with_relo:
        f32 = jnp.float32
        relo = jslv.ReloData(active=jnp.asarray(False), match_pts=jnp.zeros((M, 2), f32),
                             match_valid=jnp.ones((M,), bool),
                             match_ids=jnp.arange(M, dtype=jnp.int32),
                             P=jnp.zeros(3, f32), Q=jnp.asarray([1.0, 0.0, 0.0, 0.0], f32))
    return jax.jit(lambda *a: jslv.normal_equations_structured(cfg, *a))(
        JWindow(**{k: jnp.asarray(v[b]) for k, v in x.items()}),
        jslv.VisualData(**{k: jnp.asarray(v[b]) for k, v in vis.items()}), None,
        jslv.empty_prior(jnp.float32), jnp.asarray(G), None, relo)


def _check_against_jax(x, vis, nxp: int, with_relo: bool):
    tx, tv = _torch(x, vis)
    s, cost = tslv.proj_schur(tx, tv, _zero_system(2, nxp))
    for b in range(2):
        js, jc = _jax_system(x, vis, b, with_relo)
        for name, a, ref in zip(s._fields, s, js):
            ref = np.asarray(ref)
            assert_close(tn(a[b]), ref, 1e-5 * np.abs(ref).max(), what=f"{name}[{b}]")
        assert_close(0.5 * float(cost[b]), float(jc), 0.0, 1e-6, what=f"cost[{b}]")


@pytest.mark.parametrize("td, rs, vel", [(0.0, 0.0, 0.0), (0.012, 0.02, 0.1)],
                         ids=["vo", "td-rolling-shutter"])
def test_plain_matches_jax_projection_system(td, rs, vel):
    """Features 0-2 (never seen), 3 (seen only at its start), the invalid
    features and the missing observations give no factor; the others one
    per frame they are seen in beside their start."""
    x, vis = _problem(seed=3, td=td, rs=rs, vel=vel)
    live = (vis["valid"][..., None] & vis["obs_mask"]
            & np.take_along_axis(vis["obs_mask"], vis["start"][..., None].astype(np.int64), 2)
            & (np.arange(FRAMES) != vis["start"][..., None]))
    assert not live[:, :4].any() and 100 < live.sum() < 2 * M * FRAMES
    _check_against_jax(x, vis, NX, with_relo=False)


def test_plain_relo_widened_matches_jax():
    """NXP = 178: the six relo rows and columns stay zero, the rest as in
    the 172-dim system."""
    x, vis = _problem(seed=5, td=0.008, rs=0.01, vel=0.05)
    _check_against_jax(x, vis, NX + 6, with_relo=True)
    s, _ = tslv.proj_schur(*_torch(x, vis), _zero_system(2, NX + 6))
    assert not s.Hpp[:, NX:].any() and not s.Hpp[:, :, NX:].any() and not s.Hpl[:, NX:].any()


def test_plain_adds_into_the_system_and_leaves_it():
    """The factors are added to the system given (here a symmetric random
    one), which stays as it was; the rows no factor touches are copied."""
    x, vis = _problem(seed=7, td=0.01, rs=0.01, vel=0.05)
    tx, tv = _torch(x, vis)
    g = torch.Generator().manual_seed(0)
    s0 = tslv.StructuredSystem(*[torch.randn(t.shape, generator=g) for t in _zero_system(2, NX)])
    s0 = s0._replace(Hpp=s0.Hpp + s0.Hpp.transpose(1, 2))
    keep = tslv.StructuredSystem(*[t.clone() for t in s0])
    s, cost = tslv.proj_schur(tx, tv, s0)
    z, cost_z = tslv.proj_schur(tx, tv, _zero_system(2, NX))
    for name, a, b, c in zip(s._fields, s, s0, z):
        assert torch.equal(b, getattr(keep, name)), name
        assert_close(tn(a), tn(b + c), 1e-5 * float(c.abs().max()), what=name)
    assert torch.equal(cost, cost_z)
    sb = slice(NP, EX_OFF)  # the speed-bias rows
    assert torch.equal(s.Hpl[:, sb], s0.Hpl[:, sb]) and torch.equal(s.gp[:, sb], s0.gp[:, sb])
    assert torch.equal(s.Hpp[:, sb], s0.Hpp[:, sb])


def test_wrapper_sends_cpu_tensors_to_plain(monkeypatch):
    """On CPU tensors ``proj_schur`` runs the plain version, whatever the
    dtype, and never reaches the kernel library or its counter."""
    x, vis = _problem(seed=9, td=0.0, rs=0.0, vel=0.0)
    tx, tv = _torch(x, vis)
    calls = []
    plain = tslv.proj_schur_plain

    def spy(*a):
        calls.append(a)
        return plain(*a)

    def refuse(*a, **k):
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(tslv, "proj_schur_plain", spy)
    monkeypatch.setattr(native, "launch", refuse)
    monkeypatch.setattr(native, "lib", refuse)
    before = tslv.launches.total
    s, cost = tslv.proj_schur(tx, tv, _zero_system(2, NX))
    ref, ref_cost = plain(tx, tv, _zero_system(2, NX))
    for a, b in zip(s, ref):
        assert torch.equal(a, b)
    assert torch.equal(cost, ref_cost)
    x64 = tx._replace(**{k: v.double() for k, v in tx._asdict().items()})
    v64 = tv._replace(**{k: v.double() for k, v in tv._asdict().items()
                         if v.dtype == torch.float32})
    tslv.proj_schur(x64, v64, _zero_system(2, NX, torch.float64))
    assert len(calls) == 2 and tslv.launches.total == before
    # through the solve's assembly as well
    tslv.normal_equations_structured(tx, tv, None, tslv.empty_prior(2, "cpu"), tt(G))
    assert len(calls) == 3


@pytest.mark.parametrize("what", ["float64", "start int64", "Hpl rows", "gp"])
def test_cuda_wrapper_refuses_inputs_the_kernel_lacks(what):
    """The kernel's wrapper checks dtype, shape and contiguity before it
    touches a device."""
    x, vis = _problem(seed=11, td=0.0, rs=0.0, vel=0.0)
    tx, tv = _torch(x, vis)
    s = _zero_system(2, NX)
    if what == "float64":
        tx = tx._replace(P=tx.P.double())
    elif what == "start int64":
        tv = tv._replace(start=tv.start.long())
    elif what == "Hpl rows":
        s = s._replace(Hpl=torch.zeros((2, NX + 6, M)))
    else:
        s = s._replace(gp=torch.zeros((2, 2 * NX))[:, ::2])
    with pytest.raises(ValueError, match="proj_schur"):
        tslv._proj_schur_cuda(tx.P, tx.Q, tx.tic, tx.qic, tx.td, tv, s)


@pytest.mark.parametrize("B, M_, expect", [(32, 376, 32), (8, 376, 16), (4, 376, 8),
                                           (1, 376, 8), (1, 48, 8), (132, 1, 32)])
def test_tile_gives_every_sm_a_block(B, M_, expect):
    """The fleet (32 × 376) takes tiles of 32 features, 384 blocks on the
    H100's 132 SMs; one sequence takes tiles of 8."""
    t = tslv.proj_schur_tile(B, M_, 132)
    assert t == expect
    assert B * -(-M_ // t) >= 132 or t == 8


HOST_SRC = Path(__file__).with_name("proj_schur_host.cpp")


@pytest.fixture(scope="module")
def k4_host(tmp_path_factory):
    """K4's header built for the host with g++ (``proj_schur_host.cpp``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is missing: K4's header cannot be built for the host")
    so = tmp_path_factory.mktemp("k4_host") / "libproj_schur_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", native.CSRC,
                    str(HOST_SRC), "-o", str(so)], check=True, capture_output=True, timeout=120)
    L = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L.proj_schur_host.restype = None
    L.proj_schur_host.argtypes = [p] * 13 + [i, i, i, f, f] + [p] * 6
    return L


@pytest.mark.parametrize("td, rs, vel, nxp", [(0.0, 0.0, 0.0, NX), (0.01, 0.02, 0.1, NX),
                                              (0.01, 0.02, 0.1, NX + 6)],
                         ids=["vo", "td-rolling-shutter", "relo-widened"])
def test_kernel_scheme_reproduces_plain_system(k4_host, td, rs, vel, nxp):
    """K4's own arithmetic (``csrc/proj_schur.cuh``: each factor's residual,
    Jacobian and Cauchy weight, and each feature's common Gram and per-frame
    items routed through the 73 dense dims and Hpp's upper triangle),
    compiled for the host, gives the plain system in float32 within 1e-5 of
    each output's largest entry (the two sum in other orders); the rows no
    factor touches (speed-biases, a relo block) stay zero."""
    x, vis = _problem(seed=13, td=td, rs=rs, vel=vel)
    tx, tv = _torch(x, vis)
    ref, ref_cost = tslv.proj_schur_plain(tx, tv, _zero_system(2, nxp))
    out, cost = _zero_system(2, nxp), torch.zeros(2)
    ins = [tx.P, tx.Q, tx.tic, tx.qic, tx.td] + list(tv[:6]) + [tv.inv_depth, tv.valid]
    ins = [t.contiguous() for t in ins]
    k4_host.proj_schur_host(*[t.data_ptr() for t in ins], 2, M, nxp,
                            float(factors.PROJ_SQRT_INFO), float(tslv.CAUCHY_C) ** 2,
                            *[t.data_ptr() for t in list(out) + [cost]])
    for name, got, want in zip(ref._fields + ("cost",), list(out) + [cost],
                               list(ref) + [ref_cost]):
        want = tn(want)
        assert np.abs(want).max() > 0, name
        assert_close(tn(got), want, 1e-5 * np.abs(want).max(), what=name)
    rest = [r for r in range(nxp) if not (r < NP or EX_OFF <= r <= TD_OFF)]
    assert not out.Hpp[:, rest].any() and not out.Hpp[:, :, rest].any()
    assert not out.Hpl[:, rest].any() and not out.gp[:, rest].any()
