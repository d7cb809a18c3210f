"""``__graft_entry_torch__.py`` against ``__graft_entry__.py``: ``entry()``
on the CPU within 1e-5 of JAX's on the same inputs (both float32; the
stationary example's cost is 0 in JAX, a rounding above it here), the
step off that fixed point within 1e-5 (float64), and
``dryrun_multichip_backend`` with two lanes on the CPU."""

import jax
import numpy as np
import pytest

import __graft_entry__ as jg
import __graft_entry_torch__ as tg
from vins_rgbd_fast_torch import bridge


def test_example_inputs_equal_jax():
    jcfg, tcfg = jg._example_cfg(), tg._example_cfg()
    js, jf, ji, _ = jg._example_inputs(jcfg)
    ts, tf, ti = tg._example_inputs(tcfg, device="cpu")
    for j, t in ((js, ts), (jf, tf), (ji, ti)):
        for a, b in zip(jax.tree.leaves(jax.device_get(j)), jax.tree.leaves(bridge.to_numpy(t))):
            np.testing.assert_array_equal(b[0], np.asarray(a))


def test_entry_matches_jax_on_the_cpu():
    """``entry()`` as it stands: the stationary example is a fixed point
    (P = 0, Q = identity), so this checks the wiring of the two entry
    points; ``test_entry_matches_jax_off_the_fixed_point`` checks the
    step itself."""
    jfn, jargs = jg.entry()
    tfn, targs = tg.entry(device="cpu")
    jP, jQ, jc = (np.asarray(a) for a in jax.jit(jfn)(*jargs))
    tP, tQ, tc = (a.numpy()[0] for a in tfn(*targs))
    assert np.isfinite(tc)
    np.testing.assert_allclose(tP, jP, atol=1e-5)
    np.testing.assert_allclose(tQ, jQ, atol=1e-5)
    np.testing.assert_allclose(tc, jc, atol=1e-5)


def test_dryrun_multichip_backend_on_the_cpu(capsys):
    tg.dryrun_multichip_backend(2, device="cpu")
    assert "OK on cpu" in capsys.readouterr().out


def test_entry_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises((RuntimeError, AssertionError)):
        tg.entry()


def _off_the_fixed_point():
    """The example's observations drift by 0.004 (normalized) a frame; both
    packages' ``vio_step`` carry the state through 7 frames (the window
    starts solving at the seventh, where the state leaves the stationary
    fixed point), then each ``entry()`` fn takes one more drifted frame,
    all in float64.  Returns JAX's and the port's (P, Q, cost)."""
    import jax.numpy as jnp
    import torch

    from vins_rgbd_fast_torch.backend import estimator as tes
    from vins_rgbd_fast_tpu.backend import estimator as jes

    jcfg, tcfg = jg._example_cfg(), tg._example_cfg()
    jfn, _ = jg.entry()
    tfn, _ = tg.entry(device="cpu")
    js, jf, ji, jk = jg._example_inputs(jcfg, dtype=jnp.float64)
    ts, tf, ti = tg._example_inputs(tcfg, dtype=torch.float64, device="cpu")
    jstep = jax.jit(lambda s, f, i, k: jes.vio_step(jcfg, s, f, i, k))
    for k in range(7):
        js, _ = jstep(js, jf._replace(pts=jf.pts + 0.004 * k), ji, jk)
        ts, _ = tes.vio_step(tcfg, ts, tf._replace(pts=tf.pts + 0.004 * k), ti)
    jout = [np.asarray(a, np.float64)
            for a in jax.jit(jfn)(js, jf._replace(pts=jf.pts + 0.028), ji, jk)]
    tout = [a.numpy()[0].astype(np.float64)
            for a in tfn(ts, tf._replace(pts=tf.pts + 0.028), ti)]
    return jout, tout


def test_entry_matches_jax_off_the_fixed_point():
    """In float64 the port's (P, Q) within 1e-5 of JAX's and the cost
    within 1e-5 relative, after the state has left the fixed point (P
    moved > 5 cm, cost > 1).  Float64, not ``entry()``'s float32: this
    first solving frame is ill-conditioned enough that each package's
    float32 result lies up to 3e-4 m and about 0.3 % of the cost from its
    own float64 one, so float32 results of two implementations agree
    only to that order."""
    (jP, jQ, jc), (tP, tQ, tc) = _off_the_fixed_point()
    assert np.abs(jP).max() > 0.05 and jc > 1.0
    np.testing.assert_allclose(tP, jP, atol=1e-5)
    np.testing.assert_allclose(tQ, jQ, atol=1e-5)
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
