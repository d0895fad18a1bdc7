"""The port's small reference and helper functions against the JAX
package, on the CPU, from seeded numpy inputs: the whitened IMU residual,
the reference-order sequential preintegration and the dense occupancy
mask."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.config import ImuConfig as JImuConfig
from vins_tpu.core import factors as j_factors
from vins_tpu.core import preintegration as j_pre
from vins_tpu.ops import corners as j_corners
from vins_tpu.utils import lie as j_lie

from vins_tpu_torch.config import ImuConfig
from vins_tpu_torch.core import factors as t_factors
from vins_tpu_torch.core import preintegration as t_pre
from vins_tpu_torch.ops import corners as t_corners

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)

IMU = ImuConfig()


def _chunk(seed, N=32, n=24):
    rng = np.random.default_rng(seed)
    dt = np.zeros(N, np.float32)
    dt[1:n + 1] = rng.uniform(0.004, 0.012, n)
    acc = (rng.normal(0, 2.0, (N, 3)) + [0, 0, 9.8]).astype(np.float32)
    gyr = rng.normal(0, 0.8, (N, 3)).astype(np.float32)
    ba = rng.normal(0, 0.05, 3).astype(np.float32)
    bg = rng.normal(0, 0.02, 3).astype(np.float32)
    return dt, acc, gyr, ba, bg


def _fields(pre):
    return [np.asarray(x) for x in (pre.dp, pre.dq, pre.dv, pre.jacobian,
                                    pre.covariance, pre.sum_dt)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_propagate_sequential_matches_jax_and_propagate(seed):
    """The sequential loop against the JAX scan at atol 1e-5 on every
    field (the covariance at 1e-5 relative to its scale), and against the
    port's parallel `propagate` at tests/test_preintegration.py:148's
    tolerances."""
    dt, acc, gyr, ba, bg = _chunk(seed)
    j = j_pre.propagate_sequential(
        j_pre.ImuChunk(jnp.asarray(dt), jnp.asarray(acc), jnp.asarray(gyr)),
        jnp.asarray(ba), jnp.asarray(bg), JImuConfig())
    chunk = t_pre.ImuChunk(torch.as_tensor(dt), torch.as_tensor(acc),
                           torch.as_tensor(gyr))
    t = t_pre.propagate_sequential(chunk, torch.as_tensor(ba),
                                   torch.as_tensor(bg), IMU)
    for a, b in zip(_fields(t), _fields(j)):
        np.testing.assert_allclose(a, b, atol=1e-5 * max(1.0,
                                                         np.abs(b).max()))
    par = t_pre.propagate(chunk, torch.as_tensor(ba), torch.as_tensor(bg),
                          IMU)
    for a, b, rtol, atol in zip(_fields(par), _fields(t),
                                (1e-4, 1e-5, 1e-4, 1e-3, 1e-3, 1e-6),
                                (1e-5, 1e-6, 1e-5, 1e-4, 1e-4, 0.0)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_propagate_sequential_batches_edges():
    """Leading batch dimensions integrate each edge as alone."""
    chunks = [_chunk(s) for s in (3, 4)]
    stack = [torch.as_tensor(np.stack([c[i] for c in chunks]))
             for i in range(5)]
    both = t_pre.propagate_sequential(t_pre.ImuChunk(*stack[:3]), stack[3],
                                      stack[4], IMU)
    for e, c in enumerate(chunks):
        one = t_pre.propagate_sequential(
            t_pre.ImuChunk(*[torch.as_tensor(x) for x in c[:3]]),
            torch.as_tensor(c[3]), torch.as_tensor(c[4]), IMU)
        for a, b in zip(_fields(both), _fields(one)):
            np.testing.assert_allclose(a[e], b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 5])
def test_imu_residual_whitened_matches_jax(seed):
    """S r of one edge from perturbed states, atol 1e-5 relative to the
    residual's scale."""
    rng = np.random.default_rng(seed)
    dt, acc, gyr, ba, bg = _chunk(seed + 10)
    pre_j = j_pre.propagate(
        j_pre.ImuChunk(jnp.asarray(dt), jnp.asarray(acc), jnp.asarray(gyr)),
        jnp.asarray(ba), jnp.asarray(bg), JImuConfig())
    # Both take the same preintegration (the JAX one), so the test holds
    # the residual and its whitening alone.
    pre_t = t_pre.Preintegration(*[torch.as_tensor(np.array(x))
                                   for x in pre_j])
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    q_i = np.asarray(j_lie.so3_exp_quat(jnp.asarray(f(3) * 0.3)))
    q_j = np.asarray(j_lie.so3_exp_quat(jnp.asarray(f(3) * 0.3)))
    args = [f(3), q_i, f(3), ba + 0.01 * f(3), bg + 0.01 * f(3),
            f(3), q_j, f(3), ba + 0.01 * f(3), bg + 0.01 * f(3),
            np.array([0.0, 0.0, 9.8], np.float32)]
    rj = np.asarray(j_factors.imu_residual_whitened(
        pre_j, *[jnp.asarray(a) for a in args]))
    rt = t_factors.imu_residual_whitened(
        pre_t, *[torch.as_tensor(a) for a in args]).numpy()
    assert np.all(np.isfinite(rj))
    np.testing.assert_allclose(rt, rj, atol=1e-5 * np.abs(rj).max())


@pytest.mark.parametrize("shape,radius", [((60, 80), 7), ((48, 64), 12)])
def test_occupancy_mask_matches_jax(shape, radius):
    """The dense disc mask, exactly, with invalid points ignored."""
    rng = np.random.default_rng(radius)
    H, W = shape
    pts = np.stack([rng.uniform(-5, W + 5, 24), rng.uniform(-5, H + 5, 24)],
                   -1).astype(np.float32)
    valid = rng.uniform(size=24) < 0.7
    j = np.asarray(j_corners.occupancy_mask(shape, jnp.asarray(pts),
                                            jnp.asarray(valid), radius))
    t = t_corners.occupancy_mask(shape, torch.as_tensor(pts),
                                 torch.as_tensor(valid), radius).numpy()
    assert j.any() and not j.all()
    np.testing.assert_array_equal(t, j)
