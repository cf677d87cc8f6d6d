"""Parity of the torch SO(3)/SE(3) port with agi_lidar_slam_tpu.geometry.

Inputs come from a numpy seed and go through both implementations on the
CPU; the reference runs jitted, all cases of a group in one compile (the
suite serializes compiles across workers). Tolerance: 2e-6 absolute for
SO(3), 2e-5 absolute and 1e-6 relative for SE(3), whose translations reach
~10 m. The two sides run the same f32 formulas, but XLA's and torch's
sin/cos/arccos/sqrt kernels differ by a few ulps, and a composed quantity
(e.g. a slerp weight) carries a few of them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch.geometry import se3 as tse3
from agi_lidar_slam_torch.geometry import so3 as tso3
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.geometry import so3 as jso3
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

ATOL = 2e-6


def _inputs(seed=0, n=64):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3)).astype(np.float32) * 0.8
    w[:4] *= 1e-5  # small-angle branches
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q2 = rng.normal(size=(n, 4)).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    v = rng.normal(size=(n, 3)).astype(np.float32) * 10
    s = rng.uniform(size=n).astype(np.float32)
    return w, q, q2, v, s


def _cmp(j, t):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0, atol=ATOL)


_T = torch.from_numpy

SO3_CASES = {
    "hat": (lambda w, q, q2, v, s: jso3.hat(w), lambda w, q, q2, v, s: tso3.hat(w)),
    "exp_matrix": (lambda w, q, q2, v, s: jso3.exp_matrix(w),
                   lambda w, q, q2, v, s: tso3.exp_matrix(w)),
    "log_matrix": (lambda w, q, q2, v, s: jso3.log_matrix(jso3.exp_matrix(w)),
                   lambda w, q, q2, v, s: tso3.log_matrix(tso3.exp_matrix(w))),
    "quat_exp": (lambda w, q, q2, v, s: jso3.quat_exp(w),
                 lambda w, q, q2, v, s: tso3.quat_exp(w)),
    "quat_log": (lambda w, q, q2, v, s: jso3.quat_log(q),
                 lambda w, q, q2, v, s: tso3.quat_log(q)),
    "quat_mul": (lambda w, q, q2, v, s: jso3.quat_mul(q, q2),
                 lambda w, q, q2, v, s: tso3.quat_mul(q, q2)),
    "quat_to_matrix": (lambda w, q, q2, v, s: jso3.quat_to_matrix(q),
                       lambda w, q, q2, v, s: tso3.quat_to_matrix(q)),
    "matrix_to_quat": (lambda w, q, q2, v, s: jso3.matrix_to_quat(jso3.quat_to_matrix(q)),
                       lambda w, q, q2, v, s: tso3.matrix_to_quat(tso3.quat_to_matrix(q))),
    "quat_rotate": (lambda w, q, q2, v, s: jso3.quat_rotate(q, v),
                    lambda w, q, q2, v, s: tso3.quat_rotate(q, v)),
    "slerp": (lambda w, q, q2, v, s: jso3.slerp(q, q2, s),
              lambda w, q, q2, v, s: tso3.slerp(q, q2, s)),
}


@functools.lru_cache(maxsize=None)
def _so3_reference():
    """Every reference SO(3) case in one jitted call: one XLA compile, not one
    per primitive (the suite serializes compiles across workers)."""
    args = tuple(jnp.asarray(a) for a in _inputs())
    return jax.jit(lambda *a: {n: f(*a) for n, (f, _) in SO3_CASES.items()})(*args)


@pytest.mark.parametrize("name", sorted(SO3_CASES))
def test_so3_matches_reference(name):
    w, q, q2, v, s = _inputs()
    j = np.asarray(_so3_reference()[name])
    t = SO3_CASES[name][1](*(_T(a) for a in (w, q, q2, v, s)))
    if name == "matrix_to_quat":  # q and -q are one rotation
        j = j * np.sign(j[:, :1] * t.numpy()[:, :1])
    _cmp(j, t)


def _one(p):
    """The first pose of a batch (apply / apply_interpolated take one pose)."""
    return type(p)(p.q[0], p.t[0])


SE3_CASES = {
    "compose": lambda L, a, b, v, s, d: L.compose(a, b),
    "inverse": lambda L, a, b, v, s, d: L.inverse(a),
    "apply": lambda L, a, b, v, s, d: L.apply(_one(a), v),
    "boxplus": lambda L, a, b, v, s, d: L.boxplus(a, d),
    "boxminus": lambda L, a, b, v, s, d: L.boxminus(a, b),
    "interpolate": lambda L, a, b, v, s, d: L.interpolate(a, b, s),
    "apply_interpolated": lambda L, a, b, v, s, d: L.apply_interpolated(_one(a), s, v),
}


def _se3_inputs():
    w, q, q2, v, s = _inputs(1)
    t1 = v[::-1].copy() * 0.3
    delta = np.concatenate([w * 0.1, v * 0.01], axis=-1)
    return q, q2, v, s, t1, delta


def _se3_case(lib, name, q, q2, v, s, t1, delta):
    return SE3_CASES[name](lib, lib.Pose(q, v), lib.Pose(q2, t1), v, s, delta)


@functools.lru_cache(maxsize=None)
def _se3_reference():
    """Every reference SE(3) case in one jitted call."""
    args = tuple(jnp.asarray(a) for a in _se3_inputs())
    return jax.jit(lambda *a: {n: _se3_case(jse3, n, *a) for n in SE3_CASES})(*args)


@pytest.mark.parametrize("name", sorted(SE3_CASES))
def test_se3_matches_reference(name):
    j = _se3_reference()[name]
    t = _se3_case(tse3, name, *(_T(a) for a in _se3_inputs()))
    for a, b in zip(j, t) if isinstance(t, tuple) else [(j, t)]:
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=ATOL * 10)


def test_pose_identity_and_matrix():
    q = np.asarray([0.9, 0.1, -0.3, 0.2], np.float32) / np.float32(np.sqrt(0.95))
    t = np.asarray([1.0, 2.0, 3.0], np.float32)
    j = jax.jit(lambda q, t: (jse3.Pose(q, t).matrix(), jse3.Pose.identity((2,)).q))(q, t)
    _cmp(j[0], tse3.Pose(_T(q), _T(t)).matrix())
    _cmp(j[1], tse3.Pose.identity((2,), device="cpu").q)
