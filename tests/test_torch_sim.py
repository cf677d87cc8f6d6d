"""Parity of the torch simulator with agi_lidar_slam_tpu.sim.world.

Both simulators get one BoxWorld (the reference's default_world, carried over
by convert.world_from_numpy) and the same moving sensor, noise-free. The ray
directions come from sin/cos of the same angles, which XLA and torch round
differently by an ulp; a ray that grazes a box edge can therefore hit on one
side and miss on the other, so the return masks may differ in at most 0.1% of
the rays, and where both hit the points agree to 1e-4 m (ranges up to 80 m,
f32 slab intersections). Sweep times agree to 1 ulp: jitted, XLA turns the
reference's division by the width into a multiply by its reciprocal."""

import jax
import numpy as np
import torch

from agi_lidar_slam_torch.convert import world_from_numpy
from agi_lidar_slam_torch.geometry import se3 as tse3
from agi_lidar_slam_torch.sim import world as tworld
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.geometry import so3 as jso3
from agi_lidar_slam_tpu.sim import world as jworld

# the reference jitted: one compile per function and shape, not one per
# primitive (the suite serializes compiles across workers)
j_default_world = jax.jit(jworld.default_world, static_argnames=("seed", "n_pillars"))


def test_simulate_scan_noise_free():
    jw = j_default_world(seed=5)
    tw = world_from_numpy(np.asarray(jw.lo), np.asarray(jw.hi))
    q0, q1 = np.asarray(jax.jit(jso3.quat_exp)(np.asarray([[0.0, 0.01, 0.3],
                                                          [0.0, 0.01, 0.33]], np.float32)))
    p0 = jse3.Pose(q0, np.asarray([1.0, -2.0, 0.1], np.float32))
    p1 = jse3.Pose(q1, np.asarray([1.6, -1.9, 0.1], np.float32))
    sim = jax.jit(jworld.simulate_scan, static_argnames=("rings", "width"))
    js = sim(jw, p0, p1, rings=16, width=900)

    def tp(p):
        return tse3.Pose(torch.from_numpy(np.array(p.q)), torch.from_numpy(np.array(p.t)))

    ts = tworld.simulate_scan(tw, tp(p0), tp(p1), rings=16, width=900)
    jm, tm = np.asarray(js.mask), ts.mask.numpy()
    assert jm.mean() > 0.5
    assert (jm != tm).mean() <= 1e-3
    both = jm & tm
    np.testing.assert_allclose(ts.xyz.numpy()[both], np.asarray(js.xyz)[both], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.time.numpy(), np.asarray(js.time), rtol=1.2e-7, atol=0)


def test_ray_dirs_and_raycast():
    jw = j_default_world(seed=1)
    origins = np.zeros((8, 64, 3), np.float32)

    @jax.jit
    def reference(origins, world):
        d = jworld.ray_dirs(8, 64, 2.0, -24.8)
        return d, jworld._raycast_boxes(origins, d, world, 80.0)

    jd, jr = (np.asarray(a) for a in reference(origins, jw))
    td = tworld.ray_dirs(8, 64, 2.0, -24.8)
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=1e-6)
    tw = world_from_numpy(np.asarray(jw.lo), np.asarray(jw.hi))
    tr = tworld._raycast_boxes(torch.from_numpy(origins), td, tw, 80.0).numpy()
    hit = np.isfinite(jr) & np.isfinite(tr)
    assert hit.mean() > 0.5
    np.testing.assert_allclose(tr[hit], jr[hit], rtol=1e-5)


def test_default_world_generator_is_explicit():
    """The port draws its pillars from its own torch.Generator: the same seed
    gives the same world, another seed another one; walls and ground match
    the reference's."""
    a = tworld.default_world(seed=3, n_pillars=10)
    b = tworld.default_world(seed=3, n_pillars=10)
    c = tworld.default_world(seed=4, n_pillars=10)
    assert torch.equal(a.lo, b.lo) and not torch.equal(a.lo, c.lo)
    jw = j_default_world(seed=3, n_pillars=10)
    np.testing.assert_array_equal(a.lo[:5].numpy(), np.asarray(jw.lo)[:5])
    np.testing.assert_array_equal(a.hi[:5].numpy(), np.asarray(jw.hi)[:5])
    centers = (a.lo[5:, :2] + a.hi[5:, :2]) / 2
    assert bool((centers[:, 1].abs() >= 3.5 - 1e-4).all())  # the +x corridor stays clear
