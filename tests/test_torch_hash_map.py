"""Parity of the torch hashed voxel-block map with agi_lidar_slam_tpu.map.

Keys, slots, occupancy, stored points and drop counts are integer or copied
data, so every comparison here is exact: the port must make the same hash,
the same claims and the same first-wins choices as the reference."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch.convert import config_from_reference as port_cfg
from agi_lidar_slam_torch.map import hash_map as thm
from agi_lidar_slam_torch.map.planar import build_ktab
from agi_lidar_slam_tpu.config import MapConfig
from agi_lidar_slam_tpu.map import hash_map as jhm
from agi_lidar_slam_tpu.map.planar import build_planar
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

CFG = MapConfig(sub_voxel=0.5, block_sub=4, log2_slots=10, probes=8, neighborhood="octant8")
# 2^6 slots for ~200 distinct blocks: chains fill, claims conflict, points drop
TIGHT = MapConfig(sub_voxel=0.25, block_sub=2, log2_slots=6, probes=8, neighborhood="full27")
TCFG = port_cfg(CFG)  # the port's own MapConfig, same fields

# the reference jitted: one compile per function and shape, not one per
# primitive (the suite serializes compiles across workers)
j_insert = jax.jit(jhm.insert, static_argnums=3)
j_insert_with_stats = jax.jit(jhm.insert_with_stats, static_argnums=3)
j_lookup = jax.jit(jhm.lookup, static_argnums=2)
j_lookup_dedup = jax.jit(jhm.lookup_dedup, static_argnums=3)
j_bound_map = jax.jit(jhm.bound_map, static_argnums=(2, 3))
j_block_coords = jax.jit(jhm.block_coords, static_argnums=1)
j_empty_map = jax.jit(jhm.empty_map, static_argnums=0)
j_ktab = jax.jit(lambda m, cfg: build_planar(m, cfg).ktab, static_argnums=1)
LOG2S = (6, 13, 14, 20)


@jax.jit
def j_keys_and_hashes(bc, raw):
    pk = jhm.pack_key(bc)
    return pk, [jhm.hash_packed(pk, n) for n in LOG2S], jhm.hash_packed(raw, 14)


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_hash_packed_bit_exact():
    """int32 wraparound multiplies of the reference vs int64 + mask, on packed
    keys of negative, zero and large block coords."""
    rng = np.random.default_rng(0)
    bc = rng.integers(-5000, 5000, (4096, 3)).astype(np.int32)
    bc[:6] = [[-1, -1, -1], [0, 0, 0], [1023, 1023, 1023], [-1024, 511, -512],
              [2**20, -(2**20), 7], [2**30, -(2**30), -(2**31) + 1]]
    raw = rng.integers(0, 2**31 - 1, 4096, dtype=np.int64).astype(np.int32)
    jk, jh, jraw = j_keys_and_hashes(jnp.asarray(bc), jnp.asarray(raw))
    tk = thm.pack_key(torch.from_numpy(bc))
    _eq(jk, tk)
    for n, h in zip(LOG2S, jh):
        _eq(h, thm.hash_packed(tk, n))
    _eq(jraw, thm.hash_packed(torch.from_numpy(raw), 14))


def test_block_coords_negative_and_boundaries():
    """floor, then floor division: negative coords and exact voxel/block
    boundaries land in the same blocks and sub-voxels as the reference."""
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-100, 100, (3000, 3)).astype(np.float32)
    edges = np.arange(-8, 8, dtype=np.float32) * 0.5  # sub-voxel and block boundaries
    xyz[:16] = np.stack([edges, -edges, edges * 0.999], axis=-1)
    for cfg in (CFG, MapConfig(sub_voxel=0.6, block_sub=4), MapConfig(sub_voxel=0.8, block_sub=3)):
        jb, js = j_block_coords(jnp.asarray(xyz), cfg)
        tb, ts = thm.block_coords(torch.from_numpy(xyz), port_cfg(cfg))
        _eq(jb, tb)
        _eq(js, ts)
        # floor-division semantics, independently of either library
        sv = np.floor(xyz / np.float32(cfg.sub_voxel)).astype(np.int64)
        np.testing.assert_array_equal(tb.numpy(), sv // cfg.block_sub)


def _batches(seed, n, extent):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    pts[n // 2: n // 2 + 20] = pts[:20]  # same-batch duplicates: lowest index wins
    mask = rng.uniform(size=n) > 0.1
    return pts, mask


@pytest.mark.parametrize("cfg", [CFG, TIGHT], ids=["roomy", "tight"])
def test_insert_with_stats_exact(cfg):
    """Two inserts (the second into the first's map): keys, occ, points and
    n_dropped all exact, including claim conflicts and full chains."""
    jm, tm = j_empty_map(cfg), thm.empty_map(port_cfg(cfg), "cpu")
    for seed in (2, 3):
        pts, mask = _batches(seed, 3000, 9.0)
        jm, jd = j_insert_with_stats(jm, jnp.asarray(pts), jnp.asarray(mask), cfg)
        tm_before = tm
        tm, td = thm.insert_with_stats(tm, torch.from_numpy(pts), torch.from_numpy(mask),
                                       port_cfg(cfg))
        assert int(tm_before.num_points()) <= int(tm.num_points())  # input map untouched
        for f in ("keys", "occ", "points"):
            _eq(getattr(jm, f), getattr(tm, f))
        _eq(jd, td)
    if cfg is TIGHT:
        assert int(td) > 0  # the drop path is exercised


def test_lookup_dedup_and_lookup():
    pts, mask = _batches(4, 4000, 12.0)
    jm = j_insert(j_empty_map(CFG), jnp.asarray(pts), jnp.asarray(mask), CFG)
    tm = thm.insert(thm.empty_map(TCFG, "cpu"), torch.from_numpy(pts), torch.from_numpy(mask), TCFG)
    rng = np.random.default_rng(5)
    q = rng.uniform(-14, 14, (5000, 3)).astype(np.float32)
    qv = rng.uniform(size=5000) > 0.3
    jbc, _ = j_block_coords(jnp.asarray(q), CFG)
    tbc, _ = thm.block_coords(torch.from_numpy(q), TCFG)
    _eq(j_lookup(jm.keys, jbc, CFG), thm.lookup(tm.keys, tbc, TCFG))
    _eq(j_lookup_dedup(jm.keys, jbc, jnp.asarray(qv), CFG),
        thm.lookup_dedup(tm.keys, tbc, torch.from_numpy(qv), TCFG))
    # all-masked batch: every slot absent
    none = thm.lookup_dedup(tm.keys, tbc, torch.zeros(5000, dtype=torch.bool), TCFG)
    assert bool((none == -1).all())


def test_bound_map_and_ktab():
    pts, mask = _batches(6, 4000, 30.0)
    jm = j_insert(j_empty_map(CFG), jnp.asarray(pts), jnp.asarray(mask), CFG)
    tm = thm.insert(thm.empty_map(TCFG, "cpu"), torch.from_numpy(pts), torch.from_numpy(mask), TCFG)
    center = np.asarray([3.3, -7.1, 0.4], np.float32)
    jb = j_bound_map(jm, jnp.asarray(center), 12.0, CFG)
    tb = thm.bound_map(tm, torch.from_numpy(center), 12.0, TCFG)
    for f in ("keys", "occ", "points"):
        _eq(getattr(jb, f), getattr(tb, f))
    assert int(tb.num_blocks()) < int(tm.num_blocks())
    # the kernel's packed-key index is the reference planar table's ktab
    _eq(j_ktab(jb, CFG), build_ktab(tb))



def test_claim_rounds_under_capture_equal_early_exit(monkeypatch):
    """While a CUDA graph is being captured, lookup_dedup's claims run all
    `claim_rounds` rounds (no flag can be read back); that gives the
    early-exit keys and slots bit for bit. The capture check is patched here
    to force that mode on the CPU. 3000 points in 2^10 slots of 0.5 m blocks
    make real conflicts: one round leaves blocks unclaimed that a second
    claims, the early exit stops after 5 of the 8 rounds, and full chains
    leave some blocks without a slot."""
    cfg = MapConfig(sub_voxel=0.25, block_sub=2, log2_slots=10, probes=8, neighborhood="full27")
    tcfg = port_cfg(cfg)
    rounds = []
    first_empty = thm._first_empty

    def counted(*a):
        rounds.append(1)
        return first_empty(*a)

    monkeypatch.setattr(thm, "_first_empty", counted)
    pts = np.random.default_rng(7).uniform(-9, 9, (3000, 3)).astype(np.float32)
    bc, _ = thm.block_coords(torch.from_numpy(pts), tcfg)
    valid = torch.from_numpy(np.arange(3000) % 10 != 0)
    keys = thm.empty_map(tcfg, "cpu").keys
    eager_keys, eager_slot = thm.lookup_dedup(keys, bc, valid, tcfg, claim=True)
    n_eager = len(rounds)
    one_keys, _ = thm.lookup_dedup(keys, bc, valid,
                                   port_cfg(dataclasses.replace(cfg, claim_rounds=1)), claim=True)
    monkeypatch.setattr(thm, "_capturing", lambda t: True)
    rounds.clear()
    all_keys, all_slot = thm.lookup_dedup(keys, bc, valid, tcfg, claim=True)
    assert len(rounds) == tcfg.claim_rounds and 1 < n_eager < tcfg.claim_rounds
    assert not torch.equal(one_keys, eager_keys)  # a second round claimed more
    assert int((eager_slot[valid] < 0).sum()) > 0  # and some chains are full
    assert torch.equal(all_keys, eager_keys) and torch.equal(all_slot, eager_slot)
