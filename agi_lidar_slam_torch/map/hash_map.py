"""Hashed voxel-block map (port of agi_lidar_slam_tpu/map/hash_map.py).

An open-addressing hash table of voxel *blocks*; each block is a
`block_sub`^3 lattice of sub-voxels holding at most one point (ikd-Tree's
downsample-on-insert semantics). Probe chains are contiguous: the table has
`probes` overflow rows past the hashed range instead of wrapping, and row
`n_rows - 1` is the scatter dump.

Every function here is pure: it returns new tensors and leaves its inputs
as they were. Scatters write each non-dump target at most once, or reduce
with `scatter_reduce_(..., "amin")`, so results are deterministic on CUDA.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from agi_lidar_slam_tpu.config import MapConfig

from ..pointcloud.voxel import div_exact

EMPTY_KEY = -(2**31) + 1  # sentinel block coordinate (all three axes)


class HashVoxelMap(NamedTuple):
    """keys: (rows, 3) int32 block coords (last row is the scatter dump).
    points: (rows, B, 3) f32, one point per sub-voxel slot.
    occ: (rows, B) bool sub-voxel occupancy."""

    keys: torch.Tensor
    points: torch.Tensor
    occ: torch.Tensor

    @property
    def n_rows(self) -> int:
        return self.keys.shape[0]

    @property
    def bucket(self) -> int:
        return self.points.shape[1]

    def num_points(self) -> torch.Tensor:
        return torch.sum(self.occ[:-1].to(torch.int32))

    def num_blocks(self) -> torch.Tensor:
        return torch.sum((self.keys[:-1, 0] != EMPTY_KEY).to(torch.int32))


def map_rows(cfg: MapConfig) -> int:
    """Hashed range + probe overflow + dump, rounded up to a multiple of 256."""
    return ((cfg.slots + cfg.probes + 1 + 255) // 256) * 256


def empty_map(cfg: MapConfig, device=None) -> HashVoxelMap:
    rows = map_rows(cfg)
    B = cfg.bucket
    return HashVoxelMap(
        keys=torch.full((rows, 3), EMPTY_KEY, dtype=torch.int32, device=device),
        points=torch.zeros((rows, B, 3), dtype=torch.float32, device=device),
        occ=torch.zeros((rows, B), dtype=torch.bool, device=device),
    )


def pack_key(bc: torch.Tensor) -> torch.Tensor:
    """Block coords (...,3) int32 -> one non-negative 30-bit int32 key:
    (x mod 1024) << 20 | (y mod 1024) << 10 | (z mod 1024)."""
    return (((bc[..., 0] & 1023) << 20) | ((bc[..., 1] & 1023) << 10)
            | (bc[..., 2] & 1023))


def hash_packed(pk: torch.Tensor, log2_slots: int) -> torch.Tensor:
    """murmur-style avalanche of a packed key -> int32 slot in [0, 2**log2_slots).

    The reference multiplies in int32 and relies on wraparound; here the
    multiplies run in int64 (operands < 2**31 and < 2**30, so no overflow)
    and the mask keeps the same low 31 bits."""
    u = pk.to(torch.int64) & 0x7FFFFFFF
    u = u ^ (u >> 15)
    u = (u * 0x2C1B3C6D) & 0x7FFFFFFF
    u = u ^ (u >> 12)
    u = (u * 0x297A2D39) & 0x7FFFFFFF
    u = u ^ (u >> 13)
    return (u & ((1 << log2_slots) - 1)).to(torch.int32)


def probe_base(bc: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Start row of a block's probe window [h, h+probes)."""
    return hash_packed(pack_key(bc), cfg.log2_slots)


def block_coords(xyz: torch.Tensor, cfg: MapConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points (...,3) -> (block coord (...,3) int32, sub-voxel id (...,) int32)."""
    sv = torch.floor(div_exact(xyz, cfg.sub_voxel)).to(torch.int32)
    bc = torch.div(sv, cfg.block_sub, rounding_mode="floor")
    local = sv - bc * cfg.block_sub
    sub_id = (local[..., 0] * cfg.block_sub + local[..., 1]) * cfg.block_sub + local[..., 2]
    return bc, sub_id


def _key_windows(keys: torch.Tensor, h: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """The (probes, 3) probe window for each hash. h (N,) -> (N, P, 3)."""
    idx = h[:, None].long() + torch.arange(cfg.probes, device=h.device)[None, :]
    return keys[idx]


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none)."""
    return torch.argmax(x.to(torch.uint8), dim=-1)


def lookup(keys: torch.Tensor, bc: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Slot of each queried block coord, or -1 if absent. bc (...,3) any batch shape."""
    shape = bc.shape[:-1]
    bc_flat = bc.reshape(-1, 3)
    h = probe_base(bc_flat, cfg)
    win = _key_windows(keys, h, cfg)  # (N,P,3)
    match = torch.all(win == bc_flat[:, None, :], dim=-1)  # (N,P)
    p_idx = _first_true(match).to(torch.int32)
    slot = torch.where(match.any(dim=-1), h + p_idx, torch.full_like(h, -1))
    return slot.reshape(shape)


def _first_empty(keys: torch.Tensor, bc: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """First empty probe slot for each block coord, or -1 if the chain is full."""
    bc_flat = bc.reshape(-1, 3)
    h = probe_base(bc_flat, cfg)
    is_empty = _key_windows(keys, h, cfg)[..., 0] == EMPTY_KEY  # (N,P)
    p_idx = _first_true(is_empty).to(torch.int32)
    slot = torch.where(is_empty.any(dim=-1), h + p_idx, torch.full_like(h, -1))
    return slot.reshape(bc.shape[:-1])


def lookup_dedup(keys: torch.Tensor, bc: torch.Tensor, valid: torch.Tensor,
                 cfg: MapConfig, claim: bool = False):
    """`lookup` with cross-batch deduplication: distinct block coords are
    probed once. bc (K,3), valid (K,) -> slot (K,) (-1 where absent/invalid).

    Distinct coords are found by a stable sort of packed 30-bit keys, after
    recentering on the minimum valid coordinate; entries outside the
    1024-block window resolve to 'absent'. With `claim`, each distinct absent
    block claims a free probe slot first, over at most `claim_rounds`
    conflict rounds (owner elected by scatter-min of the unique id); returns
    (new keys, slot) then.

    The claim loop reads one flag back to the host per round to decide
    whether another round is needed."""
    K = bc.shape[0]
    dev = bc.device
    U = min(K, max(K // 2, 4096))
    far = torch.full_like(bc, 2**20)
    qbc = torch.where(valid[:, None], bc, far)
    base = torch.amin(qbc, dim=0)  # (3,)
    base = torch.where(base == 2**20, torch.zeros_like(base), base)  # all-masked batch
    rel = bc - base[None, :]
    in_range = torch.all((rel >= 0) & (rel < 1024), dim=1) & valid
    relc = torch.clamp(rel, 0, 1023)
    packed = (relc[:, 0] << 20) | (relc[:, 1] << 10) | relc[:, 2]
    packed = torch.where(in_range, packed, torch.full_like(packed, 1 << 30))
    ps, order = torch.sort(packed, stable=True)
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), ps[1:] != ps[:-1]])
    uid_sorted = torch.cumsum(first.to(torch.int32), dim=0, dtype=torch.int32) - 1
    ok_u = (uid_sorted < U) & in_range[order]
    # representative coords per unique id; only row U (the dump) repeats
    ucoords = torch.full((U + 1, 3), 2**20, dtype=torch.int32, device=dev)
    tgt = torch.where(first & ok_u, uid_sorted, torch.full_like(uid_sorted, U)).long()
    ucoords[tgt] = bc[order]
    ureal = ucoords[:U, 0] != 2**20
    uc = ucoords[:U]

    if claim:
        dump = keys.shape[0] - 1
        u_idx = torch.arange(U, dtype=torch.int32, device=dev)

        def claim_round(kys):
            uslot = lookup(kys, uc, cfg)
            nd = ureal & (uslot < 0)
            cand = _first_empty(kys, uc, cfg)
            attempt = nd & (cand >= 0)
            cand_safe = torch.where(attempt, cand, torch.full_like(cand, dump)).long()
            cl = torch.full((kys.shape[0],), U, dtype=torch.int32, device=dev)
            cl.scatter_reduce_(0, cand_safe, torch.where(attempt, u_idx, torch.full_like(u_idx, U)),
                               "amin")
            winner = attempt & (cl[cand_safe] == u_idx)
            kys = kys.clone()
            # winners own distinct slots; losers all rewrite the dump row with itself
            wslot = torch.where(winner, cand, torch.full_like(cand, dump)).long()
            kys[wslot] = torch.where(winner[:, None], uc, kys[dump].expand_as(uc))
            return kys, torch.any(attempt & ~winner)

        keys, unresolved = claim_round(keys)
        rnd = 1
        while rnd < cfg.claim_rounds and bool(unresolved):
            keys, unresolved = claim_round(keys)
            rnd += 1

    uslot = lookup(keys, uc, cfg)  # probe only distinct blocks
    slot_sorted = torch.where(ok_u, uslot[torch.clamp(uid_sorted, max=U - 1).long()],
                              torch.full_like(uid_sorted, -1))
    slot = torch.empty((K,), dtype=torch.int32, device=dev)
    slot[order] = slot_sorted
    return (keys, slot) if claim else slot


def insert_with_stats(m: HashVoxelMap, xyz: torch.Tensor, mask: torch.Tensor,
                      cfg: MapConfig) -> Tuple[HashVoxelMap, torch.Tensor]:
    """Insert a padded point batch (N,3)+(N,) into the map; returns
    (new map, n_dropped). The input map is not modified.

    Existing sub-voxel occupants win; among same-batch duplicates the lowest
    point index wins (scatter-min). Points whose probe chain is full are
    dropped and counted."""
    N = xyz.shape[0]
    B = m.bucket
    dump = m.n_rows - 1
    bc, sub_id = block_coords(xyz, cfg)
    pt_idx = torch.arange(N, dtype=torch.int32, device=xyz.device)

    keys, slot = lookup_dedup(m.keys, bc, mask, cfg, claim=True)

    placed = mask & (slot >= 0)
    n_dropped = torch.sum((mask & (slot < 0)).to(torch.int32))
    dump_flat = torch.full_like(slot, dump * B)
    flat = torch.where(placed, slot * B + sub_id, dump_flat).long()
    occ_flat = m.occ.reshape(-1)
    writeable = placed & ~occ_flat[flat]
    flat_w = torch.where(writeable, flat, dump_flat.long())
    owner = torch.full((m.n_rows * B,), N, dtype=torch.int32, device=xyz.device)
    owner.scatter_reduce_(0, flat_w, torch.where(writeable, pt_idx, torch.full_like(pt_idx, N)),
                          "amin")
    is_owner = writeable & (owner[flat_w] == pt_idx)
    flat_final = torch.where(is_owner, flat, dump_flat.long())
    # owners write distinct targets; every other point writes (0, unchanged
    # occupancy) into the dump row, so the duplicates there all agree
    points = m.points.reshape(-1, 3).clone()
    points[flat_final] = torch.where(is_owner[:, None], xyz, torch.zeros_like(xyz))
    occ = occ_flat.clone()
    occ[flat_final] = is_owner | occ_flat[flat_final]
    new_m = HashVoxelMap(keys, points.reshape(m.n_rows, B, 3), occ.reshape(m.n_rows, B))
    return new_m, n_dropped


def insert(m: HashVoxelMap, xyz: torch.Tensor, mask: torch.Tensor,
           cfg: MapConfig) -> HashVoxelMap:
    """`insert_with_stats` without the drop count."""
    return insert_with_stats(m, xyz, mask, cfg)[0]


def bound_map(m: HashVoxelMap, center: torch.Tensor, radius: float,
              cfg: MapConfig) -> HashVoxelMap:
    """Keep only blocks within `radius` (per axis) of `center` — the rolling
    map recentering of the reference mappers."""
    return delete_outside_box(m, center - radius, center + radius, cfg)


def delete_outside_box(m: HashVoxelMap, lo: torch.Tensor, hi: torch.Tensor,
                       cfg: MapConfig) -> HashVoxelMap:
    """Drop every block whose center is outside [lo, hi]."""
    bsz = cfg.block_size
    center = (m.keys[:-1].to(torch.float32) + 0.5) * bsz
    live = m.keys[:-1, 0] != EMPTY_KEY
    inside = torch.all((center >= lo) & (center <= hi), dim=-1)
    drop = live & ~inside
    keys = torch.cat([torch.where(drop[:, None], torch.full_like(m.keys[:-1], EMPTY_KEY),
                                  m.keys[:-1]), m.keys[-1:]], dim=0)
    occ = torch.cat([m.occ[:-1] & ~drop[:, None], m.occ[-1:]], dim=0)
    return HashVoxelMap(keys, m.points, occ)
