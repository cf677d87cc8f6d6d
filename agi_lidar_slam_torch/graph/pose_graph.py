"""Pose-graph optimization: batched Gauss-Newton with matrix-free
preconditioned CG (port of agi_lidar_slam_tpu/graph/pose_graph.py).

Each solve is a full GN pass over the keyframe graph: residuals and Jacobian
blocks of every factor (odometry/loop BetweenFactors, GPS position factors)
in one batched pass; the normal equations are never formed: CG runs on a
gather -> 6x12 block product -> scatter-add operator, preconditioned by the
inverse of the block diagonal; node 0 is anchored by a strong prior.

Manifold: SO(3) x R^3 per node, right rotation perturbation.
Residuals: r_R = Log(Z_R^-1 R_i^-1 R_j), r_t = R_i^-1 (t_j - t_i) - Z_t.

The reference's CG is a while loop that stops when the residual is small.
Here it runs the fixed `n_cg_iters` iterations with an `active` flag on the
device that freezes the iterate once the stop test holds, so no iteration
reads anything back to the host. The scatters are `index_add_`, which on
CUDA adds with atomics, in another order than the reference's.

`sharded_solve_pose_graph` splits the edge axis over the ranks of a device
mesh's group: every per-node reduction (g, the block diagonal, each Hv)
completes with one all_reduce, and the node state and the CG iterations run
alike on every rank. All 30 CG iterations run on every rank, so the
collectives line up.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import default_device
from ..geometry import se3, so3
from ..parallel.distributed import allsum, rank_and_size
from .keyframes import write_row


class EdgeSet(NamedTuple):
    """Fixed-capacity factor storage. kind 0 = between (odom/loop),
    kind 1 = GPS/position prior on node i (z_t = world position, z_q unused)."""

    i: torch.Tensor  # (E,) int32
    j: torch.Tensor  # (E,) int32 (ignored for GPS)
    z_q: torch.Tensor  # (E,4) measured relative rotation
    z_t: torch.Tensor  # (E,3) measured relative translation / world position
    w_rot: torch.Tensor  # (E,) rotation information weight (1/sigma^2)
    w_trans: torch.Tensor  # (E,)
    kind: torch.Tensor  # (E,) int32
    valid: torch.Tensor  # (E,) bool
    count: torch.Tensor  # () int32

    @property
    def capacity(self) -> int:
        return self.i.shape[0]


def empty_edges(capacity: int, device=None) -> EdgeSet:
    """An empty edge set on `device` (default: cuda)."""
    device = default_device(device)
    return EdgeSet(
        i=torch.zeros((capacity,), dtype=torch.int32, device=device),
        j=torch.zeros((capacity,), dtype=torch.int32, device=device),
        z_q=so3.quat_identity((capacity,), device=device),
        z_t=torch.zeros((capacity, 3), device=device),
        w_rot=torch.zeros((capacity,), device=device),
        w_trans=torch.zeros((capacity,), device=device),
        kind=torch.zeros((capacity,), dtype=torch.int32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _scalar(v, dtype, device) -> torch.Tensor:
    """A 0-d tensor of v on `device`. A Python number becomes a fill, not a
    host-to-device copy (which on the card synchronizes)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def add_edge(e: EdgeSet, i, j, z: se3.Pose, w_rot, w_trans, kind=0, do_add=True) -> EdgeSet:
    """Append one factor (masked by do_add; no-op when full). Indices,
    weights and the flag may be Python numbers or 0-d tensors."""
    dev = e.i.device
    idx = torch.clamp(e.count, max=e.capacity - 1)
    write = _scalar(do_add, torch.bool, dev) & (e.count < e.capacity)
    w = torch.where(write, idx, torch.full_like(idx, e.capacity - 1))

    def upd(arr, val, dtype=None):
        return write_row(arr, w, write, _scalar(val, dtype or arr.dtype, dev))

    return EdgeSet(
        i=upd(e.i, i), j=upd(e.j, j), z_q=upd(e.z_q, z.q), z_t=upd(e.z_t, z.t),
        w_rot=upd(e.w_rot, w_rot), w_trans=upd(e.w_trans, w_trans),
        kind=upd(e.kind, kind), valid=upd(e.valid, write),
        count=e.count + write.to(torch.int32),
    )


def _edge_terms(q: torch.Tensor, t: torch.Tensor, e: EdgeSet):
    """Batched residuals and Jacobian blocks for all factors.

    Returns r (E,6), Ji (E,6,6), Jj (E,6,6), w (E,6) row weights.
    Between: r as in the module docstring; the Jacobian blocks take the
    small-residual approximation Jr^-1 ~ I (exact at convergence).
    GPS (kind 1): r_t = t_i - z_t (world), r_R = 0; only Ji's translation block."""
    ei, ej = e.i.long(), e.j.long()
    qi, ti = q[ei], t[ei]
    qj, tj = q[ej], t[ej]
    Ri = so3.quat_to_matrix(qi)
    q_ij = so3.quat_mul(so3.quat_conj(qi), qj)
    R_ij = so3.quat_to_matrix(q_ij)

    r_R = so3.quat_log(so3.quat_mul(so3.quat_conj(e.z_q), q_ij))
    RiT = Ri.transpose(-1, -2)
    u = torch.einsum("nij,nj->ni", RiT, tj - ti)  # R_i^T (t_j - t_i)
    r_t = u - e.z_t

    E = e.capacity
    Z3 = torch.zeros((E, 3, 3), dtype=q.dtype, device=q.device)
    I3 = torch.eye(3, dtype=q.dtype, device=q.device).expand(E, 3, 3)
    # rows: [r_R, r_t], cols: [dtheta, dt]
    Ji_bet = torch.cat([torch.cat([-R_ij.transpose(-1, -2), Z3], dim=-1),
                        torch.cat([so3.hat(u), -RiT], dim=-1)], dim=-2)
    Jj_bet = torch.cat([torch.cat([I3, Z3], dim=-1),
                        torch.cat([Z3, RiT], dim=-1)], dim=-2)
    Ji_gps = torch.cat([torch.cat([Z3, Z3], dim=-1),
                        torch.cat([Z3, I3], dim=-1)], dim=-2)

    is_gps = (e.kind == 1)[:, None]
    r = torch.where(is_gps, torch.cat([torch.zeros_like(r_R), ti - e.z_t], -1),
                    torch.cat([r_R, r_t], -1))
    Ji = torch.where(is_gps[..., None], Ji_gps, Ji_bet)
    Jj = torch.where(is_gps[..., None], torch.zeros_like(Jj_bet), Jj_bet)

    w = torch.cat([e.w_rot[:, None].expand(E, 3), e.w_trans[:, None].expand(E, 3)], -1)
    w = torch.where(e.valid[:, None], w, torch.zeros_like(w))
    return r, Ji, Jj, w


def _node_sum(K: int, ei: torch.Tensor, ej: torch.Tensor, vi: torch.Tensor,
              vj: torch.Tensor) -> torch.Tensor:
    """Per-node sums of edge terms: zeros.at[ei].add(vi).at[ej].add(vj)."""
    out = torch.zeros((K,) + vi.shape[1:], dtype=vi.dtype, device=vi.device)
    return out.index_add_(0, ei, vi).index_add_(0, ej, vj)


def _cg(A, b: torch.Tensor, M, maxiter: int, tol: float = 1e-5) -> torch.Tensor:
    """Preconditioned CG from x0 = 0 with the stop rule of
    jax.scipy.sparse.linalg.cg: iterate while r.r > tol^2 b.b and k <
    maxiter (r the unpreconditioned residual). All `maxiter` iterations run;
    once the test fails the state is frozen. The divisions are guarded, so a
    frozen state (b = 0 takes no iteration at all) stays free of 0/0."""
    atol2 = tol * tol * torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b
    p = z = M(r)
    gamma = torch.sum(r * z)
    active = torch.ones((), dtype=torch.bool, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    for _ in range(maxiter):
        active = active & (torch.sum(r * r) > atol2)
        Ap = A(p)
        alpha = gamma / torch.where(active, torch.sum(p * Ap), one)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = M(r_n)
        gamma_n = torch.sum(r_n * z_n)
        beta = gamma_n / torch.where(active, gamma, one)
        p_n = z_n + beta * p
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        gamma = torch.where(active, gamma_n, gamma)
    return x


def _solve_body(q0, t0, n_nodes, edges: EdgeSet, n_gn_iters, n_cg_iters, anchor_weight,
                damping, group=None):
    """GN body. With `group` (the reference's `axis_name`) `edges` is this
    rank's block of the edge axis and the per-node sums (g, D, every Hv)
    complete over the group; None runs the single-process code."""
    K = q0.shape[0]
    dev, dt = q0.device, q0.dtype
    live = torch.arange(K, device=dev) < n_nodes
    ei, ej = edges.i.long(), edges.j.long()
    eye6 = torch.eye(6, dtype=dt, device=dev)
    anchor = torch.zeros((K,), dtype=dt, device=dev)
    anchor[0].fill_(anchor_weight)  # a fill, not a host-to-device copy
    diag = (damping + anchor)[:, None]  # (K,1): damping + node-0 prior

    q, t = q0, t0
    for _ in range(n_gn_iters):
        r, Ji, Jj, w = _edge_terms(q, t, edges)
        wr = w * r
        g = _node_sum(K, ei, ej, torch.einsum("eri,er->ei", Ji, wr),
                      torch.einsum("eri,er->ei", Jj, wr))
        Hii = torch.einsum("eri,er,erj->eij", Ji, w, Ji)
        Hjj = torch.einsum("eri,er,erj->eij", Jj, w, Jj)
        g, D = allsum((g, _node_sum(K, ei, ej, Hii, Hjj)), group)
        D = D + diag[..., None] * eye6
        # inv_ex: torch.linalg.inv checks its info on the host
        D_inv = torch.linalg.inv_ex(D + 1e-6 * eye6).inverse

        def Hv(v, Ji=Ji, Jj=Jj, w=w):
            Jv = (torch.einsum("erc,ec->er", Ji, v[ei])
                  + torch.einsum("erc,ec->er", Jj, v[ej])) * w
            out, = allsum((_node_sum(K, ei, ej, torch.einsum("erc,er->ec", Ji, Jv),
                                     torch.einsum("erc,er->ec", Jj, Jv)),), group)
            return out + diag * v

        def Mv(v, D_inv=D_inv):
            return torch.einsum("kij,kj->ki", D_inv, v)

        delta = _cg(Hv, -g, Mv, n_cg_iters)
        delta = torch.where(live[:, None], delta, torch.zeros_like(delta))
        q = so3.quat_normalize(so3.quat_mul(q, so3.quat_exp(delta[:, :3])))
        t = t + delta[:, 3:]
    return q, t


def solve_pose_graph(
    poses: se3.Pose,  # (K,) batched
    n_nodes: torch.Tensor,  # () live node count
    edges: EdgeSet,
    n_gn_iters: int = 5,
    n_cg_iters: int = 30,
    anchor_weight: float = 1e6,
    damping: float = 1e-3,
) -> se3.Pose:
    """Full GN re-solve of the graph. Nodes >= n_nodes are frozen."""
    q, t = _solve_body(poses.q, poses.t, n_nodes, edges, n_gn_iters, n_cg_iters,
                       anchor_weight, damping)
    return se3.Pose(q, t)


def sharded_solve_pose_graph(
    mesh,
    poses: se3.Pose,
    n_nodes: torch.Tensor,
    edges: EdgeSet,
    axis: str = "dp",
    n_gn_iters: int = 5,
    n_cg_iters: int = 30,
    anchor_weight: float = 1e6,
    damping: float = 1e-3,
) -> se3.Pose:
    """Distributed graph solve over the `axis` group of a DeviceMesh: every
    rank holds the whole graph as every other does (poses, count, the full
    edge set) and solves with its contiguous block of the edge axis, the
    per-node reductions summed over the group. Every rank returns the same
    poses, equal to `solve_pose_graph`'s up to the order of the sums. The
    edge capacity must divide by the group's size, else ValueError."""
    group = mesh.get_group(axis)
    rank, n = rank_and_size(group)
    E = edges.capacity
    if E % n:
        raise ValueError(f"edge capacity {E} does not divide over {n} ranks")
    b = E // n
    local = EdgeSet(*(x[rank * b:(rank + 1) * b] for x in edges[:-1]), edges.count)
    q, t = _solve_body(poses.q, poses.t, n_nodes, local, n_gn_iters, n_cg_iters,
                       anchor_weight, damping, group=group)
    return se3.Pose(q, t)


def between_measurement(pose_i: se3.Pose, pose_j: se3.Pose) -> se3.Pose:
    """Relative measurement Z_ij = T_i^-1 T_j (for odometry edges)."""
    return se3.compose(se3.inverse(pose_i), pose_j)
