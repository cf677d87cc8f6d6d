"""Process-group bring-up, the device mesh, and the two collectives the
sharded engine steps use (port of agi_lidar_slam_tpu/parallel/distributed.py).

The reference forms its global mesh with `jax.distributed.initialize`; here
each process joins a `torch.distributed` process group and the mesh is a
`DeviceMesh` over its ranks, with dimension names "dp" (the scan's point
axis) and "mp" (the map's slot axis). A sharded function takes the mesh and
works on `mesh.get_group(name)`, the torch counterpart of the reference's
`axis_name`.

Collectives (`allsum`, `all_gather`): the JAX `psum` and `all_gather`. A
function of the engine that takes `group=None` runs exactly its
single-process code: both return their inputs untouched then. `allsum`
completes every partial sum of one linearization with ONE all_reduce: the
tensors are packed into one flat buffer. `collectives` counts the calls that
went to the group.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

collectives = 0  # all_reduce / all_gather / broadcast calls issued to a group

DEFAULT_TIMEOUT_S = 300.0


def _count() -> None:
    global collectives
    collectives += 1


def allsum(xs: Sequence[torch.Tensor], group=None) -> list:
    """Each tensor of `xs` summed over the ranks of `group` (`jax.lax.psum`),
    all in one all_reduce of a packed float32 buffer (the engines' sums are
    f32; integer counts ride as floats, exact below 2**24). With group=None
    the inputs come back as they are."""
    xs = list(xs)
    if group is None:
        return xs
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in xs])
    _count()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, o = [], 0
    for x in xs:
        n = x.numel()
        out.append(flat[o:o + n].reshape(x.shape).to(x.dtype))
        o += n
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's `x` in rank order (`jax.lax.all_gather`
    with a new leading axis)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _count()
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def broadcast_(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """`x` overwritten in place with the group's rank `src`'s; bool tensors go
    as uint8 (the same bytes)."""
    _count()
    buf = x.view(torch.uint8) if x.dtype == torch.bool else x
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return x


def rank_and_size(group) -> tuple[int, int]:
    """This process's rank within `group` and the group's size."""
    return dist.get_rank(group), dist.get_world_size(group)


def default_backend(device) -> str:
    """nccl for a cuda device, gloo for the CPU: the backend follows the
    device asked for, never what the machine happens to have."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_method(coordinator: str) -> str:
    """A `host:port` address as a tcp:// rendezvous; a URL (tcp://, file://)
    as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the process group from the arguments or the reference's
    environment variables (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID).
    Returns False, doing nothing, for one process (no coordinator); True
    once the group is formed.

    `coordinator` is `host:port` (a TCP rendezvous) or an init URL such as
    `file:///path` (a FileStore). The backend defaults to nccl for `device`
    cuda (the default) and gloo for the CPU; a backend this build of torch
    lacks raises. On cuda, the rank's device becomes
    cuda:{LOCAL_RANK or rank % device_count}."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return False
    world = int(num_processes if num_processes is not None
                else os.environ.get("NUM_PROCESSES", 1))
    rank = int(process_id if process_id is not None else os.environ.get("PROCESS_ID", 0))
    device = torch.device("cuda") if device is None else torch.device(device)
    backend = backend or default_backend(device)
    if not dist.is_available() or not dist.is_backend_available(backend):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not available here")
    if device.type == "cuda":
        use_device(local_device(rank))
    dist.init_process_group(backend, init_method=_init_method(coordinator), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def use_device(device: torch.device) -> None:
    """Make `device` this process's card and initialize CUDA on it: a
    DeviceMesh made later keeps it (it picks cuda:LOCAL_RANK only while CUDA
    is uninitialized, and ranks may share a card)."""
    torch.cuda.set_device(device)
    torch.cuda.init()


def local_device(rank: Optional[int] = None) -> torch.device:
    """cuda:{local rank % device count}: LOCAL_RANK where the launcher set
    it, else the global rank."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh_2d(dp: Optional[int] = None, mp: int = 1, device=None):
    """(dp, mp) DeviceMesh over every rank of the process group: "dp" shards
    scan points, "mp" shards map slots. Defaults to all ranks on "dp". The
    device type is cuda unless `device` names the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if dp is None:
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"dp*mp={dp * mp} != ranks={n}")
    dtype = "cuda" if device is None else torch.device(device).type
    if dtype == "cuda":
        use_device(local_device())
    return init_device_mesh(dtype, (dp, mp), mesh_dim_names=("dp", "mp"))
