"""The port's default device: entry points that make tensors from nothing put
them on the card unless the caller names another device. There is no
fallback: without a card, the default raises torch's own error."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """`device` as a torch.device; cuda when it is None."""
    return torch.device("cuda") if device is None else torch.device(device)


def host_to_device(a, device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) on `device`. To the card it goes
    through pinned memory with a non-blocking copy (a copy from pageable
    memory synchronizes); PyTorch's pinned allocator keeps the staging block
    until that copy has run. On the CPU it is a tensor sharing the array's
    memory where it can."""
    t = torch.as_tensor(a)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
