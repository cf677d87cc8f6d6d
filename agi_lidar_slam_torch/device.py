"""The port's default device: entry points that make tensors from nothing put
them on the card unless the caller names another device. There is no
fallback: without a card, the default raises torch's own error."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """`device` as a torch.device; cuda when it is None."""
    return torch.device("cuda") if device is None else torch.device(device)
