"""Leaf math, positional encoding, sampling and mesh helpers, and the
host-to-device copy that stops no host thread."""
import torch


def to_device(x, device) -> torch.Tensor:
    """A host array on `device`.  To a CUDA device it goes through pinned
    memory with non_blocking=True, so the copy stops no host thread:
    torch's pinned-memory cache allocates each size once and hands a block
    out again only after the copies from it have completed."""
    t = torch.as_tensor(x)
    if torch.device(device).type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
