"""Where the port's entry points put their tensors.

The port runs on the card: an entry point given no ``device`` builds its
state on the current CUDA device, or on the device of a tensor it was
handed. Without a card it raises and names ``device="cpu"``; it never
falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve(device=None, like=None) -> torch.device:
    """``device`` if given; else the device of the tensor ``like``; else
    the current CUDA device. Raises RuntimeError when that needs a card
    and there is none."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pypic_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU (the kernels' plain "
            "versions)")
    return torch.device("cuda")
