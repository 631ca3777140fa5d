"""Device rules shared by every module of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch


def require_cuda() -> None:
    """Raise unless a CUDA device is available. Nothing in the port moves
    work to the CPU when CUDA is missing."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required (torch.cuda.is_available() is False)")


def default_device() -> torch.device:
    """The device of every entry point called without `device=`: the CUDA
    card. Raises when there is none; the CPU is used only when a caller asks
    for it (`device="cpu"`)."""
    require_cuda()
    return torch.device("cuda")


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """`device`, or `default_device()` when it is None."""
    return default_device() if device is None else torch.device(device)


def use_kernel(*tensors: torch.Tensor) -> bool:
    """The dispatch rule of every kernel wrapper: False when all inputs lie on
    the CPU (the wrapper runs the kernel's plain PyTorch version), True when
    all lie on a CUDA device (the wrapper launches the kernel or raises).
    Any other mix raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(
        f"kernel inputs must all lie on the CPU or all on one CUDA device; got "
        f"{sorted(str(t.device) for t in tensors)}"
    )
