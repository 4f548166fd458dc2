"""Device selection for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``). When no GPU is found and the
caller did not ask for the CPU, they raise instead of carrying on on the
CPU.

Numerics are pinned at the same time: float32 matrix products and
convolutions run in full fp32, never TF32 (cuDNN's fp32 convolutions
default to TF32), so an fp32 run means what it says.
"""

from __future__ import annotations

import subprocess

import torch

__all__ = ["card_power_line", "check_tensor_core_support", "device_name",
           "resolve_device", "set_fp32_precision"]


def set_fp32_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the CPU only
    on request. Raises ``RuntimeError`` when CUDA is asked for (or
    defaulted to) and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    set_fp32_precision()
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_tensor_core_support() -> bool:
    """Reference-compatible probe: is there a GPU with tensor cores
    (compute capability 7.0 or newer)?"""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0)[0] >= 7)


def device_name(device: torch.device) -> str:
    """Human-readable kind of ``device`` (e.g. 'NVIDIA H100 80GB HBM3')."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def card_power_line() -> str:
    """The first card's name and power limit as ``nvidia-smi`` reports
    them (e.g. 'NVIDIA H100 80GB HBM3, 700.00 W'): a card may be capped
    below its full power, which every recorded time has to state."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]
