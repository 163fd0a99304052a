"""Device resolution for the PyTorch/CUDA port.

Counterpart of the device part of ``triton_dist_tpu/runtime/platform.py``.
There a CPU run is a virtual JAX mesh with Pallas in interpret mode; here
every entry point runs on CUDA unless its caller passes ``device="cpu"``,
and a CUDA request on a host without a card raises instead of quietly
running somewhere else.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA card; ``"cpu"`` is honoured only when it
    is asked for. Raises ``RuntimeError`` when CUDA is wanted and missing."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def nvidia_smi_line() -> str:
    """The card's name and power limit, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (one line per visible card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def device_report() -> dict:
    """What a measurement is stamped with: platform, card name, card count."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
