"""Device resolution and the card report.

Entry points of the port run on CUDA unless the caller asks for the CPU:
:func:`resolve_device` returns ``cuda`` by default and raises when no card is
present, so a run that meant to measure the card never falls back to the CPU
silently.
"""

from __future__ import annotations

import subprocess

import torch

__all__ = ["resolve_device", "card_report", "full_fp32"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless ``device`` says otherwise; raises if CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def card_report() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them.

    Every timing the port records carries this line: a card set below its
    700 W limit runs slower under load.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def full_fp32() -> None:
    """Keep fp32 products in full fp32 for the plain versions.

    The plain versions are the tolerance oracle of the kernels at 1e-5.
    cuBLAS and cuDNN may route fp32 products through TF32 tensor cores,
    which keep about three decimal digits (~1e-3 relative error), so both
    switches are turned off before a plain version runs.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
