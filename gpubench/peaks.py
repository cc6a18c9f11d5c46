"""Peaks of one NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates,
no sparsity, at the full 700 W power limit).  The card's own power limit
is read beside every run (:func:`power_limit`)."""

from __future__ import annotations

import subprocess

#: FLOP/s by the dtype a product computes in.
FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
         "float16": 989e12, "float64": 67e12}
#: HBM3 bytes/s.
HBM_BYTES_PER_S = 3.35e12


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or why
    there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "no card listed"
