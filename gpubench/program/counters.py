"""The program's own counters (``repro_torch.obs``): what it counted in
this process, or None for a program that keeps none."""

from __future__ import annotations

import importlib


def _obs():
    try:
        return importlib.import_module("repro_torch.obs")
    except ModuleNotFoundError as e:
        if e.name != "repro_torch.obs":
            raise
        return None


def read() -> dict | None:
    obs = _obs()
    return None if obs is None else obs.counters()


def reset() -> None:
    """Zero them, where the program keeps them."""
    obs = _obs()
    if obs is not None:
        obs.reset_counters()
