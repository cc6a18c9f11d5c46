"""Checkpointing: atomic save and restore with retention, and restore onto
another device (the reference's ``checkpoint/manager.py`` in PyTorch).

Layout (one directory per step), the reference's:
    <root>/step_000000123.tmp/  -> written, fsynced, then atomically renamed
    <root>/step_000000123/
        manifest.json           tree structure, shapes, dtypes, step, extras
        arrays.npz              the leaves ``leaf_i`` as host numpy arrays

Leaves are numbered in the reference's flatten order
(:func:`repro_torch.tree.tree_flatten`), so a state whose tree matches the
reference's writes a checkpoint the reference restores, and the reverse.
Arrays are saved whole on the host, so a restart may place them on any
device: ``restore(like, device=...)`` moves every leaf there (elastic
restore; the reference takes per-leaf shardings instead).

Retention keeps the newest ``keep`` checkpoints; a crashed write never
corrupts the latest good step because of the tmp-rename protocol.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..tree import tree_flatten, tree_unflatten

__all__ = ["CheckpointManager"]


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, root: str | os.PathLike, *, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *,
             extras: Optional[dict] = None) -> Path:
        leaves, treedef = tree_flatten(tree)
        host = [_host(x) for x in leaves]
        tmp = self.root / f"step_{step:09d}.tmp"
        final = self.root / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz",
                 **{f"leaf_{i}": a for i, a in enumerate(host)})
        manifest = {
            "step": step,
            "n_leaves": len(host),
            "treedef": repr(treedef),
            "shapes": [list(a.shape) for a in host],
            "dtypes": [str(a.dtype) for a in host],
            "time": time.time(),
            "extras": extras or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        # fsync the directory contents before the atomic publish
        for f in tmp.iterdir():
            fd = os.open(f, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
        if final.exists():
            # re-saving an existing step (e.g. the final save landing on a
            # periodic one): replace it wholesale, never partially
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._retain()
        return final

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.root.iterdir():
            if (p.is_dir() and p.name.startswith("step_")
                    and not p.name.endswith(".tmp")):
                out.append(int(p.name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def restore(self, like: Any, *, step: Optional[int] = None,
                device=None) -> tuple[int, Any]:
        """Restore into the structure of ``like`` (a tree of tensors): each
        leaf takes its ``like`` leaf's dtype, on ``device`` if given (any
        device: elastic restore) and otherwise on that leaf's device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:09d}"
        leaves, treedef = tree_flatten(like)
        manifest = json.loads((d / "manifest.json").read_text())
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, target tree "
                f"has {len(leaves)}: structure mismatch")
        restored = []
        with np.load(d / "arrays.npz") as data:
            for i, ref in enumerate(leaves):
                arr = data[f"leaf_{i}"]
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(f"leaf {i}: shape {arr.shape} != "
                                     f"{tuple(ref.shape)}")
                restored.append(torch.from_numpy(arr).to(
                    device=device if device is not None else ref.device,
                    dtype=ref.dtype))
        return step, tree_unflatten(treedef, restored)

    # ------------------------------------------------------------------
    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)
