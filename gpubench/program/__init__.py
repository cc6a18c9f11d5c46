"""The benchmark's only door into the program (``repro_torch``): the train
cell that the window drives, built as the program's launch path builds it,
and each architecture's batch in the program's own layout
(``program/<arch>.py``, ``-`` as ``_``)."""

from __future__ import annotations

from dataclasses import fields, replace


def train_cell(arch: str, shape: str, model: dict, params, device):
    """``repro_torch.launch.steps.gnn_train_cell(arch, shape, None)`` over
    ``params`` (a tree of tensors in the program's reference layout, which
    the step updates in place), its config the program's own for
    ``shape`` with every size of ``model`` set, and checked to read as
    ``model`` says."""
    from repro_torch.launch import steps

    cfg = steps.gnn_config(arch, shape)
    names = {f.name for f in fields(cfg)}
    unknown = sorted(set(model) - names)
    if unknown:
        raise ValueError(f"{arch}: {unknown} are not fields of "
                         f"{type(cfg).__name__}")
    cfg = replace(cfg, **model)
    for key, value in model.items():
        if getattr(cfg, key) != value:
            raise ValueError(f"{arch}: {key} reads {getattr(cfg, key)!r}, "
                             f"not {value!r}")
    return steps.gnn_train_cell(arch, shape, None, params, cfg=cfg,
                                device=device)
