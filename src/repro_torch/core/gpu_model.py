"""The paper's methodology on an NVIDIA H100: the machine model.

The reference (``core/tpu_model.py``) splits a step's data movement as the
paper does and turns each part into seconds on a TPU v5e pod:

=====================  =============================================
paper                  this module
=====================  =============================================
L2 <-> L1 traffic      HBM bytes (operand bytes)  -> ``memory_s``
on-array (L1-L1)       tensor-core FLOPs          -> ``compute_s``
inter-PE ring (RER)    NVLink / network bytes     -> ``collective_s``
=====================  =============================================

:class:`GPUHardware` holds one card's constants and :func:`roofline` makes
the three terms of one rank from the dry run's counts
(``repro_torch.launch.dryrun``): its FLOPs, its operand bytes and the wire
bytes its collectives receive.  Two things differ from the reference's
``roofline``: the compute peak is the one of the step's compute dtype, and
the collective rate is the fabric's (NVLink within one node of
:attr:`GPUHardware.node_cards` cards, the network beyond it).  The report's
:attr:`RooflineReport.roofline_fraction` divides by its own peak.

The collective byte models stay in :mod:`repro_torch.core.comm_model`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Mapping

__all__ = ["GPUHardware", "H100_SXM", "RooflineReport", "roofline",
           "dtype_key", "tensor_core_padding_waste"]


def dtype_key(dtype) -> str:
    """``"bf16"``, ``"tf32"`` or ``"fp32"`` for those names or for a torch
    dtype (``torch.bfloat16``, ``torch.float32``)."""
    name = str(dtype).removeprefix("torch.")
    return {"bfloat16": "bf16", "float32": "fp32"}.get(name, name)


@dataclass(frozen=True)
class GPUHardware:
    """One card's constants.  The defaults are NVIDIA's data sheet for the
    H100 SXM at 700 W, dense tensor-core rates."""

    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12        # FLOP/s, dense
    peak_flops_tf32: float = 495e12
    peak_flops_fp32: float = 67e12         # CUDA cores, no tensor cores
    hbm_bandwidth: float = 3.35e12         # bytes/s
    hbm_bytes: int = 80 * 10**9
    nvlink_bandwidth: float = 450e9        # bytes/s each way (NVLink 4)
    network_bandwidth: float = 50e9        # bytes/s a card (NDR 400 Gb/s)
    node_cards: int = 8                    # cards one NVLink domain joins
    sm_count: int = 132
    smem_bytes_per_sm: int = 228 * 1024
    l2_bytes: int = 50 * 2**20
    mma_m: int = 64                        # wgmma's M tile

    def peak_flops(self, dtype: str) -> float:
        """The peak of ``dtype``: ``"bf16"``, ``"tf32"`` or ``"fp32"``
        (a torch dtype's name also serves: ``float32`` is ``fp32``)."""
        key = dtype_key(dtype)
        rates = {"bf16": self.peak_flops_bf16, "tf32": self.peak_flops_tf32,
                 "fp32": self.peak_flops_fp32}
        if key not in rates:
            raise ValueError(f"no peak for dtype {dtype!r}; expected one of "
                             f"{sorted(rates)}")
        return rates[key]

    def fabric(self, chips: int) -> str:
        """``"nvlink"`` when ``chips`` fit one node, else ``"network"``."""
        return "nvlink" if chips <= self.node_cards else "network"

    def fabric_bandwidth(self, fabric: str) -> float:
        rates = {"nvlink": self.nvlink_bandwidth,
                 "network": self.network_bandwidth}
        if fabric not in rates:
            raise ValueError(f"fabric {fabric!r}: expected one of "
                             f"{sorted(rates)}")
        return rates[fabric]


H100_SXM = GPUHardware()


@dataclass(frozen=True)
class RooflineReport:
    """Three-term roofline of one (arch x shape x mesh) cell, per rank:

      compute_s    = FLOPs a rank / peak of the compute dtype
      memory_s     = operand bytes a rank / HBM bandwidth
      collective_s = wire bytes a rank / the fabric's bandwidth
    """

    cell: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops: float = 0.0
    peak_flops: float = H100_SXM.peak_flops_bf16
    peak_dtype: str = "bf16"
    fabric: str = "nvlink"
    meta: Mapping[str, object] = field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic overlapped bound: the slowest term gates the step."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def step_time_serial_s(self) -> float:
        """Pessimistic bound with zero overlap."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs of all ranks."""
        total = self.hlo_flops_per_chip * self.chips
        return self.model_flops / total if total else float("nan")

    @property
    def roofline_fraction(self) -> float:
        """The useful FLOPs' time at this report's peak over the step time;
        1.0 means compute-bound with no wasted FLOPs."""
        if not self.model_flops:
            return float("nan")
        ideal = self.model_flops / (self.chips * self.peak_flops)
        return ideal / self.step_time_s if self.step_time_s else float("nan")

    def row(self) -> dict[str, object]:
        return {
            "cell": self.cell,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "model_flops": self.model_flops,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_dtype": self.peak_dtype,
            "fabric": self.fabric,
        }


def roofline(
    *,
    cell: str,
    chips: int,
    flops_per_chip: float,
    hbm_bytes_per_chip: float,
    collective_bytes_per_chip: float,
    model_flops: float = 0.0,
    dtype: str = "bf16",
    fabric: str | None = None,
    hw: GPUHardware = H100_SXM,
    meta: Mapping[str, object] | None = None,
) -> RooflineReport:
    """The report of one rank: compute at ``hw``'s peak for ``dtype``,
    collectives at ``fabric``'s rate (default :meth:`GPUHardware.fabric`
    of ``chips``)."""
    fabric = fabric or hw.fabric(chips)
    peak = hw.peak_flops(dtype)
    return RooflineReport(
        cell=cell,
        chips=chips,
        compute_s=flops_per_chip / peak,
        memory_s=hbm_bytes_per_chip / hw.hbm_bandwidth,
        collective_s=(collective_bytes_per_chip
                      / hw.fabric_bandwidth(fabric)),
        hlo_flops_per_chip=flops_per_chip,
        hbm_bytes_per_chip=hbm_bytes_per_chip,
        collective_bytes_per_chip=collective_bytes_per_chip,
        model_flops=model_flops,
        peak_flops=peak,
        peak_dtype=dtype_key(dtype),
        fabric=fabric,
        meta=dict(meta or {}),
    )


def tensor_core_padding_waste(dim: int, hw: GPUHardware = H100_SXM) -> float:
    """Fraction of tensor-core work wasted padding ``dim`` to ``wgmma``'s M
    tile: the H100's statement of EnGN's array-fitting factor (Fig. 6), as
    the reference's ``mxu_padding_waste`` is the TPU's."""
    padded = math.ceil(dim / hw.mma_m) * hw.mma_m
    return 1.0 - dim / padded
