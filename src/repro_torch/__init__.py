"""PyTorch + CUDA port of the GNN data-movement reproduction, for the H100.

It stands beside the JAX package ``repro``, which is its reference, and
imports none of it: what it needs of ``repro``'s NumPy layer it keeps as
its own copy.  Layout mirrors ``repro``:

* :mod:`repro_torch.kernels` — the GNN layer kernels (fused K1, unfused
  K2 + K3) in CUDA C++ for ``sm_90a``, their geometry, plain versions and
  the ``ops`` wrappers;
* :mod:`repro_torch.core` — the closed forms the kernels are held to
  (``spmm_tiled_cta``, ``spmm_unfused_cta``) and the conformance harness;
* :mod:`repro_torch.data` / :mod:`repro_torch.params` — seeded Cora-sized
  inputs and the GCN weights carried across from the JAX layout.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
