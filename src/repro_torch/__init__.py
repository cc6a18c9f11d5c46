"""PyTorch + CUDA port of the GNN data-movement reproduction, for the H100.

It stands beside the JAX package ``repro``, which is its reference, and
imports none of it: what it needs of ``repro``'s NumPy layer it keeps as
its own copy.  Layout mirrors ``repro``:

* :mod:`repro_torch.kernels` — the hand-written CUDA C++ kernels for
  ``sm_90a``: the GNN layer (fused K1, unfused K2 + K3), the trace
  segment reduce K4, flash attention K5 and the embedding bag K6, their
  geometry, plain versions and ``ops`` wrappers;
* :mod:`repro_torch.core` — the closed forms (``engn``, ``hygcn``,
  ``awb_gcn`` and the kernels' ``spmm_tiled_cta`` / ``spmm_unfused_cta``),
  the composition layer, the exact-trace scheduler and the conformance
  harness;
* :mod:`repro_torch.api` — the scenario front door
  (``python -m repro_torch.api``) for tile, full and trace scenarios;
* :mod:`repro_torch.models` / :mod:`repro_torch.configs` — the dense
  transformer that serves SmolLM-135M (prefill through K5, decode over KV
  caches), DLRM serving (every embedding bag through K6, retrieval
  scoring), their published configs and the recsys shape cells;
* :mod:`repro_torch.data` / :mod:`repro_torch.params` — seeded Cora-sized
  inputs, the trace datasets' graph generators, seeded Criteo batches, and
  the GCN, transformer and DLRM weights carried across from the JAX
  layout.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
