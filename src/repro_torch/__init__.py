"""PyTorch + CUDA port of the GNN data-movement reproduction, for the H100.

It stands beside the JAX package ``repro``, which is its reference, and
imports none of it: what it needs of ``repro``'s NumPy layer it keeps as
its own copy.  Layout mirrors ``repro``:

* :mod:`repro_torch.kernels` — the hand-written CUDA C++ kernels for
  ``sm_90a``: the GNN layer (fused K1, unfused K2 + K3), the trace
  segment reduce K4, flash attention K5 and the embedding bag K6, their
  geometry, plain versions and ``ops`` wrappers;
* :mod:`repro_torch.core` — the closed forms (the reference's ``engn``,
  ``hygcn``, ``spmm_tiled``, ``spmm_unfused`` and ``awb_gcn``, and the
  kernels' ``spmm_tiled_cta`` / ``spmm_unfused_cta``), the composition
  layer (with the typed-graph ``RelationalGraphModel``), the exact-trace
  scheduler for plain and typed traces, the conformance harness, the
  paper's Figures 3-7 and the Sec. IV golden totals;
* :mod:`repro_torch.analysis` — the static model auditor (``python -m
  repro_torch.analysis``): units, symbol provenance and float64 exactness
  of every closed form, an AST linter and a mutation battery; the
  conformance harness refuses a spec it fails;
* :mod:`repro_torch.api` — the scenario front door
  (``python -m repro_torch.api``) for tile, full, trace, hetero and
  minibatch scenarios, with the paper's figures as named templates and
  conformance checks that run K1-K3;
* :mod:`repro_torch.models` / :mod:`repro_torch.configs` — the dense
  transformer that serves SmolLM-135M (prefill through K5, decode over KV
  caches), DLRM serving (every embedding bag through K6, retrieval
  scoring), their published configs and the recsys shape cells;
* :mod:`repro_torch.data` / :mod:`repro_torch.params` — seeded Cora-sized
  inputs, the trace datasets' graph generators, the minibatch neighbor
  sampler, seeded Criteo batches, and
  the GCN, transformer and DLRM weights carried across from the JAX
  layout.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
