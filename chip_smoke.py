#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; without a card it exits 1 and prints no
result.  Phases, any failure of which ends the run with a non-zero exit:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles the kernels under ``src/repro_torch/csrc``; the
   registers and spills of each instance of the tensor-core kernels, by
   name: bf16 K5 and K1 / K2, and of K3 and K4 (none may spill);
3. kernels vs plain versions: K1 (fused), K2 (aggregate) and K3 (combine)
   on the card, f32 and bf16, at the reference's four kernel-test shapes,
   at two shapes of the cluster schedules (one feature chunk split over 4
   ranks by source blocks; 6 feature chunks) and at the two full-width
   GCN-Cora layers (seeded Cora-sized graph, GCN weights in the reference
   layout), against their plain PyTorch versions;
4. the GNN layer path: the launch counters are zeroed, then the 2-layer
   GCN-Cora forward runs fused and unfused through ``repro_torch.kernels.
   ops``, and the conformance harness holds the kernels' byte schedules to
   their closed forms at all twelve operating points and runs them against
   the fp32 oracle; the counters are read right after, and every layer
   kernel must have launched;
5. times at each Cora layer (CUDA events around one call queued behind a
   device-side sleep, median of 20, warm L2): each kernel
   beside its bound, its plain version and one PyTorch library call that
   computes the same function (timed here only; the port never calls it);
   K1 and K2 also beside their block-dense bound (the schedule's operations
   at the rate of the arithmetic they use, or its traced bytes), K1 beside
   the same-association ``matmul(matmul(A, X), W)``; K1-K3's grids and how
   many of their clusters fit the card at once, and K3's share of its byte
   bound; bf16 K1 and K2 at layer 1; and the fused-minus-unfused time (K2 +
   K3 - K1) against the modelled spill;
6. K4 (the trace segment reduce) against its plain version, bit for bit:
   every trace dataset at the reference test battery's parameters and
   capacities, an int64-index case, a 2^53-scale multiplicity case, the
   boundaries of K4's routes (one tile, the last tile count the shared
   histogram holds and one more, packed and unpacked; 65,536 tiles; the
   packing limit 2^32), and the 10^7-edge graph of phase 7 at all 16
   capacities; each case passes its multiplicities' total, as a trace does,
   or none, and both routes of each kind must occur;
7. the exact-trace path: the counters are zeroed, then
   ``examples/scenarios/trace_smoke.json`` runs through the scenario front
   door (its three pins must hold), and ``TiledGraphModel`` sweeps 16 tile
   capacities of a 10^7-edge power-law graph (V = 10^6) for ``engn``,
   ``hygcn``, ``awb_gcn`` and a GCN-Cora-width ``engn`` stack, plus the
   10^6-edge graph's sweep; the counters are read right after.  Every
   schedule and every term must equal the NumPy engine's bit for bit, and
   the 10^6-edge schedules the per-capacity ``np.unique`` oracle's;
8. times of K4 per capacity of the 10^7-edge sweep (CUDA events, median of
   20) beside its byte bound and its share of it, its route, its plain
   version and ``index_add_``, and the host-clock times of the
   factorization and of the whole sweep under each engine;
9. K5 (flash attention) against its plain version, f32 and bf16: the
   reference test grid, GQA at rep 3 (SmolLM's) and rep 4, softcap 50
   (gemma2's), head dims 16-256, s < 128, gemma2-2b's attention with a
   window that bites (B 1, S 8192, H 8, Hk 4, D 256, window 4096, softcap
   50), and the serving path's own shape (B = 8, S = 1920, H = 9, Hk = 3,
   D = 64), all through the counted wrapper; bf16 cases are also held
   element by element to one bf16 step;
10. the serving path: SmolLM-135M at full width and depth (30 layers,
   d 576), bf16, seeded weights.  The counters are zeroed, then one prefill
   of 8 prompts of 1920 seeded tokens (``max_seq`` 2048, the published
   context) and 128 greedy decode steps run through ``make_prefill_step``
   and ``make_serve_step``; the counters are read right after, and K5 must
   have launched exactly 30 times.  In f32 at B = 2, S = 256 the prefill on
   the card matches the same prefill on the CPU (plain versions, the same
   weights moved over by ``.cpu()``) and 256 decode steps from an empty
   cache, and 4 further decode steps from each cache agree, all to 1e-4;
11. K5's time at the serving shape (CUDA events, median of 20), its
   TFLOP/s and share of its bound, beside the bound, its plain version,
   ``scaled_dot_product_attention`` (timed here only; the port never calls
   it) and the f32 CUDA-core K5 on the same inputs widened to f32, and its
   share of one prefill; K5 at gemma2-2b's attention shape (B 2, S 4096,
   H 8, Hk 4, D 256, softcap 50), beside its bound and plain version; the
   device time of one prefill and of 8 decode steps by kind (K5, cuBLAS
   products, other kernels) under ``torch.profiler``, against the
   unprofiled host time, which gives the device's idle share;
12. K6 (the embedding bag) against its plain version, bit for bit, f32 and
   bf16, through the counted wrapper: the reference test grid, D not a
   multiple of 8, bags of 37 and 64 ids, a 20,000,000-row table with ids
   past 2^24 (int64 row offsets), ids as strided slices of a (B, 26, hot)
   tensor written into strided output slots, and both serving batches at
   hot 1; f32 also against ``embedding_bag_ref`` (take, then sum) at 1e-6;
13. the DLRM serving path: DLRM-MLPerf at its published widths with the
   five 40M-row tables cut to 20M rows (``DLRM_ROW_CAP``; 53.34 GB of f32
   tables drawn on the card from a seed).  The counters are zeroed, then
   200 ``serve_p99`` requests (B = 512) and 5 ``serve_bulk`` batches
   (B = 262,144) of seeded Criteo batches go through ``dlrm.serve`` (copy
   in, forward, logits back), and one ``retrieval_cand`` call scores 10^6
   candidates; the counters are read right after, and K6 must have launched
   exactly 26 times per forward.  The last ``serve_bulk`` logits equal the
   same forward with the plain embedding bag bit for bit; at every table
   capped at 65,536 rows the f32 logits on the card match the CPU's to 1e-4
   (B = 512), and the retrieval scores match the CPU's to 1e-5;
14. K6's time per table at both serving batches (CUDA events, median of 20)
   beside its byte bound (the distinct rows the batch reads, its ids and
   its output), its plain version and ``torch.nn.functional.embedding_bag``
   (timed here only; the port never calls it); the device time of one
   ``serve_bulk`` request and of 8 ``serve_p99`` requests by kind (K6,
   cuBLAS products, copies, other kernels) under ``torch.profiler``,
   against their unprofiled host time;
15. the paper's figures and front-door conformance: the counters are
   zeroed, then ``python -m repro_torch.api`` runs in process on
   ``examples/scenarios/comparison.json`` on the card (exit 0, its five
   pins held, and the ``spmm_tiled`` row's conformance block checked and
   ok against ``spmm_tiled_cta``: K1, K2 and K3 must have launched); the
   registry crosscheck runs with the harness on the card (the five Sec. IV
   goldens at ratio 1.0, modelled HBM bytes equal to measured); every
   ported template (Figures 3-7, ``comparison``, ``cora_end_to_end``,
   ``cora_trace``) and ``sweep_accelerators()`` is evaluated, timed on the
   host clock (median of 20) and its grids' SHA-256 held to a digest
   pinned from the JAX reference; the phase's launches join the counts;
16. the static model auditor and the conformance preflight: the
   in-process ``python -m repro_torch.analysis --strict`` (the five
   registered dataflows and the composition forms strict-clean, HyGCN's 4
   Table IV findings and EnGN's ``M_prime`` waived; the kernel specs
   ``spmm_tiled_cta`` / ``spmm_unfused_cta`` clean; the lint of
   ``src/repro_torch/core`` and ``src/repro_torch/distributed`` clean;
   every mutant of the battery caught),
   the provenance table equal to ``DESIGN.md``'s committed appendix, the
   harness on the card passing its preflight with phase 4's 228 records
   (204 schedule and boundary records and 24 ``collective_wire`` records
   at 0 bytes; equal to the records with the gate bypassed), and a
   ``drop-sigma``
   mutant of ``spmm_tiled_cta`` swapped into the registry refused before
   anything launches (every launch count unchanged); the host time of a
   cold ``audit_registry()`` and of the mutation battery;
17. typed traces through K4: ``typed_power_law`` at ogbn-mag's node and
   edge counts and its four relation types (V = 1,939,743, E =
   21,111,007, R = 4, seed 0; the repo's seeded power law, not the
   dataset).  The counters are zeroed, then every relation's schedules at
   the 16 capacities V/2 ... V/2^16 come from K4 (R x 16 launches),
   ``examples/scenarios/hetero_smoke.json`` runs through the front door on
   the card (its four pins held) and the ``rgcn_cora`` template is
   evaluated (its grids' SHA-256 held to a digest pinned from the JAX
   reference); the counters are read right after.  The torch-engine
   schedules equal the NumPy engine's bit for bit, relation by relation;
   the relations' edge counts sum to E; at the smallest, middle and
   largest capacity each relation's schedule equals that of a
   ``GraphTrace`` built independently from the edges of that relation.
   Times: generation, typed factorization, the torch- and NumPy-engine
   sweeps (host clock), K4 summed over the 64 launches (CUDA events,
   median of 20) beside its byte bound, and ``RelationalGraphModel`` for
   ``engn``, ``hygcn`` and ``awb_gcn`` over the 16 capacities;
18. the design-space tuner: the resolved-trace LRU and the counters are
   cleared, then ``examples/scenarios/tune_smoke.json`` runs through
   ``python -m repro_torch.api --tune`` in process (exit 0, both pins, 4
   K4 launches), the ``tune_cora`` template is evaluated, and the hetero
   tune of the reference's tests (typed_blocks, R = 2, 24 candidates, 6 K4
   launches) equals the same tune on the CPU.  At full scale,
   benchmarks/tune.py's big tune (five dataflows, spill, halo 1, widths
   64-32-16) runs cold over the 10^7-edge graph at its 16 capacities, 80
   candidates: exactly 1 trace build, 1 factorization, 16 schedule computes
   and 16 K4 launches; the result equals the same tune with
   ``device="cpu"`` (K4's plain version) bit for bit, its best point the
   ``np.argmin`` over the 80 concrete scenarios evaluated in one call, and
   its best point and frontier digest the JAX reference's pin
   (``BIG_TUNE_PIN``).  Times: the cold tune split into generation,
   factorization, upload and tune, the K4 schedules and the closed forms
   each rerun alone, the CPU-device tune (host clock), and K4 over its 16
   launches beside its byte bound (CUDA events);
19. the serve engine and the disk cache: benchmarks/serve.py's
   24-scenario pool served cold from 16 client threads (6 K4 launches,
   every one from the dispatcher thread, each a schedule compute), then its
   load (1,500 requests of 1-3 scenarios, seed 0, 16 clients, 2 ms window)
   warm: every served result equal to serial ``evaluate_scenarios`` on the
   card, each window's evaluations equal to its distinct scenarios' plan
   groups and tunes, no K4 launch; served scenarios/s, p50 and p99 request
   latency, the serial loop's scenarios/s and the speedup (host clock).
   The 80 concrete big-tune scenarios from 16 clients at once against a
   cold LRU: 1 trace build, 1 factorization, 16 schedule computes and K4
   launches, results equal to serial.  With ``REPRO_TORCH_TRACE_CACHE`` at
   a fresh directory, a cold resolve and 16 schedules of the 10^7-edge
   graph store it; after the LRU is cleared the warm pass has 0 builds, 0
   factorizations, 16 disk hits, 0 K4 launches and equal schedules (the
   cache's bytes, cold and warm host times).  Every other phase runs with
   the disk cache off;
20. gemma2-2b served at full width and depth through the architecture
   registry (``get_arch("gemma2-2b").make_config()``: 26 layers, d 2304, 8
   heads, 4 kv heads, head dim 256, d_ff 9216, vocab 256,000, a 4096-token
   window on the local half of the stack, soft-caps 50 and 30; bf16,
   weights drawn on the card from seed 0) at the ``prefill_32k`` shape cut
   to B 8 (``GEMMA2_BATCH``).  After one warm-up prefill the counters are
   zeroed, then one prefill of 8 x 32,768 seeded tokens (``max_seq``
   32,800) and 32 greedy decode steps run through ``make_prefill_step``
   and ``make_serve_step``; the counters are read right after, and K5 must
   have launched exactly 26 times, all in the prefill.  Prefill time and
   tokens/s, decode step p50 and p99, peak device memory (at most 70 GB),
   and the device time of one prefill and of 8 decode steps by kind under
   ``torch.profiler``.  A further prefill keeps the q, k, v its first local
   and first global layer hand K5, and its caches must hold them exactly
   (the ring: slot p % 4096 holds position p of the last 4096).  The
   served logits (the prefill's and the 32 decode steps') are held to one
   causal pass of the prefill path over the 32,800 fed tokens at the bf16
   tolerance, 3e-2.  In f32, at full width and vocab with the depth cut
   to 4 layers (2 pattern groups): the prefill logits on the card (K5)
   match the CPU's (plain version) at B 1, S 256; and a prefill of 3,968
   tokens followed by 256 decode steps to 4,224, which wrap the 4,096-slot
   ring, matches ``forward`` over the whole 4,224 tokens (whose K5 applies
   the window) at every step, all to 1e-4;
21. K5 on the served prefill's own q, k, v per layer kind (B 8, S 32,768,
   H 8, Hk 4, D 256, softcap 50; local window 4096 and global), held
   through the counted wrapper to its plain version computed one batch
   entry and one kv head group at a time (bf16 tolerance and the one-step
   element gate), and timed with CUDA events, median of 20, beside its
   bound (operations at the bf16 rate over the key positions the window
   admits) and its share of one prefill; K5 and its plain version at
   phase 9's windowed gemma2 case (S 8192).  The library time is PyTorch's
   compiled ``flex_attention`` (soft-cap ``score_mod``, causal and window
   block mask, ``enable_gqa``) on the same inputs, or the error it raised;
22. the workload bridges on the card: ``python -m repro_torch.api
   --workload gemma2-2b --workload dlrm-mlperf`` and ``--workload gcn-cora
   --shape full_graph_sm --shape molecule`` run in process with ``--device
   cuda`` and ``--device cpu`` (results equal bit for bit); the trace
   reading of gcn-cora's ``full_graph_sm`` and ``molecule`` cells
   (``to_scenarios(graph_kind="trace")``, every dataflow) and of its
   ``ogb_products`` cell (a seeded ``power_law`` graph at V 2,449,029, E
   61,859,140) is evaluated on the card, its schedules counted by K4, and
   held to the same batch on the CPU bit for bit; the counters are zeroed
   before and read after, and K4 must have launched.  Host times of the
   ogb_products graph's generation, factorization and evaluation, and K4's
   time at its capacity beside its byte bound.  The grid of
   ``workload_scenarios()`` over all ten architectures is held to a
   SHA-256 pinned from the JAX reference;
23. the sharded trace pipeline (``repro_torch.distributed.trace_shard``):
   the counters are zeroed, then the drift gate holds the sharded
   factorization of phase 7's 10^7-edge graph at 1 and 4 shards and
   ``default_shard_count()`` to the single-host one (values, order,
   dtypes); one ``power_law_sharded`` scenario through the front door on
   the card equals the same scenario on ``power_law_stream``, with
   ``meta["trace"]["edge_list_free"]`` true; benchmarks/trace_scale.py's
   10^8-edge row (V 10^7, seed 0, alpha 1.6; no cut) is built
   edge-list-free and K4 schedules its 16 capacities V/2 ... V/2^16 (16
   launches), bit-identical to ``engine="sharded"`` in all four fields;
   at phase 17's ogbn-mag size ``typed_sharded_schedule_counts`` equals
   K4's counts relation by relation (64 launches); the counters are read
   right after.  Host times of generation and sort, exchange and
   factorization, the CSR, the sharded and K4 sweeps; the shard count, U
   and peak RSS; K4 per capacity (CUDA events, median of 20) beside its
   byte bound, its share of it and its route;
24. the GNN models, f32: the counters are zeroed, then GCN, GatedGCN,
   MeshGraphNet and EquiformerV2 at their published configs
   (``get_arch(name).make_config``, ``d_in`` the shape's ``d_feat``;
   seeded weights from ``params.gnn_params``) run forward and loss on the
   card and on the CPU with the same weights, on ``full_graph_sm`` (a
   seeded 2,708-node, 10,556-edge power-law graph, 1,433 features) and on
   ``molecule`` (128 graphs of 30 nodes and 64 edges, ``molecule_batch``,
   per-graph readout; EquiformerV2's Wigner blocks from the positions),
   held at 1e-4 relative and finite; then GCN at ``ogb_products`` whole
   (phase 22's 61,859,140 seeded edges plus one self-loop per vertex,
   2,449,029 nodes, 100 features, 47 classes): logits card vs CPU at
   1e-4, forward time (CUDA events, median of 5) beside its byte bound,
   peak device memory and the device time by kind under
   ``torch.profiler``; the reckoning of why the other three models do not
   fit that shape on one card.  The counters are read right after and
   must all be 0: the reference's GNN models reach no Pallas kernel.
25. qwen3-moe-30b-a3b, bf16, from the registry at full width and all 48
   layers (``params.draw_transformer``, seed 0: 60.44 GB drawn on the
   card, the std of one ``w_gate`` and one ``w_down`` slice within 2% of
   ``fan_in ** -0.5``): the memory reckoning behind the batch cut, one
   warm-up prefill, then with the counters zeroed one ``prefill_32k``
   prefill of B x 32,768 seeded tokens and 32 greedy decode steps; K5 must
   launch exactly 48 times, all in the prefill.  Prefill ms and tokens/s,
   decode p50 / p99, peak device memory, each layer's share of dropped
   assignments, and one prefill's and 8 decode steps' device time by kind
   (``torch.profiler``).  Checks: (a) at the first and the last layer, on
   the served prefill's own MoE input, the keep mask and slots bit-
   identical to a stable argsort's ranks and the output within 3e-2 of a
   per-expert fp32 loop over the kept tokens; (b) K5 on layer 0's own q,
   k, v held to its plain version one batch entry and query head at a time
   (bf16 tolerance and the one-step element gate), and timed beside its
   bound; (c) ``moe_ffn_capacity`` against ``moe_ffn_reference`` in f32 at
   full width, T 512, capacity factor 16, within 1e-5; (d) f32 at full
   width and vocab with 2 layers, card vs CPU with the same weights: the
   router's top-8 indices equal, then the prefill logits and every cache
   entry (B 1, S 256) and 8 decode steps within 1e-4;
26. arctic-480b, bf16, full width with its depth cut 35 -> 2 (54.90 GB
   drawn): ``prefill_32k`` at B 1 and 8 decode steps, K5 exactly 2
   launches, the same times, drops and peak memory, and check (a) at layer
   0 with the dense residual branch added to both sides;
27. the training substrate on the card: AdamW (clipping, cosine schedule,
   weight decay, in place and not), SGD and the int8 compression against
   the same calls on the CPU; a CUDA training state checkpointed, restored
   onto the CPU and back, equal leaf for leaf; K6's autograd ``Function``
   at DLRM-MLPerf's widths on 26 tables of 65,536 rows at B 512: forward
   bit-identical to the plain version, table gradient (``index_add_``)
   within 1e-5 of autograd through the plain gather-and-add;
28. SmolLM-135M trained at full width and depth at ``train_4k`` (S 4,096,
   B cut 256 -> 8), bf16 compute, remat "full", through
   ``launch.train.train`` with a checkpoint every 2 steps and a failure
   injected at step 3: the history (before and after the rollback) within
   1e-5 of an uninterrupted run's, K5 launched 0 times (training attention
   is the chunked plain path, as in the reference); step p50 / p99,
   tokens/s, peak memory and the batch the card's memory admits, a step's
   device time by kind; in f32 at 2 layers (full width and vocab, B 2, S
   256) 3 steps on the card against the CPU from the same weights, losses
   and parameters within 1e-4;
29. the four GNNs (GCN-Cora with a failure injected, GatedGCN,
   MeshGraphNet, EquiformerV2) trained at their published configs on a
   2,708-node, 10,556-edge power-law graph through the trainer, step time
   and peak memory, and 5 steps card vs CPU from the same weights (losses
   within 1e-4); no kernel launches;
30. DLRM-MLPerf trained at published widths and ``train_batch`` (B
   65,536) with every table capped at 4,000,000 rows (49.5 GB of weights,
   gradients and moments): K6 exactly 26 launches a step, step time,
   samples/s, peak memory and a step's device time by kind (K6, the
   ``index_add_`` backward, cuBLAS, the optimizer); 3 steps in f32 at
   65,536-row tables, B 512, card vs CPU, losses within 1e-4;
31. the distributed substrate: one NCCL rank a visible card (world size 1
   here, every collective a real one-rank NCCL call), after phase 30's
   memory is freed; the kernels built by phase 2.  DLRM-MLPerf through
   ``vocab_parallel_embeddings`` (phase 13's cut where the published
   tables do not fit a card's shards): K6 on each rank's shards bit for
   bit against its plain version, exactly 26 K6 launches a forward, the
   logits bit-identical to ``serve`` on the same tables at world size 1 and
   within 1e-4 of one card at 65,536-row tables; SmolLM-135M through the
   policy path at phase 10's prefill, exactly 30 K5 launches when the heads
   divide the ranks (context parallelism otherwise, none), the logits
   bit-identical at world size 1, 8 sharded decode steps within 3e-2, and
   in f32 at B 2 within 1e-4; one qwen3-moe-30b-a3b layer through
   ``moe_ffn_ep`` against ``moe_ffn_capacity`` (bit-identical); the ring
   and all-gather SpMM at ogb_products (F 100) against
   ``gather_scatter_sum`` (1e-5) with the collective ledger equal to
   ``ring_spmm_traffic`` and ``spmm_feature_allgather``, and their times;
   a ring hop, GPipe and its gradient, the query-offset attention and the
   spec trees.  It prints the world size, NCCL's version and the ledger;
32. training under a sharding policy (``launch.steps``), one NCCL rank a
   visible card: on one card SmolLM-135M at ``train_4k`` (B 8) and
   gemma2-2b at full width and depth (bf16 state, drawn a block at a time)
   take 2 policy steps each against the single-device step on the same
   weights (the first loss bit-identical, then 1e-5 / 3e-2), with host
   ms a step, peak memory and the ledger; DLRM-MLPerf at 4M-row tables and
   B 65,536 takes 3, K6 bit-identical on every shard, exactly 26 K6
   launches a step, the zero rows exactly zero, against phase 30's
   single-device step within 1e-5; then ``minibatch_lg``: a Reddit-sized
   power-law CSR, 1,024 seeds sampled with fanout (15, 10) into (169,984,
   168,960), and one step of each GNN at its published config, held card
   vs CPU within 1e-4 (EquiformerV2 at 64 seeds, its backward's memory).
   On more cards the rank program runs on a (2, n / 2) mesh and adds
   gemma2-2b at 2 layers in f32 and DLRM at 65,536-row tables against one
   card (1e-4).

The last three lines of standard output are the ``kernels`` JSON line, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.core.gpu_model import H100_SXM  # noqa: E402

#: f32 against the fp32 plain versions (sums in another order); bf16 allows
#: one bf16 rounding of the output (and of the spilled aggregate).
TOLERANCE = {"f32": 1e-5, "bf16": 3e-2}
#: The reference's fused-kernel test shapes (n, f, t, block_n, block_k).
TEST_SHAPES = ((256, 32, 8, 128, 128), (512, 64, 16, 128, 256),
               (512, 128, 32, 256, 256), (1024, 16, 7, 256, 512))
#: Two shapes of the cluster schedules: one feature chunk whose 16 source
#: blocks split over 4 ranks (32 destination blocks), and 6 feature chunks,
#: not a power of two (in bf16 X's 1400-byte rows start off 16-byte
#: boundaries).
CLUSTER_SHAPES = ((2048, 24, 5, 64, 128), (1024, 700, 9, 64, 128))
#: Published H100 SXM peaks at 700 W (the machine model,
#: ``core/gpu_model.H100_SXM``): HBM bytes/s, fp32 (non-tensor) op/s.
PEAK_BYTES_PER_S = H100_SXM.hbm_bandwidth
PEAK_F32_OPS_PER_S = H100_SXM.peak_flops_fp32
#: Published H100 SXM TF32 dense tensor-core peak at 700 W; K1 and K2 take
#: three TF32 products per f32 product (3xTF32).
PEAK_TF32_OPS_PER_S = H100_SXM.peak_flops_tf32
#: K4's integer operations per pair: two divisions (each a multiply and a
#: shift in the kernel), three compares, the flag or, and two adds.  They are set against the fp32 non-tensor peak:
#: the table has no integer rate outside the tensor cores, and the bound is
#: bytes by a factor of about 40 either way.
K4_OPS_PER_PAIR = 8
#: The reference trace battery's datasets and parameters
#: (tests/test_trace_engine.py), without the sharded build.
TRACE_DATASETS = {
    "power_law": {"n_nodes": 1200, "n_edges": 9000, "seed": 1, "alpha": 1.5},
    "power_law_stream": {"n_nodes": 1200, "n_edges": 9000, "seed": 1,
                         "alpha": 1.5},
    "cora": {},
    "molecule": {"batch": 16, "n_nodes": 12, "n_edges": 30},
    "ring_of_tiles": {"n_nodes": 512, "n_tiles": 8},
}
#: The largest single-host case of benchmarks/trace_scale.py, and the
#: 10^6-edge case its per-capacity reference still runs on.
BIG_TRACE = {"n_nodes": 1_000_000, "n_edges": 10_000_000, "seed": 0,
             "alpha": 1.6}
MID_TRACE = {"n_nodes": 100_000, "n_edges": 1_000_000, "seed": 0,
             "alpha": 1.6}
SWEEP_POINTS = 16
TRACE_SMOKE = (Path(__file__).resolve().parent / "examples" / "scenarios"
               / "trace_smoke.json")
TRACE_SMOKE_PINS = (5631360.0, 3763936.0, 898720.0)
TRACE_DATAFLOWS = ("engn", "hygcn", "awb_gcn")
LAYER_KERNELS = ("edge_aggregate", "edge_aggregate_unfused.aggregate",
                 "edge_aggregate_unfused.combine")
KERNELS = {
    "edge_aggregate": {
        "source": "src/repro_torch/csrc/edge_aggregate.cu",
        "replaces": "src/repro/kernels/edge_aggregate.py:48"},
    "edge_aggregate_unfused.aggregate": {
        "source": "src/repro_torch/csrc/edge_aggregate_unfused.cu",
        "replaces": "src/repro/kernels/edge_aggregate_unfused.py:36"},
    "edge_aggregate_unfused.combine": {
        "source": "src/repro_torch/csrc/edge_aggregate_unfused.cu",
        "replaces": "src/repro/kernels/edge_aggregate_unfused.py:52"},
    "segment_reduce.schedule_counts": {
        "source": "src/repro_torch/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:102"},
    "flash_attention": {
        "source": "src/repro_torch/csrc/flash_attention_hopper.cuh",
        "replaces": "src/repro/kernels/flash_attention.py:30"},
    "embedding_bag": {
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:22"},
}
#: K5 against its plain version: the reference's tolerances
#: (tests/test_kernels.py), relative to the largest output.
ATTN_TOLERANCE = {"f32": 2e-5, "bf16": 3e-2}
#: One bf16 step relative to the value: 7 stored significand bits.
BF16_STEP = 2.0 ** -7
#: gemma2-2b's attention where its window bites: (b, s, h, hk, d, block,
#: causal, window, softcap).  The plain version holds a (1, 8, 8192, 8192)
#: f32 score matrix, 2.1 GB.
GEMMA2_WINDOW_CASE = (1, 8192, 8, 4, 256, 128, True, 4096, 50.0)
#: K5's cases (b, s, h, hk, d, block, causal, window, softcap): the
#: reference test grid (tests/test_kernels.py:84-99, block_q = block_k
#: here), GQA at rep 3 and rep 4, softcap 50, gemma2's head dim 256 (at S
#: 512 and at S 8192 with its own 4096-token window, which bites), s < 128,
#: an odd head dim with a ragged last q block, and a non-causal window.
ATTN_CASES = (
    (2, 128, 2, 2, 64, 64, True, None, None),
    (2, 256, 2, 2, 64, 128, True, None, None),
    (2, 256, 2, 2, 32, 64, True, 64, None),
    (2, 512, 2, 2, 128, 128, True, 128, None),
    (2, 128, 9, 3, 64, 64, True, None, None),
    (2, 128, 8, 2, 32, 64, True, None, None),
    (1, 128, 2, 2, 32, 64, True, None, 50.0),
    (1, 512, 8, 4, 256, 128, True, 200, 50.0),
    GEMMA2_WINDOW_CASE,
    (2, 48, 3, 1, 16, 48, True, None, None),
    (2, 96, 4, 2, 48, 96, True, 40, None),
    (2, 128, 4, 2, 32, 64, False, 40, None),
)
#: The serving path: SmolLM-135M, 8 prompts of 1920 tokens, the published
#: 2048-token context, 128 greedy decode steps; the f32 checks at B = 2,
#: S = 256 with 4 further steps.
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_SEQ, SERVE_STEPS = 8, 1920, 2048, 128
CHECK_BATCH, CHECK_PROMPT, CHECK_MORE = 2, 256, 4
PROFILED_STEPS = 8
SERVE_TOLERANCE = 1e-4
#: Published H100 SXM bf16 dense tensor-core peak at 700 W.
PEAK_BF16_OPS_PER_S = H100_SXM.peak_flops_bf16
#: gemma2-2b's attention (src/repro/configs/gemma2_2b.py:16-19: 8 heads, 4
#: kv heads, head dim 256, softcap 50) over a 4096-token causal prefill
#: (its local window is 4096) at B = 2: (b, s, h, hk, d, softcap).
GEMMA2_ATTENTION = (2, 4096, 8, 4, 256, 50.0)
#: The gemma2-2b serving cell: the repo's ``prefill_32k`` shape (S 32,768)
#: with its batch cut from 32 to 8, then 32 greedy decode steps.  At B 32
#: the 13 global layers' KV cache alone is 13 x 32 x 32,768 x 4 x 256 x 2 B
#: x 2 = 55.8 GB, the local layers' rings add 7.0 GB and the weights 5.2
#: GB, and each (32, 32,768, 9,216) FFN temporary 19.3 GB more: it does not
#: fit one 80 GB card.  B 8 is the largest power of two under the peak
#: limit: at B 4 the cell peaked at 23.31 GB (5.23 GB of weights), so B 8
#: takes about 41 GB and B 16 about 78 GB; phase 20 prints the projection
#: from its own peak.
#: reduced: batch (prefill_32k, 32 -> 8).
GEMMA2_BATCH, GEMMA2_STEPS = 8, 32
#: The cell's peak device memory must stay below this (headroom on 80 GB).
GEMMA2_PEAK_LIMIT = 70e9
#: The served bf16 logits against a recomputation through the prefill
#: path: the repo's bf16 tolerance (tests/test_kernels.py), relative to the
#: largest logit; the two paths round the same bf16 activations in another
#: order through 26 layers.
GEMMA2_DECODE_TOLERANCE = 3e-2
#: The f32 checks: full width and vocab, depth cut to 4 layers (2 pattern
#: groups); card vs CPU prefill at B 1, S 256; a prefill of 3,968 tokens and
#: 256 decode steps to 4,224 (past the 4,096-slot ring) against ``forward``
#: over all 4,224.
GEMMA2_CHECK_LAYERS, GEMMA2_CHECK_PROMPT = 4, 256
GEMMA2_RING_PROMPT, GEMMA2_RING_STEPS = 3968, 256
#: K6's cases (v, d, b, hot): the reference test grid
#: (tests/test_kernels.py:148-152), D = 100 (f32 vector loads, bf16 single
#: loads) and D = 30 (single loads in both), bags of 37 (tails of the
#: four-row and 32-id steps) and 64 ids.
BAG_CASES = ((128, 64, 8, 1), (1000, 128, 32, 4), (4096, 256, 16, 8),
             (1000, 100, 32, 4), (777, 30, 16, 3), (5000, 96, 24, 37),
             (5000, 128, 64, 64))
#: K6 in f32 against take-then-sum: the reference test's tolerance.
BAG_REF_TOLERANCE = 1e-6
#: The DLRM cut.  The published Criteo-1TB tables hold 204,184,588 rows,
#: 104.54 GB in f32, more than the card's 80 GB; bf16 tables would change
#: K6's numbers (it adds in the table's dtype).  So each of the five
#: 40,000,000-row tables (features 0, 9, 19, 20, 21) is cut to 20,000,000
#: rows, and the other 21 stay whole: 104,184,588 rows, 53.34 GB.  That is
#: this card's half of each big table in a 2-way row-sharded deployment (the
#: reference's param_pspecs layout), with the ids drawn from the slice.
#: serve_bulk's unchunked activations need about 12 GB beside the tables
#: (DLRM_ACTIVATION_BYTES), and 20M is the largest cap in steps of 5M that
#: leaves at least 10 GB of the card free; 25M would need 66.1 + 12 GB.
#: reduced: vocab_sizes (the five 40M-row tables, 40,000,000 -> 20,000,000).
DLRM_ROW_CAP = 20_000_000
DLRM_ACTIVATION_BYTES = 12e9
SERVE_P99_REQUESTS, SERVE_BULK_BATCHES, PROFILED_REQUESTS = 200, 5, 8
#: The f32 card-versus-CPU check: full widths, every table capped at
#: 65,536 rows (0.34 GB, small enough to copy to the CPU), B = 512.  1e-4
#: is the repo's model tolerance (TF32 products would fail it by about
#: 10x); a gather at hot 1 is exact, so none of it is spent on K6.
DLRM_CHECK_ROW_CAP, DLRM_CHECK_BATCH = 65_536, 512
DLRM_TOLERANCE = 1e-4
#: Retrieval scores, card vs CPU: one 128-long f32 dot per candidate.
RETRIEVAL_TOLERANCE = 1e-5
#: The reference's batch of the paper's Sec. IV defaults: five pinned
#: dataflows (spmm_tiled with the conformance check) and three more rows.
COMPARISON = (Path(__file__).resolve().parent / "examples" / "scenarios"
              / "comparison.json")
#: ``grid_digest`` of every ported template's evaluated groups and of
#: ``sweep_accelerators()``'s outputs, as the JAX reference gives them on the
#: CPU (tests/test_torch_registry.py holds these pins to it).
FIGURE_DIGESTS = {
    "fig3": "1f1449ffb813618a1492a991637a8065a1534c8bd5fa3944e190af578a81c34d",
    "fig4": "369f890fb9c9ba3b4db1f7d75137a4189ffff7280c68a4d0679f09676039ee88",
    "fig5a": "f337512959db3c69e9909973104166515829b6bc2b5d3a97a58ba041bb421506",
    "fig5b": "1ad76e7395558afb479e04af5d0d99e73568127218efbc22cd89f32e2ac1c5c1",
    "fig6": "d7bc4015cd3436158d500a27ef7fb959901084da556fcdcb3db960b135620de5",
    "fig7": "4e490f092545a090235f49b668d441212d2e38e493238cb207d68b2614a17db9",
    "comparison":
        "cada68b46fc29f0d43c49d6abd9979635c3f3d9bd548936578ef9ef0951b0025",
    "cora_end_to_end":
        "6c105cc7c625d6b400552fc913470d0e31349fcad455ee42c1072afdc5bb24a1",
    "cora_trace":
        "98045e0b21ca545f23c670a4a3499778530111bc0380e1e2f8d4f44ac4564d0b",
    "sweep_accelerators":
        "cada68b46fc29f0d43c49d6abd9979635c3f3d9bd548936578ef9ef0951b0025",
}
FIGURE_REPEATS = 20
#: ``grid_digest`` of the ``rgcn_cora`` template's evaluated groups, as the
#: JAX reference gives them on the CPU (tests/test_torch_hetero.py holds
#: this pin to it).
RGCN_CORA_DIGEST = (
    "bac5dcea8ce91f4f38a12f9d76b3a568794b534cd0c92bed7c9448abe51f9c9a")
#: ``grid_digest`` of the workload bridges' evaluated groups over all ten
#: architectures (``workload_scenarios()``, every shape and dataflow, 50
#: groups), as the JAX reference gives them on the CPU
#: (tests/test_torch_configs.py holds this pin to it).
BRIDGE_DIGEST = (
    "978cd27d5b9ba88940a78c2987f93a2d11bbd3693b31b8a54e8123e78791d915")
#: The repo's typed front-door batch: three hetero dataflows and one
#: sampled-minibatch episode set, each with a pinned total.
HETERO_SMOKE = (Path(__file__).resolve().parent / "examples" / "scenarios"
                / "hetero_smoke.json")
HETERO_SMOKE_PINS = (67006960.0, 6590008.0, 3476624.0, 2783920.0)
#: ogbn-mag's node and edge counts and its four relation types (Hu et al.,
#: "Open Graph Benchmark", NeurIPS 2020); the edges are the repo's seeded
#: typed power law, not the dataset.
TYPED_TRACE = {"n_nodes": 1_939_743, "n_edges": 21_111_007,
               "n_relations": 4, "seed": 0}
TYPED_DATAFLOWS = ("engn", "hygcn", "awb_gcn")
#: benchmarks/tune.py's big tune (all five dataflows, spill, halo 1, widths
#: 64-32-16) over ``BIG_TRACE`` at its 16 capacities V/2 ... V/2^16: 80
#: candidates, exhaustive.
TUNE_SMOKE = (Path(__file__).resolve().parent / "examples" / "scenarios"
              / "tune_smoke.json")
#: The best point and ``frontier_digest`` of that tune, as the JAX
#: reference's ``repro.core.tune.tune_scenario`` gives them on the CPU (its
#: NumPy engine) for ``big_tune_dict()``.
BIG_TUNE_PIN = {
    "best": {"dataflow": "spmm_tiled", "feasible": True, "halo_dedup": 1.0,
             "index": 43, "n_tiles": 4099.0, "objective": 4279484160.0,
             "residency": "spill", "sram_bits": 103936.0,
             "tile_vertices": 244.0, "total_bits": 4279484160.0,
             "total_iterations": 2906123.0},
    "frontier_sha256":
        "27d0016dc66f626176eddc5522b971fb50a918b6492a9439047784453736515d"}
#: benchmarks/serve.py's load: its 24-scenario pool over these datasets,
#: 1,500 requests of 1-3 scenarios from 16 client threads, a 2 ms window,
#: seed 0.
SERVE_TRACE_PARAMS = {"n_nodes": 4000.0, "n_edges": 16000.0, "seed": 1.0}
SERVE_TYPED_PARAMS = {"n_nodes": 2000.0, "n_edges": 12000.0, "seed": 0.0}
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_WINDOW_S, SERVE_SEED = 1500, 16, 0.002, 0
#: The reference's mutation battery over its five dataflows: drop-sigma and
#: swap-NT for each, degenerate-minimum for the three whose forms call
#: ``minimum``.
MUTANTS = 13
DESIGN = Path(__file__).resolve().parent / "DESIGN.md"
#: The sharded trace pipeline: the drift gate's shard counts (with
#: ``default_shard_count()``) over ``BIG_TRACE``, and benchmarks/
#: trace_scale.py's 10^8-edge row (V = E / 10, its --edge-factor), no cut.
SHARD_COUNTS = (1, 4)
HUGE_TRACE = {"n_nodes": 10_000_000, "n_edges": 100_000_000, "seed": 0,
              "alpha": 1.6}
#: The GNN models' class counts per shape (the reference's
#: src/repro/launch/steps.py:46; ogbn-products has 47), and their card vs
#: CPU tolerance: the repo's model tolerance, relative to the largest
#: output.
GNN_N_CLASSES = {"full_graph_sm": 7, "ogb_products": 47, "molecule": 10}
GNN_TOLERANCE = 1e-4
#: The (model, shape) pairs phase 24 runs on the card alone: EquiformerV2's
#: `molecule` forward took 21.6 s on the CPU (the card's 0.15 s), and its
#: card-vs-CPU check runs at `full_graph_sm` (a cut of the script's depth,
#: with phase 33 added).
GNN_CARD_ONLY = {("equiformer-v2", "molecule")}
#: The qwen3-moe-30b-a3b serving cell: the registry's published config,
#: whole (48 layers, 30.2 B parameters, 60.44 GB bf16), at ``prefill_32k``
#: (S 32,768) with its batch cut, then 32 greedy decode steps.  Per
#: sequence the KV cache takes 3.22 GB and the MoE layer's transients at
#: most 5.67 GB (held in turn, counted as if all were live at once), so B 2
#: reckons to at most 78.23 GB and B 3 to 87.13 GB, past the card's 85.02;
#: B 2 peaked at 75.78 GB on an H100 80GB HBM3.  Phase 25 prints the
#: reckoning and fails above the limit.
#: reduced: batch (prefill_32k, 32 -> 2).
QWEN3_MOE_BATCH, QWEN3_MOE_STEPS = 2, 32
QWEN3_MOE_PEAK_LIMIT = 78e9
#: arctic-480b at full width with its depth cut to 2 of 35 layers (27.22
#: GB a layer in bf16; 2 layers and the embeddings 54.90 GB, 3 layers
#: 82.13 GB), ``prefill_32k`` at B 1, then 8 decode steps.
#: reduced: depth (35 -> 2), batch (prefill_32k, 32 -> 1).
ARCTIC_LAYERS, ARCTIC_STEPS = 2, 8
#: The drawn expert weights' std against fan_in ** -0.5.
MOE_DRAW_STD_TOL = 0.02
#: A served bf16 MoE output against a per-expert fp32 loop: the repo's bf16
#: tolerance.
MOE_LOOP_TOLERANCE = 3e-2
#: The f32 checks: full width and vocab, depth cut to 2 layers; card vs CPU
#: at B 1, S 256, then 8 decode steps.  The capacity path against the
#: all-expert path at T 512, capacity factor 16 (C = T: nothing drops), the
#: reference test's case.
MOE_CHECK_LAYERS, MOE_CHECK_PROMPT, MOE_CHECK_STEPS = 2, 256, 8
MOE_FFN_CASE = (512, 16.0)


#: Training (phases 27-30).  The substrate on the card against the CPU: f32
#: updates whose global norm sums in another order; 1e-6 as on the CPU
#: against the reference.
OPTIM_TOLERANCE = 1e-6
#: K6's table gradient (float ``index_add_`` on the card, atomics) against
#: autograd through the plain bag's gather-and-add: the repo's f32 kernel
#: tolerance, at DLRM-MLPerf's widths with every table capped.
BAG_GRAD_TOLERANCE = 1e-5
BAG_GRAD_ROW_CAP, BAG_GRAD_BATCH = 65_536, 512
#: SmolLM-135M trained at ``train_4k`` (S 4,096), bf16 compute, remat
#: "full": B 8 of the shape's 256, the cut that fits the run's time (a step
#: of B 8 takes about 3.5 s on the card; phase 28 prints the largest B the
#: card's memory admits).  A run of 4 steps with a checkpoint every 2 and a
#: failure injected at step 3, against an uninterrupted run of the same 4.
#: reduced: batch (train_4k, 256 -> 8).
LM_TRAIN_BATCH, LM_TRAIN_STEPS, LM_TRAIN_EVERY, LM_TRAIN_FAIL = 8, 4, 2, 3
TRAIN_LR = 3e-3
#: The replay after the rollback against the uninterrupted run: the card
#: sums the embedding's and the attention's gradients in no fixed order.
LM_ROLLBACK_TOLERANCE = 1e-5
#: The f32 trajectories, card vs CPU from the same weights: the repo's
#: model tolerance, with TF32 off.
TRAIN_TOLERANCE = 1e-4
#: A gradient entry is zero to rounding at or below this share of its
#: leaf's largest.  Two f32 evaluations of a gradient differ by about 1e-7
#: of the leaf's largest, and AdamW's normalised update m / (sqrt(v) + eps)
#: turns such an entry's rounding into a step of up to lr either way; above
#: the share that rounding moves the update by at most about 1e-4 of lr.
GRAD_ROUNDING_SHARE = 1e-3
#: A leaf whose largest gradient entry is under f32's epsilon times the
#: model's largest is zero but for rounding: no f32 sum that made it can
#: resolve it.  EquiformerV2's last attention bias (``layers/attn_mlp/b[1]``)
#: is one: a bias shared by all the scores of a head does not move their
#: softmax, so its gradient is zero, and its f32 value (5.2e-10 of the
#: model's largest on the CPU at minibatch_lg's 4-seed sample) is the
#: rounding of each device.  The GNN checks hold no entry of such a leaf,
#: and print it.
GRAD_ZERO_SHARE = 2.0 ** -23
#: What every card-vs-CPU training check holds to TRAIN_TOLERANCE: the loss
#: of each step taken from the CPU's state, and the update of one gradient
#: by the card's optimizer against the CPU's.  Where f32 resolves the
#: gradient along the run, also every step's gradient, parameters and
#: moments, and the free trajectories.
ALWAYS_KEYS = ("step_loss", "step_update")
RESOLVED_KEYS = ("step_grad", "step_params", "step_moments", "traj_loss",
                 "traj_params", "traj_moments")
LM_CHECK_LAYERS, LM_CHECK_BATCH, LM_CHECK_SEQ, LM_CHECK_STEPS = 2, 2, 256, 3
#: The four GNNs at their published configs on a full_graph_sm-sized graph
#: through the trainer; GCN-Cora with the example's failure (its 300 steps
#: and --fail-at 120, scaled to 30 and 12).  Their card-vs-CPU check runs 5
#: steps on the trainer's smaller graph (EquiformerV2's CPU step at V
#: 2,708 takes about 37 s).  AdamW at 1e-4, a rate at which GCN, GatedGCN
#: and MeshGraphNet lower their loss at every step and EquiformerV2 over the
#: run: at the trainer's 3e-3 the first step's update (lr times the
#: gradient's sign, on every weight) throws MeshGraphNet's loss from 13.5
#: to 480.
GNN_TRAIN_STEPS, GNN_TRAIN_EVERY, GNN_TRAIN_LR = 10, 10, 1e-4
#: The GNNs held to ALWAYS_KEYS alone.  Along their 5 steps they reach
#: states whose gradient f32 does not resolve to TRAIN_TOLERANCE: there the
#: CPU's or the card's f32 gradient misses an f64 evaluation by up to 1e-2
#: (phase 29 prints both), and which states do so changes with the order
#: of summation, so the card and the CPU part there.  Phases 29 and 30
#: check at the trainer's seed 0 alone (repeats at seeds 1 and 2 were cut
#: to keep the script inside its time: PERF.md section 4).
GNN_F32_UNRESOLVED = ("meshgraphnet", "equiformer-v2")
GCN_TRAIN_STEPS, GCN_TRAIN_FAIL = 30, 12
GNN_CHECK_GRAPH, GNN_CHECK_STEPS = (128, 512), 5
#: DLRM-MLPerf trained at published widths and ``train_batch`` (B 65,536):
#: each table capped at 4,000,000 rows (24,184,588 in all), whose weights,
#: gradients and two moments (16 B a parameter) take 49.5 GB of the card.
#: The published 204,184,588 rows would need 418 GB, the serving cap of
#: phase 13 (20M rows) 213 GB.
#: reduced: vocab_sizes (training: every table capped at 4,000,000 rows).
DLRM_TRAIN_ROW_CAP, DLRM_TRAIN_STEPS = 4_000_000, 3
DLRM_TRAIN_CHECK_CAP, DLRM_TRAIN_CHECK_BATCH = 65_536, 512


def k5_work(b: int, s: int, h: int, hk: int, d: int,
            window=None) -> tuple[int, int]:
    """Bytes and operations of one causal bf16 K5 call: q, k, v read once
    and o written once; q·k and p·v over the key positions the causal mask
    and the window admit (row i sees min(i + 1, window) keys)."""
    from repro_torch.kernels.ops import attention_pairs

    pairs = attention_pairs(s, window=window)
    return 2 * b * s * d * (2 * h + 2 * hk), 4 * d * pairs * b * h


def ptxas_rows(log: str, pattern: str, name) -> list[str]:
    """Registers and spills of each kernel instance whose mangled name
    matches ``pattern``, from the ``-Xptxas -v`` log, named by
    ``name(match)``."""
    rows, entry, spill = [], None, ""
    for line in log.splitlines():
        found = re.search(pattern, line)
        if "Compiling entry function" in line:
            entry = name(found) if found else None
        elif entry and "spill stores" in line:
            spill = line.strip()
        elif entry and "Used" in line and "registers" in line:
            rows.append(f"{entry}: {int(line.split('Used')[1].split()[0])} "
                        f"registers; {spill}")
            entry = None
    return rows


def k5_ptxas(log: str) -> list[str]:
    """The bf16 K5 kernel's instances (``flash_wgmma_kernel<DP, KT>``); the
    registers are the count at launch, before ``setmaxnreg`` moves the
    producer's to the consumers."""
    return ptxas_rows(log, r"flash_wgmma_kernelILi(\d+)ELi(\d+)E",
                      lambda m: f"flash_wgmma_kernel<{m[1]}, {m[2]}>")


def aggregate_ptxas(log: str) -> list[str]:
    """K1's (fused) and K2's instances (``aggregate_kernel<T, BN, Fused>``)."""
    return ptxas_rows(
        log, r"aggregate_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E",
        lambda m: (f"aggregate_kernel<{'f32' if m[1] == 'f' else 'bf16'}, "
                   f"{m[2]}, {'K1' if m[3] == '1' else 'K2'}>"))


def combine_ptxas(log: str) -> list[str]:
    """K3's instances (``combine_kernel<T, BN, TB, W>``: block height, output
    columns a pass, warps)."""
    return ptxas_rows(
        log, r"combine_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E",
        lambda m: (f"combine_kernel<{'f32' if m[1] == 'f' else 'bf16'}, "
                   f"{m[2]}, {m[3]}, {m[4]}>"))


def k4_ptxas(log: str) -> list[str]:
    """K4's instances (``schedule_counts_kernel<I, Packed, Shared>``) and its
    unpacking pass."""
    return ptxas_rows(
        log, r"(schedule_counts_kernelI([il])Lb([01])ELb([01])E|unpack_kernel)",
        lambda m: ("unpack_kernel" if m[1] == "unpack_kernel" else
                   f"schedule_counts_kernel<int{32 if m[2] == 'i' else 64}, "
                   f"{'packed' if m[3] == '1' else 'unpacked'}, "
                   f"{'shared' if m[4] == '1' else 'global'}>"))


def cluster_fit(build, ea, eu, kname: str, pt) -> str:
    """K1's, K2's or K3's grid at an operating point (f32) and how many of
    its clusters fit on the card at once (``cudaOccupancyMaxActiveClusters``)."""
    fc = ea.feature_chunk(pt.Bn)
    if kname == "edge_aggregate":
        sched = ea.fused_grid_spec(pt.K, pt.N, pt.T, pt.Bn, pt.Bk)
        fit = build.library("edge_aggregate").fused_active_clusters(
            pt.K, pt.N, pt.T, pt.Bn, pt.Bk, fc, 0)
    elif kname == "edge_aggregate_unfused.combine":
        sched = eu.combine_grid_spec(pt.K, pt.N, pt.T, pt.Bn)
        fit = build.library("edge_aggregate_unfused").combine_active_clusters(
            pt.K, pt.N, pt.T, pt.Bn, fc, 0)
    else:
        sched = eu.aggregate_grid_spec(pt.K, pt.N, pt.Bn, pt.Bk)
        fit = build.library("edge_aggregate_unfused").aggregate_active_clusters(
            pt.K, pt.N, pt.Bn, pt.Bk, fc, 0)
    if fit < 0:
        raise RuntimeError(f"{kname}: cudaOccupancyMaxActiveClusters failed "
                           f"with CUDA error {-fit}")
    ranks, blocks = sched.grid
    return (f"grid {ranks} x {blocks} in {ranks * blocks // sched.cluster} "
            f"clusters of {sched.cluster}, {fit} fit on the card at once")


def dense_bound(conformance, ea, eu, kname: str, pt, dtype: str) -> str:
    """K1's or K2's block-dense bound at one operating point: the larger of
    the schedule's operations at the rate of the arithmetic the kernel uses
    (f32: three TF32 products at the TF32 rate, K1's combine at the fp32
    rate; bf16: the bf16 rate) and its traced bytes at the HBM rate."""
    K, F, T = pt.K, pt.N, pt.T
    elem = 4 if dtype == "f32" else 2
    fused = kname == "edge_aggregate"
    acct = (ea.fused_block_streams(K, F, T, block_n=pt.Bn, block_k=pt.Bk,
                                   elem_bytes=elem) if fused
            else eu.aggregate_block_streams(K, F, block_n=pt.Bn,
                                            block_k=pt.Bk, elem_bytes=elem))
    traced = conformance.block_schedule(acct["schedule"], acct["streams"])
    nbytes = sum(v["bytes"] for v in traced.values())
    ops = 2 * K * K * F
    ops_ms = 1e3 * (3 * ops / PEAK_TF32_OPS_PER_S if dtype == "f32"
                    else ops / PEAK_BF16_OPS_PER_S)
    if fused:
        ops_ms += 1e3 * 2 * K * F * T / PEAK_F32_OPS_PER_S
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    by = "operations" if ops_ms >= bytes_ms else "traced bytes"
    return f"{max(ops_ms, bytes_ms):.4f} ms ({by}: {ops_ms:.4f} ms of " \
           f"operations, {bytes_ms:.4f} ms of {nbytes:.0f} traced B)"


def rel_err(out, expect) -> float:
    out, expect = out.float(), expect.float()
    return float((out - expect).abs().max() / (expect.abs().max() + 1e-9))


def abs_err(out, expect) -> float:
    return float((out.float() - expect.float()).abs().max())


def beyond_bf16_step(out, expect) -> int:
    """Elements of a bf16 ``out`` farther from ``expect`` than one bf16 step
    of the value plus the f32 tolerance of the largest output: two fp32
    results that agree to the f32 tolerance, each rounded once to bf16,
    are never farther apart."""
    ref_abs = expect.float().abs()
    allowed = (BF16_STEP * ref_abs
               + ATTN_TOLERANCE["f32"] * float(ref_abs.max()))
    return int(((out.float() - expect.float()).abs() > allowed).sum())


#: Device-side sleep queued before each timed call, in clock cycles (about
#: 2.5 ms): the host enqueues the call while the card sleeps, so the events
#: time the card's work and not the host's launch overhead.
SLEEP_CYCLES = 5_000_000


def time_ms(torch, fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def pow2_caps(n_nodes: int, points: int) -> list[int]:
    """benchmarks/trace_scale.py's sweep: n_nodes/2, n_nodes/4, ...,
    ``points`` distinct capacities."""
    caps: list[int] = []
    i = 1
    while len(caps) < points:
        cap = max(1, n_nodes >> i)
        if caps and cap == caps[-1]:
            break
        caps.append(cap)
        i += 1
    return caps


def battery_caps(n_nodes: int) -> list[int]:
    """The reference trace battery's capacities (tests/test_trace_engine.py)."""
    return sorted({max(1, n_nodes >> i) for i in range(1, 11, 2)} | {n_nodes})


def pair_tensors(trace, dev) -> tuple:
    """A trace's factorization as K4's operands on ``dev``."""
    u_snd, u_rcv, u_new_src, mp = trace._pair_factorization()
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (u_snd, u_rcv, u_new_src, np.diff(mp)))


def hot_pair_case(total: int) -> tuple:
    """tests/test_trace_engine.py's 2^53 case: 96 vertices, int64 pairs, one
    pair carrying nearly all of ``total`` edges."""
    V = 96
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(0, V * V, size=4 * V))
    u_snd, u_rcv = keys // V, keys % V
    mult = np.ones(u_snd.size, dtype=np.int64)
    mult[u_snd.size // 3] = total - (u_snd.size - 1)
    new_src = np.concatenate([[True], u_snd[1:] != u_snd[:-1]])
    return V, (u_snd, u_rcv, new_src, mult)


#: K4's route boundaries (n_tiles, total multiplicity or None) on
#: ``route_pairs``: one tile; 8192 packed or 4096 unpacked bins fill the
#: 64 KB shared histogram, one more goes to device memory; 65,536 tiles;
#: totals either side of the 2^32 packing limit.
K4_ROUTE_CASES = ((1, 10**6), (8192, 10**6), (8193, 10**6), (4096, None),
                  (4097, None), (65_536, 10**6), (65_536, None),
                  (4096, 2**32 - 1), (4096, 2**32), (3, 2**53 + 4097))


def route_pairs(seed: int = 5, V: int = 1 << 18, U: int = 200_000) -> tuple:
    """Seeded unique (sender, receiver) pairs over V vertices, sender-major,
    with multiplicities 1-3: the inputs of the route-boundary cases."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, V * V, U, dtype=np.int64))
    snd, rcv = (keys // V).astype(np.int32), (keys % V).astype(np.int32)
    new_src = np.concatenate([[True], snd[1:] != snd[:-1]])
    return V, (snd, rcv, new_src,
               rng.integers(1, 4, snd.size).astype(np.int64))


def trace_models(trace, caps, device) -> dict:
    """The sweep of phase 7: three dataflows at N = 30, T = 5 and EnGN at
    the GCN-Cora widths, over the capacity axis of one trace."""
    from repro_torch.core.compose import MultiLayerModel, TiledGraphModel

    tv = np.asarray(caps, dtype=np.float64)
    models = {name: TiledGraphModel(name, tile_vertices=tv, trace=trace,
                                    device=device)
              for name in TRACE_DATAFLOWS}
    models["engn_gcn_cora"] = TiledGraphModel(
        MultiLayerModel("engn", (1433.0, 16.0, 7.0)), tile_vertices=tv,
        trace=trace, device=device)
    return models


def same_schedules(got, expect, label: str) -> None:
    for g, e in zip(got, expect, strict=True):
        for key, value in e.counts_dict().items():
            if not np.array_equal(g.counts_dict()[key], value):
                raise AssertionError(f"{label}: cap={e.capacity} {key} "
                                     "differs")


def trace_phases(dev, card: str, launches: dict, max_abs: dict,
                 totals: dict) -> None:
    """Phases 6-8: K4 against its plain version, the exact-trace path, and
    K4's times.  Fills K4's entries of ``launches``, ``max_abs`` and
    ``totals``."""
    from repro_torch.api import evaluate_scenarios, load_scenarios
    from repro_torch.core import trace as trace_mod
    from repro_torch.core.compose import FullGraphParams
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as sr

    k4 = "segment_reduce.schedule_counts"
    # Set-up: the two large graphs (generation, CSR row pointer, and the
    # host factorization every capacity shares).
    t0 = time.perf_counter()
    big = trace_mod.resolve_trace_dataset("power_law_stream", BIG_TRACE)
    mid = trace_mod.resolve_trace_dataset("power_law_stream", MID_TRACE)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    big._pair_factorization()
    fact_s = time.perf_counter() - t0
    mid._pair_factorization()
    U = big._pair_factorization()[0].size
    caps = pow2_caps(big.n_nodes, SWEEP_POINTS)
    print(f"# trace set-up: power_law_stream V={big.n_nodes} "
          f"E={big.n_edges} U={U} generated in {gen_s:.3f} s (with the "
          f"10^6-edge graph), factorized on the host in {fact_s:.3f} s; "
          f"capacities {caps}")

    # 6. K4 vs its plain version on the card, bit for bit.  A case is
    # (label, tensors, n_tiles, K, total): total bounds the multiplicities'
    # sum, as a trace passes its edge count, or is None (unknown).
    cases = []
    for name, params in TRACE_DATASETS.items():
        tr = trace_mod.resolve_trace_dataset(name, params)
        t = pair_tensors(tr, dev)
        cases += [(f"{name}@{cap}", t, *tr._geometry(cap), total)
                  for cap in battery_caps(tr.n_nodes)
                  for total in (tr.n_edges, None)]
    V = 3_000_000_000  # ids past int32: the int64-index instantiation
    wide = tuple(torch.tensor(a, device=dev) for a in (
        [0, 5, 2_999_999_999, 2_999_999_999],
        [2_999_999_998, 7, 1, 2_000_000_000],
        [True, True, True, False], [3, 1, 2**40, 1]))
    cases += [(f"int64-ids@{cap}", wide, -(-V // cap),
               -(-V // -(-V // cap)), 2**40 + 5)
              for cap in (V // 2, V // 1000, 12345)]
    for total in (2**53 - 1, 2**53 + 4097):
        hv, arrays = hot_pair_case(total)
        hot = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        cases += [(f"2^53-mult({total})@{cap}", hot, -(-hv // cap),
                   -(-hv // -(-hv // cap)), total) for cap in battery_caps(hv)]
    rv, arrays = route_pairs()
    for n_tiles, total in K4_ROUTE_CASES:
        mult = arrays[3].copy()
        if total is not None:
            mult[mult.size // 2] += total - int(mult.sum())
        tensors = tuple(torch.from_numpy(a).to(dev)
                        for a in (*arrays[:3], mult))
        cases.append((f"route-boundary n_tiles={n_tiles} total={total}",
                      tensors, n_tiles, -(-rv // n_tiles), total))
    big_t = pair_tensors(big, dev)
    cases += [(f"power_law_stream-1e7@{cap}", big_t, *big._geometry(cap),
               big.n_edges) for cap in caps]
    routes = {}
    for label, tensors, n_tiles, K, total in cases:
        route = sr.k4_route(tensors[0].shape[0], n_tiles, total)
        routes[route.describe()] = routes.get(route.describe(), 0) + 1
        got = sr.schedule_counts(*tensors, K, n_tiles, total)
        expect = sr.schedule_counts_plain(*tensors, K, n_tiles)
        err = max(int((g - e).abs().max()) for g, e in zip(got, expect))
        if not all(torch.equal(g, e) for g, e in zip(got, expect)):
            raise AssertionError(f"K4 disagrees with its plain version at "
                                 f"{label} ({route.describe()}): max abs "
                                 f"err {err}")
        if label.startswith(("2^53", "route")):
            print(f"# check {k4} {label}: {route.describe()}, bit-identical")
        max_abs[k4] = max(max_abs[k4], float(err))
    torch.cuda.synchronize()
    print(f"# check {k4}: {len(cases)} cases bit-identical to the plain "
          f"version (tolerance 0), max abs err {max_abs[k4]}; cases by route: "
          f"{json.dumps(routes, sort_keys=True)}")
    if len({(k.split(",")[0], "unpacked" in k) for k in routes}) < 4:
        raise AssertionError(f"K4's routes not all exercised: {routes}")

    # 7. The exact-trace path through the entry points a user calls.
    full = FullGraphParams(V=float(big.n_nodes), E=float(big.n_edges),
                           N=30.0, T=5.0)
    mid_caps = pow2_caps(mid.n_nodes, SWEEP_POINTS)
    ops.reset_launches()
    t0 = time.perf_counter()
    smoke = evaluate_scenarios(load_scenarios(str(TRACE_SMOKE)), device=dev)
    outs = {k: m.evaluate(full)
            for k, m in trace_models(big, caps, dev).items()}
    mid_scheds = mid.schedules(mid_caps, device=dev)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches[k4] = ops.LAUNCHES[k4]
    print(f"# trace path launches: {json.dumps({k4: launches[k4]})} in "
          f"{path_s:.3f} s (host clock)")
    if launches[k4] < 1:
        raise AssertionError(f"{k4} never launched on the trace path")

    got_pins = tuple(r.total_bits for r in smoke.results)
    if smoke.expect_failures() or got_pins != TRACE_SMOKE_PINS:
        raise AssertionError(f"trace_smoke pins: {got_pins} "
                             f"{smoke.expect_failures()}")
    print(f"# trace_smoke: total_bits {got_pins} == pins")
    for name, out in outs.items():
        total = np.asarray(out.total_bits())
        if total.shape != (len(caps),) or not np.all(np.isfinite(total)):
            raise AssertionError(f"{name}: totals {total}")
    # The NumPy engine on a fresh trace of the same edges: its schedules
    # fill that trace's (engine-blind) LRU, so the models read them and
    # launch nothing.
    fresh = trace_mod.GraphTrace(big.senders, big.receivers, big.n_nodes)
    same_schedules(big.schedules(caps), fresh.schedules(caps,
                                                        engine="numpy"),
                   "torch vs numpy engine at 10^7 edges")
    before = ops.LAUNCHES[k4]
    for name, model in trace_models(fresh, caps, "cpu").items():
        expect, got = model.evaluate(full), outs[name]
        if got.names() != expect.names():
            raise AssertionError(f"{name}: terms {got.names()}")
        for t in got.terms:
            e = expect[t.name]
            if not (np.array_equal(t.data_bits, e.data_bits)
                    and np.array_equal(t.iterations, e.iterations)):
                raise AssertionError(f"{name}: term {t.name} differs from "
                                     "the NumPy engine's")
    if ops.LAUNCHES[k4] != before:
        raise AssertionError("the NumPy-engine comparison launched K4")
    same_schedules(mid_scheds, [mid.schedule_reference(c) for c in mid_caps],
                   "torch engine vs schedule_reference at 10^6 edges")
    print(f"# trace sweep: {len(caps)} capacities x {len(outs)} models, "
          "every schedule field and term bit-identical to the NumPy "
          f"engine; 10^6-edge schedules ({len(mid_caps)} capacities) "
          "bit-identical to schedule_reference")
    for name, out in outs.items():
        print(f"#   {name}: total_bits at cap {caps[0]} "
              f"{float(out.total_bits()[0])!r}, at cap {caps[-1]} "
              f"{float(out.total_bits()[-1])!r}")

    # 8. K4's times per capacity, and the host-clock sweep by engine.
    tot = totals[k4]
    s_idx = big_t[1].element_size()
    for cap in caps:
        n_tiles, K = big._geometry(cap)
        tile = (big_t[1] // K).long()
        remote = (big_t[0] // K).long() != tile
        flags = sr.boundary_flags(big_t[2], tile) & remote
        vals = torch.stack([flags.long(), torch.where(
            remote, big_t[3], torch.zeros_like(big_t[3]))], 1).contiguous()
        nbytes = U * (2 * s_idx + 1 + 8) + 16 * n_tiles
        bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
        ops_ms = 1e3 * K4_OPS_PER_PAIR * U / PEAK_F32_OPS_PER_S
        route = sr.k4_route(U, n_tiles, big.n_edges)
        row = {
            "ms": time_ms(torch, lambda: sr.schedule_counts(
                *big_t, K, n_tiles, big.n_edges)),
            "plain_ms": time_ms(torch, lambda: sr.schedule_counts_plain(
                *big_t, K, n_tiles)),
            "library_ms": time_ms(torch, lambda: torch.zeros(
                (n_tiles, 2), dtype=torch.int64, device=dev).index_add_(
                    0, tile, vals)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}
        for k, v in row.items():
            tot[k] += v
        print(f"# time {k4} cap={cap} (n_tiles={n_tiles}, K={K}, U={U}, "
              f"int{8 * s_idx} ids; {route.describe()}): kernel "
              f"{row['ms']:.4f} ms ({100 * row['bound_ms'] / row['ms']:.1f}% "
              f"of the bound), plain {row['plain_ms']:.4f} ms, library "
              f"(index_add_) {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({nbytes} B) | {card}")
    print(f"# time {k4}, the 16 capacities: kernel {tot['ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms ({100 * tot['bound_ms'] / tot['ms']:.1f}%"
          f"), plain {tot['plain_ms']:.4f} ms, library (index_add_) "
          f"{tot['library_ms']:.4f} ms | {card}")
    t0 = time.perf_counter()
    fresh._device_factorization(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    sweep = {"numpy": [], "torch": []}
    for _ in range(3):
        for engine in sweep:
            fresh.clear_schedules()
            t0 = time.perf_counter()
            fresh.schedules(caps, engine=engine, device=dev)
            sweep[engine].append(time.perf_counter() - t0)
    print(f"# time trace sweep of {len(caps)} capacities (host clock, "
          f"median of 3): numpy engine "
          f"{statistics.median(sweep['numpy']):.4f} s, torch engine "
          f"{statistics.median(sweep['torch']):.4f} s (factorization already on "
          f"the card; its upload took {upload_s:.4f} s); host factorization "
          f"{fact_s:.4f} s; trace path {path_s:.3f} s | {card}")


def big_tune_dict() -> dict:
    """The scenario of benchmarks/tune.py's big tune over ``BIG_TRACE``, as
    a dict that either package's ``Scenario.from_dict`` takes."""
    caps = [float(c) for c in pow2_caps(BIG_TRACE["n_nodes"], SWEEP_POINTS)]
    return {"dataflow": "engn", "label": "tune-big",
            "graph": {"kind": "trace", "dataset": "power_law_stream",
                      "params": {k: float(v) for k, v in BIG_TRACE.items()},
                      "N": 64.0, "T": 16.0},
            "composition": {"widths": [64.0, 32.0, 16.0],
                            "tile_vertices": caps[0]},
            "optimize": {"objective": "movement",
                         "space": {"dataflow": "all",
                                   "tile_vertices": caps}}}


def frontier_digest(tune: dict) -> str:
    """SHA-256 of a ``TuneResult.to_dict()``'s frontier (sorted-key JSON;
    floats print exactly, so equal digests mean equal bits)."""
    import hashlib

    blob = json.dumps(tune["frontier"], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def grid_digest(outputs) -> str:
    """SHA-256 of evaluated grids: for each ``(ModelOutput, cells)`` in
    order, each term's ``data_bits`` then ``iterations``, broadcast to the
    cells, float64, C order."""
    import hashlib

    h = hashlib.sha256()
    for out, cells in outputs:
        for t in out.terms:
            for arr in (t.data_bits, t.iterations):
                h.update(np.ascontiguousarray(np.broadcast_to(
                    np.asarray(arr, np.float64), (cells,))).tobytes())
    return h.hexdigest()


def figure_phases(dev, card: str, launches: dict) -> None:
    """Phase 15: the paper's figures and front-door conformance.  Adds the
    phase's launches to ``launches``."""
    import tempfile

    from repro_torch.api import cli, evaluate_groups, template
    from repro_torch.core import registry
    from repro_torch.core.sweep import sweep_accelerators
    from repro_torch.core.validation import (SEC4_GOLDEN_TOTALS,
                                             crosscheck_registry)
    from repro_torch.kernels import ops

    ops.reset_launches()
    # (a) The front door on the reference's Sec. IV batch, on the card.
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "comparison.json"
        t0 = time.perf_counter()
        rc = cli.main(["--scenario", str(COMPARISON), "--device", "cuda",
                       "--json", str(path)])
        torch.cuda.synchronize()
        front_s = time.perf_counter() - t0
        payload = json.loads(path.read_text()) if rc == 0 else None
    front = {k: ops.LAUNCHES[k] for k in LAYER_KERNELS}
    print(f"# front door: comparison.json exit {rc} in {front_s:.3f} s host "
          f"clock, launches {json.dumps(front, sort_keys=True)} | {card}")
    if rc != 0:
        raise AssertionError(f"the front door exited {rc} on comparison.json")
    pinned = [r["expect_ok"] for r in payload["results"] if "expect_ok" in r]
    if pinned != [True] * 5:
        raise AssertionError(f"comparison.json pins: {pinned}")
    (conf,) = [r["conformance"] for r in payload["results"]
               if "conformance" in r]
    print(f"# front door conformance (spmm_tiled): "
          f"{json.dumps(conf, sort_keys=True)}")
    if not (conf["checked"] and conf["ok"]
            and conf["spec"] == "spmm_tiled_cta"):
        raise AssertionError(f"front-door conformance: {conf}")
    for kname, count in front.items():
        if count < 1:
            raise AssertionError(f"{kname} never launched from the front "
                                 "door")

    # (b) The registry crosscheck with the harness on the card.
    records = crosscheck_registry(conformance=True, device=dev)
    for name in SEC4_GOLDEN_TOTALS:
        if records[name].ratio != 1.0:
            raise AssertionError(f"golden {name}: {records[name]}")
    for name in registry.runnable_names():
        rec = records[f"{name}::conformance"]
        if rec.analytical_bytes != rec.measured_bytes:
            raise AssertionError(f"crosscheck {name}: {rec}")
    hbm = {n: records[f"{n}::conformance"].measured_bytes
           for n in registry.runnable_names()}
    print(f"# crosscheck: {len(SEC4_GOLDEN_TOTALS)} goldens at ratio 1.0; "
          f"HBM bytes modelled = measured {json.dumps(hbm)}")

    # (c) Every ported template and sweep_accelerators(), held to the
    # reference's grids by their digests.
    def evaluated(name):
        if name == "sweep_accelerators":
            sw = sweep_accelerators()
            return sw.total_bits.shape, [(o, sw.total_bits[0].size)
                                         for o in sw.meta["outputs"]]
        batch = template(name)
        groups = evaluate_groups(batch.scenarios, device=dev)
        return ((len(groups), *batch.grid_shape),
                [(g.output, len(g.indices)) for g in groups])

    for name, pin in FIGURE_DIGESTS.items():
        shape, outputs = evaluated(name)
        samples = []
        for _ in range(FIGURE_REPEATS):
            t0 = time.perf_counter()
            evaluated(name)
            samples.append(time.perf_counter() - t0)
        digest = grid_digest(outputs)
        print(f"# figure {name}: grid {shape} (evaluations x axes), "
              f"{1e3 * statistics.median(samples):.4f} ms a call (host "
              f"clock, median of {FIGURE_REPEATS}), sha256 {digest} "
              f"({'= pin' if digest == pin else 'PIN ' + pin}) | {card}")
        if digest != pin:
            raise AssertionError(f"{name}'s grids differ from the "
                                 "reference's")
    for kname, count in ops.LAUNCHES.items():
        launches[kname] += count
    print(f"# figure phase launches: {json.dumps(ops.LAUNCHES)}")


def analysis_phase(dev, card: str) -> None:
    """Phase 16: the static model auditor and the conformance preflight.
    Launches nothing."""
    import dataclasses

    from repro_torch.analysis import (audit_composition_forms,
                                      audit_registry, audit_spec,
                                      clear_analysis_cache, lint_paths,
                                      mutate_spec, render_provenance,
                                      run_mutation_battery)
    from repro_torch.analysis.__main__ import extract_committed_provenance
    from repro_torch.core import conformance, registry
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    clear_analysis_cache()
    t0 = time.perf_counter()
    audits = audit_registry()
    audit_ms = 1e3 * (time.perf_counter() - t0)
    audits["composition"] = audit_composition_forms()
    for name, a in sorted(audits.items()):
        print(f"# audit {name}: {'ok' if a.ok else 'FAIL'} movements="
              f"{len(a.movements)} unit_errors={a.unit_error_count} "
              f"waived={a.waived_issue_count} overflow_findings="
              f"{a.overflow_count} dead_hw={','.join(a.dead_hw) or '-'}")
        if not a.ok:
            raise AssertionError(f"audit {name}: {a.strict_errors()}")
    if (audits["hygcn"].waived_issue_count != 4
            or audits["engn"].waived_dead_hw != ("M_prime",)):
        raise AssertionError("the HyGCN / EnGN audit waivers changed")
    for name in ("spmm_tiled_cta", "spmm_unfused_cta"):
        errors = audit_spec(registry.get(name)).strict_errors()
        print(f"# audit {name}: {'ok' if not errors else errors}")
        if errors:
            raise AssertionError(f"audit {name}: {errors}")
    violations = lint_paths()
    print(f"# lint src/repro_torch/core and src/repro_torch/distributed: "
          f"{len(violations)} violation(s)")
    if violations:
        raise AssertionError("; ".join(str(v) for v in violations))
    t0 = time.perf_counter()
    outcomes = run_mutation_battery()
    battery_ms = 1e3 * (time.perf_counter() - t0)
    caught = sum(o.caught for o in outcomes)
    print(f"# mutation battery: {caught}/{len(outcomes)} mutants caught")
    if caught != len(outcomes) or len(outcomes) != MUTANTS:
        raise AssertionError(f"mutation battery: {outcomes}")
    committed = extract_committed_provenance(DESIGN.read_text())
    if committed != render_provenance(audits):
        raise AssertionError("the provenance table differs from DESIGN.md's "
                             "appendix")
    print(f"# provenance: equal to DESIGN.md's appendix "
          f"({sum(len(a.movements) for a in audits.values())} movements)")

    # The harness on the card behind its preflight, then a mis-transcribed
    # kernel spec refused before anything is allocated or launched.
    records = conformance.run_conformance(device=dev)
    bypass = conformance.run_conformance(device=dev, preflight_audit=False)
    if ([r.as_row() for r in records] != [r.as_row() for r in bypass]
            or len(records) != 228 or not all(r.ok for r in records)):
        raise AssertionError(f"conformance behind the preflight: "
                             f"{len(records)} records")
    print(f"# preflight: run_conformance passed the gate with "
          f"{len(records)} records, all ok, equal to the ungated run")
    mutant = next(m for m in mutate_spec(registry.get("spmm_tiled_cta"))
                  if m.name == "drop-sigma")
    swapped = dataclasses.replace(mutant.spec, name="spmm_tiled_cta")
    before = dict(ops.LAUNCHES)
    with registry.temporarily_registered(swapped, overwrite=True):
        try:
            conformance.run_conformance(device=dev)
        except AssertionError as exc:
            refusal = str(exc)
        else:
            raise AssertionError("the preflight let a drop-sigma mutant of "
                                 "spmm_tiled_cta through")
    torch.cuda.synchronize()
    if not refusal.startswith("static model audit failure for "
                              "'spmm_tiled_cta'"):
        raise AssertionError(f"preflight refusal: {refusal}")
    if dict(ops.LAUNCHES) != before:
        raise AssertionError("the refused conformance run launched a "
                             "kernel")
    print(f"# preflight: drop-sigma spmm_tiled_cta refused before any "
          f"launch (K1 launches {before['edge_aggregate']} before and "
          f"after): {refusal[:120]}...")
    print(f"# time audit_registry (cold cache) {audit_ms:.1f} ms, mutation "
          f"battery {battery_ms:.1f} ms (host clock); phase 16 took "
          f"{time.perf_counter() - t_phase:.1f} s | {card}")


def typed_phases(dev, card: str, launches: dict) -> None:
    """Phase 17: typed traces through K4 at ogbn-mag's size.  Adds the
    phase's launches to ``launches``."""
    import tempfile

    from repro_torch.api import cli, evaluate_groups, template
    from repro_torch.core import trace as trace_mod
    from repro_torch.core.compose import (FullGraphParams,
                                          RelationalGraphModel)
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as sr

    k4 = "segment_reduce.schedule_counts"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tr = trace_mod.resolve_trace_dataset("typed_power_law", TYPED_TRACE)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr._typed_factorization()
    fact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rels = tr.relation_traces()
    carve_s = time.perf_counter() - t0
    R, V, E = tr.n_relations, tr.n_nodes, tr.n_edges
    counts = tr.relation_edge_counts()
    if int(counts.sum()) != E or counts.shape != (R,):
        raise AssertionError(f"relation edge counts {counts} vs E={E}")
    U = [rel._pair_factorization()[0].size for rel in rels]
    caps = pow2_caps(V, SWEEP_POINTS)
    print(f"# typed set-up: typed_power_law V={V} E={E} R={R}, edges per "
          f"relation {counts.tolist()} (sum = E), unique pairs {U}; "
          f"generated in {gen_s:.3f} s, typed factorization {fact_s:.3f} s, "
          f"relation traces carved in {carve_s:.3f} s (host clock); "
          f"capacities {caps}")

    # The typed path through the entry points a user calls.
    ops.reset_launches()
    t0 = time.perf_counter()
    sweep = [rel.schedules(caps, device=dev) for rel in rels]
    torch.cuda.synchronize()
    torch_ms = 1e3 * (time.perf_counter() - t0)
    sweep_launches = ops.LAUNCHES[k4]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "hetero_smoke.json"
        rc = cli.main(["--scenario", str(HETERO_SMOKE), "--device", "cuda",
                       "--json", str(path)])
        payload = json.loads(path.read_text()) if rc == 0 else None
    smoke_launches = ops.LAUNCHES[k4] - sweep_launches
    front_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    groups = evaluate_groups(template("rgcn_cora").scenarios, device=dev)
    torch.cuda.synchronize()
    rgcn_s = time.perf_counter() - t0
    phase = dict(ops.LAUNCHES)
    print(f"# typed path launches: {json.dumps(phase)} ({sweep_launches} "
          f"from the sweep, {smoke_launches} from hetero_smoke.json)")
    if sweep_launches != R * len(caps) or smoke_launches < 1:
        raise AssertionError(f"{k4} launches on the typed path: "
                             f"{sweep_launches}, {smoke_launches}")
    if rc != 0:
        raise AssertionError(f"the front door exited {rc} on "
                             "hetero_smoke.json")
    got_pins = tuple(r["total_bits"] for r in payload["results"])
    if (got_pins != HETERO_SMOKE_PINS
            or [r["expect_ok"] for r in payload["results"]] != [True] * 4):
        raise AssertionError(f"hetero_smoke pins: {got_pins}")
    print(f"# hetero_smoke: total_bits {got_pins} == pins")
    digest = grid_digest([(g.output, len(g.indices)) for g in groups])
    print(f"# rgcn_cora: {len(groups)} evaluations, sha256 {digest} "
          f"({'= pin' if digest == RGCN_CORA_DIGEST else 'PIN ' + RGCN_CORA_DIGEST})")
    if digest != RGCN_CORA_DIGEST:
        raise AssertionError("rgcn_cora's grids differ from the reference's")

    # The NumPy engine relation by relation (the LRU is engine-blind, so it
    # is cleared first), and the drift gate against traces built from each
    # relation's own edges.
    tr.clear_schedules()
    t0 = time.perf_counter()
    expect = [rel.schedules(caps, engine="numpy") for rel in rels]
    numpy_ms = 1e3 * (time.perf_counter() - t0)
    for r in range(R):
        same_schedules(sweep[r], expect[r],
                       f"relation {r}: torch vs numpy engine")
    picks = (0, len(caps) // 2, len(caps) - 1)
    t0 = time.perf_counter()
    for r in range(R):
        mask = tr.rels == r
        solo = trace_mod.GraphTrace(tr.senders[mask], tr.receivers[mask], V)
        same_schedules([sweep[r][i] for i in picks],
                       solo.schedules([caps[i] for i in picks],
                                      engine="numpy"),
                       f"relation {r} vs its own GraphTrace")
    drift_s = time.perf_counter() - t0
    print(f"# typed sweep: {R} relations x {len(caps)} capacities "
          "bit-identical to the NumPy engine; at capacities "
          f"{[caps[i] for i in picks]} every relation equals a GraphTrace "
          "built from its own edges")
    tr.clear_schedules()
    for rel in rels:
        rel.schedules(caps, device=dev)
    full = FullGraphParams(V=float(V), E=float(E), N=30.0, T=5.0)
    t_models = time.perf_counter()
    model_ms = {}
    for name in TYPED_DATAFLOWS:
        model = RelationalGraphModel(name, tile_vertices=np.asarray(
            caps, dtype=np.float64), trace=tr, device=dev)
        out = model.evaluate(full)
        total = np.asarray(out.total_bits())
        if total.shape != (len(caps),) or not np.all(np.isfinite(total)):
            raise AssertionError(f"{name} relational totals {total}")
        t0 = time.perf_counter()
        model.evaluate(full)
        model_ms[name] = 1e3 * (time.perf_counter() - t0)

    models_s = time.perf_counter() - t_models
    # K4 over the 64 (relation, capacity) launches, beside its byte bound.
    t0 = time.perf_counter()
    k4_ms = bound_ms = 0.0
    for rel in rels:
        tensors = rel._device_factorization(dev)
        u, s_idx = tensors[0].shape[0], tensors[1].element_size()
        for cap in caps:
            n_tiles, K = rel._geometry(cap)
            k4_ms += time_ms(torch, lambda: sr.schedule_counts(
                *tensors, K, n_tiles, rel.n_edges))
            bound_ms += 1e3 * (u * (2 * s_idx + 1 + 8) + 16 * n_tiles) \
                / PEAK_BYTES_PER_S
    for kname, count in phase.items():
        launches[kname] += count
    print(f"# time typed sweep ({R} x {len(caps)} schedules, host clock): "
          f"torch engine {torch_ms:.1f} ms, numpy engine {numpy_ms:.1f} ms; "
          f"K4 over the {R * len(caps)} launches {k4_ms:.4f} ms (CUDA "
          f"events, median of 20 each), byte bound {bound_ms:.4f} ms "
          f"({100 * bound_ms / k4_ms:.1f}%); RelationalGraphModel over the "
          f"{len(caps)} capacities (schedules cached): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in model_ms.items())
          + f" | {card}")
    print(f"# phase 17 took {time.perf_counter() - t_phase:.1f} s (host "
          f"clock): generation {gen_s:.1f}, factorization and carving "
          f"{fact_s + carve_s:.1f}, torch sweep {torch_ms / 1e3:.2f}, front "
          f"door {front_s:.2f}, rgcn_cora {rgcn_s:.2f}, numpy engine "
          f"{numpy_ms / 1e3:.2f}, drift gate {drift_s:.1f}, relational "
          f"models {models_s:.1f}, K4 timing "
          f"{time.perf_counter() - t0:.1f} s")


def percentile(samples, q: float) -> float:
    """The q-th percentile (nearest rank) of a list of samples."""
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1, max(0, round(q / 100 * len(ordered))
                                             - 1))]


def device_time_by_kind(fn, kernel: str, fragment, extra=None,
                        by_name=None) -> dict:
    """Device time in ms of the work ``fn`` runs, by kind, from
    ``torch.profiler``: ``kernel`` (names holding ``fragment``, or any of a
    tuple of fragments), each kind of ``extra`` (a dict of kind -> name
    fragments, matched next), cuBLAS matrix products, copies and fills,
    every other kernel.  ``by_name``, a dict, also gathers the time of each
    kernel name."""
    fragments = (fragment,) if isinstance(fragment, str) else fragment
    extra = extra or {}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {kernel: 0.0, **{k: 0.0 for k in extra}, "cuBLAS products": 0.0,
             "copies": 0.0, "other kernels": 0.0}
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = event.name.lower()
        named = [k for k, frags in extra.items()
                 if any(f in name for f in frags)]
        kind = (kernel if any(f in name for f in fragments)
                else named[0] if named
                else "cuBLAS products"
                if any(w in name for w in ("nvjet", "gemm", "xmma", "cutlass"))
                else "copies" if "memcpy" in name or "memset" in name
                else "other kernels")
        kinds[kind] += event.device_time / 1e3
        if by_name is not None:
            by_name[event.name] = (by_name.get(event.name, 0.0)
                                   + event.device_time / 1e3)
    return kinds


def serving_phases(dev, card: str, launches: dict, max_abs: dict,
                   totals: dict) -> None:
    """Phases 9-11: K5 against its plain version, the SmolLM-135M serving
    path, and K5's times.  Fills K5's entries of ``launches``, ``max_abs``
    and ``totals``."""
    import torch.nn.functional as F

    from repro_torch import backend, params
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr

    k5 = "flash_attention"
    backend.full_fp32()
    # 9. K5 vs its plain version on the card, through the counted wrapper
    # (the counts are zeroed before phase 10).  bf16 cases are also held
    # element by element: kernel and plain version round fp32 results that
    # agree to the f32 tolerance once to bf16, so each element lies within
    # one bf16 step (2^-7 relative) of the plain one, plus the f32 tolerance
    # of the largest output.
    gen = torch.Generator().manual_seed(0)
    main_shape = (SERVE_BATCH, SERVE_PROMPT, 9, 3, 64, 128, True, None,
                  None)
    cases = [(c, key) for c in ATTN_CASES + (main_shape,)
             for key in ATTN_TOLERANCE]
    for (b, s, h, hk, d, block, causal, window, cap), key in cases:
        dtype = torch.float32 if key == "f32" else torch.bfloat16
        q, k, v = (torch.randn(b, s, n, d, generator=gen).to(dev, dtype)
                   for n in (h, hk, hk))
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=cap, block_q=block, block_k=block)
        expect = fa.flash_attention_plain(q, k, v, causal=causal,
                                          window=window, softcap=cap)
        torch.cuda.synchronize()
        err = rel_err(got, expect)
        label = (f"b={b} s={s} h={h} hk={hk} d={d} block={block} "
                 f"causal={causal} window={window} softcap={cap} {key}")
        outside = beyond_bf16_step(got, expect) if key == "bf16" else 0
        print(f"# check {k5} {label}: max rel err {err:.3e} (tolerance "
              f"{ATTN_TOLERANCE[key]:.0e}), max abs err "
              f"{abs_err(got, expect):.3e}, rms of plain output "
              f"{float(expect.float().pow(2).mean().sqrt()):.3e}"
              + (f", {outside} elements beyond one bf16 step"
                 if key == "bf16" else ""))
        if not err < ATTN_TOLERANCE[key] or outside:
            raise AssertionError(f"K5 disagrees with its plain version at "
                                 f"{label}: {err}, {outside} elements "
                                 "beyond one bf16 step")
        if (b, s, h, hk, d) == main_shape[:5] and key == "bf16":
            max_abs[k5] = abs_err(got, expect)
        del q, k, v, got, expect

    # 10. The serving path at full width and depth, bf16.
    cfg = smollm_135m.make_config()
    t0 = time.perf_counter()
    weights = params.transformer_params(cfg, seed=0)
    model = params.load_transformer(weights, cfg, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    prefill = tr.make_prefill_step(cfg, max_seq=SERVE_MAX_SEQ)
    serve = tr.make_serve_step(cfg, SERVE_MAX_SEQ)
    print(f"# serving set-up: {cfg.name} {cfg.n_layers} layers d "
          f"{cfg.d_model}, {cfg.param_count()} parameters, {cfg.dtype}; "
          f"seeded weights made and loaded in {load_s:.3f} s; one warm-up "
          "prefill")
    prefill(model, prompts)  # cuBLAS handles and plans; not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    logits, cache = prefill(model, prompts)
    end.record()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_ms = start.elapsed_time(end)
    per_prefill = ops.LAUNCHES[k5]
    token = logits.argmax(-1, keepdim=True)
    generated, step_s = [token], []
    for step in range(SERVE_STEPS):
        t0 = time.perf_counter()
        step_logits, cache = serve(model, cache, token,
                                   SERVE_PROMPT + step)
        token = step_logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        generated.append(token)
    launches[k5] = ops.LAUNCHES[k5]
    peak = torch.cuda.max_memory_allocated()
    print(f"# serving path launches: {json.dumps({k5: launches[k5]})} "
          f"({per_prefill} in the prefill)")
    if per_prefill != cfg.n_layers or launches[k5] != cfg.n_layers:
        raise AssertionError(f"K5 launched {per_prefill} times in the "
                             f"prefill and {launches[k5]} in all; expected "
                             f"{cfg.n_layers}, one per layer")
    out = torch.cat(generated, dim=1)
    for name, t in (("prefill logits", logits),
                    ("last decode logits", step_logits)):
        if t.shape != (SERVE_BATCH, cfg.vocab) or not bool(
                torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} or not "
                                 "finite")
    if out.shape != (SERVE_BATCH, SERVE_STEPS + 1) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"generated tokens {tuple(out.shape)}")
    n_prompt = SERVE_BATCH * SERVE_PROMPT
    print(f"# serving: prefill of {SERVE_BATCH} x {SERVE_PROMPT} tokens "
          f"{prefill_s * 1e3:.3f} ms host clock, {prefill_ms:.3f} ms CUDA "
          f"events, {n_prompt / prefill_s:.0f} prefill tokens/s; "
          f"{SERVE_STEPS} decode steps: p50 "
          f"{percentile(step_s, 50) * 1e3:.3f} ms, p99 "
          f"{percentile(step_s, 99) * 1e3:.3f} ms per step ({SERVE_BATCH} "
          "tokens), "
          f"{out.numel()} tokens generated "
          f"({SERVE_BATCH} x {SERVE_STEPS + 1}); peak device memory "
          f"{peak / 2**20:.1f} MiB | {card}")
    # Where the device time goes: one more prefill and 8 decode steps under
    # torch.profiler, outside the counted run.
    pre_kinds = device_time_by_kind(lambda: prefill(model, prompts), "K5",
                                    "flash_wgmma_kernel")
    _, cache = prefill(model, prompts)
    token = generated[0]

    def decode_steps():
        nonlocal cache, token
        for step in range(PROFILED_STEPS):
            lg, cache = serve(model, cache, token, SERVE_PROMPT + step)
            token = lg.argmax(-1, keepdim=True)

    dec_kinds = device_time_by_kind(decode_steps, "K5", "flash_wgmma_kernel")
    step_ms = 1e3 * percentile(step_s, 50)
    for label, kinds, host_ms, n in (
            ("prefill", pre_kinds, prefill_ms, 1),
            ("decode step", dec_kinds, step_ms, PROFILED_STEPS)):
        busy = sum(kinds.values()) / n
        parts = ", ".join(f"{k} {v / n:.3f} ms" for k, v in kinds.items())
        print(f"# where the time goes, {label} (torch.profiler device time"
              f"{'' if n == 1 else f', mean of {n} steps'}): {parts}; "
              f"device busy {busy:.3f} ms of {host_ms:.3f} ms "
              f"({100 * busy / host_ms:.1f}%, the rest idle) | {card}")
    del model, cache, logits, step_logits

    # The f32 checks: card vs CPU, prefill vs decode.
    cfg32 = smollm_135m.make_config(dtype="float32")
    model32 = params.load_transformer(weights, cfg32, device=dev)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab, (CHECK_BATCH, CHECK_PROMPT + CHECK_MORE)))
    max_seq = CHECK_PROMPT + CHECK_MORE
    prefill32 = tr.make_prefill_step(cfg32, max_seq=max_seq)
    serve32 = tr.make_serve_step(cfg32, max_seq)
    gpu_tokens = tokens.to(dev)
    lg_p, cache_p = prefill32(model32, gpu_tokens[:, :CHECK_PROMPT])
    cache_d = tr.init_cache(cfg32, CHECK_BATCH, max_seq, device=dev)
    for i in range(CHECK_PROMPT):
        lg_d, cache_d = serve32(model32, cache_d, gpu_tokens[:, i:i + 1], i)
    errs = {"prefill vs decode": rel_err(lg_p, lg_d)}
    lg_card = lg_p.cpu()
    for i in range(CHECK_PROMPT, max_seq):
        lg_p, cache_p = serve32(model32, cache_p, gpu_tokens[:, i:i + 1], i)
        lg_d, cache_d = serve32(model32, cache_d, gpu_tokens[:, i:i + 1], i)
        errs[f"continued decode at pos {i}"] = rel_err(lg_p, lg_d)
    del cache_p, cache_d
    model32.cpu()
    lg_cpu, _ = prefill32(model32, tokens[:, :CHECK_PROMPT])
    errs["card (K5) vs CPU (plain) prefill"] = rel_err(lg_card, lg_cpu)
    for name, err in errs.items():
        print(f"# serving f32 B={CHECK_BATCH} S={CHECK_PROMPT}: {name} max "
              f"rel err {err:.3e} (tolerance {SERVE_TOLERANCE:.0e})")
        if not err < SERVE_TOLERANCE:
            raise AssertionError(f"serving f32 {name}: {err}")
    del model32

    # 11. K5's time at the serving shape, beside the f32 CUDA-core kernel on
    # the same inputs widened to f32, and at gemma2-2b's attention shape.
    b, s, h, hk, d = main_shape[:5]
    q, k, v = (torch.randn(b, s, n, d, generator=gen).to(dev, torch.bfloat16)
               for n in (h, hk, hk))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    nbytes, nops = k5_work(b, s, h, hk, d)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * nops / PEAK_BF16_OPS_PER_S
    row = {"ms": time_ms(torch, lambda: fa.flash_attention(q, k, v)),
           "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
               q, k, v)),
           "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
               q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               is_causal=True, enable_gqa=True)),
           "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
           "ops_ms": ops_ms}
    f32_ms = time_ms(torch, lambda: fa.flash_attention(q32, k32, v32))
    totals[k5] = row
    print(f"# time {k5} B={b} S={s} H={h} Hk={hk} D={d} bf16: kernel "
          f"{row['ms']:.4f} ms ({nops / row['ms'] / 1e9:.1f} TFLOP/s, "
          f"{100 * row['bound_ms'] / row['ms']:.1f}% of the bound), plain "
          f"{row['plain_ms']:.4f} ms, library (scaled_dot_product_attention) "
          f"{row['library_ms']:.4f} ms (kernel / library "
          f"{row['ms'] / row['library_ms']:.2f}x), bound {row['bound_ms']:.4f}"
          f" ms ({nops} op at the bf16 tensor-core rate; {nbytes} B take "
          f"{bytes_ms:.4f} ms); the f32 CUDA-core kernel on the same inputs "
          f"in f32 {f32_ms:.4f} ms ({f32_ms / row['ms']:.1f}x the kernel; "
          f"{1e3 * nops / PEAK_F32_OPS_PER_S:.4f} ms at the fp32 rate); "
          f"{cfg.n_layers} layers of K5 are "
          f"{100 * cfg.n_layers * row['ms'] / prefill_ms:.1f}% of one prefill"
          f" ({prefill_ms:.3f} ms) | {card}")
    del q, k, v, q32, k32, v32
    b, s, h, hk, d, cap = GEMMA2_ATTENTION
    q, k, v = (torch.randn(b, s, n, d, generator=gen).to(dev, torch.bfloat16)
               for n in (h, hk, hk))
    nbytes, nops = k5_work(b, s, h, hk, d)
    bound = 1e3 * max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_BF16_OPS_PER_S)
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, softcap=cap))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, softcap=cap))
    print(f"# time {k5} gemma2-2b attention B={b} S={s} H={h} Hk={hk} D={d} "
          f"softcap {cap} causal bf16: kernel {ms:.4f} ms "
          f"({nops / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.1f}% of the "
          f"bound), plain {plain_ms:.4f} ms, no library time "
          f"(scaled_dot_product_attention takes no softcap), bound "
          f"{bound:.4f} ms ({nops} op at the bf16 tensor-core rate; {nbytes}"
          f" B) | {card}")


def bag_checks(dev, max_abs: dict) -> None:
    """Phase 12: K6 against its plain version on the card, bit for bit,
    through the counted wrapper (the counts are zeroed before phase 13).
    Fills K6's entry of ``max_abs``."""
    from repro_torch.configs import base
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops, ref

    k6 = "embedding_bag"
    gen = torch.Generator(dev).manual_seed(0)

    def ids(v, *shape):
        return torch.randint(0, v, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def table(v, d):
        return torch.randn(v, d, generator=gen, device=dev)

    # (label, f32 table, ids, out slots of a (B, 27, D) buffer or None)
    cases = [(f"v={v} d={d} b={b} hot={hot}", table(v, d), ids(v, b, hot),
              None) for v, d, b, hot in BAG_CASES]
    # A 20M-row table: rows past 2^24, and the last, so id * D passes 2^31.
    big = ids(DLRM_ROW_CAP, 4096, 2)
    big[0] = torch.tensor([2**24, DLRM_ROW_CAP - 1])
    big[1] = torch.tensor([DLRM_ROW_CAP - 2, 2**24 + 1])
    cases.append((f"v={DLRM_ROW_CAP} d=128 b=4096 hot=2 "
                  f"({int((big >= 2**24).sum())} ids >= 2^24)",
                  table(DLRM_ROW_CAP, 128), big, None))
    # Strided ids (a table's slice of the sparse features) into strided
    # output slots (its slot of the interaction features).
    sparse = ids(1000, 64, 26, 3)
    for t in (0, 13, 25):
        cases.append((f"strided t={t} v=1000 d=128 b=64 hot=3",
                      table(1000, 128), sparse[:, t, :], 1 + t))
    for name in ("serve_p99", "serve_bulk"):
        b = base.RECSYS_SHAPES[name].params["batch"]
        cases.append((f"{name} v=1000000 d=128 b={b} hot=1",
                      table(1_000_000, 128), ids(1_000_000, b, 1), None))
    n = 0
    for label, tab32, idx, slot in cases:
        for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tab = tab32 if key == "f32" else tab32.to(dtype)
            out = None
            if slot is not None:
                out = torch.zeros(idx.shape[0], 27, tab.shape[1], dtype=dtype,
                                  device=dev)[:, slot]
            got = ops.embedding_bag(tab, idx, out=out)
            expect = eb.embedding_bag_plain(tab, idx)
            torch.cuda.synchronize()
            err = abs_err(got, expect)
            ref_err = (rel_err(got, ref.embedding_bag_ref(tab, idx))
                       if key == "f32" else 0.0)
            if not torch.equal(got, expect) or not ref_err < BAG_REF_TOLERANCE:
                raise AssertionError(f"K6 at {label} {key}: max abs err {err} "
                                     f"vs the plain version, {ref_err} "
                                     "relative vs take-then-sum")
            max_abs[k6] = max(max_abs[k6], err)
            n += 1
            print(f"# check {k6} {label} {key}: bit-identical to the plain "
                  "version" + (f", max rel err vs take-then-sum {ref_err:.3e} "
                               f"(tolerance {BAG_REF_TOLERANCE:.0e})"
                               if key == "f32" else ""))
            del tab, got, expect, out
    del cases
    torch.cuda.empty_cache()
    print(f"# check {k6}: {n} cases bit-identical to the plain version "
          f"(tolerance 0), max abs err {max_abs[k6]}")


def dlrm_phases(dev, card: str, launches: dict, max_abs: dict,
                totals: dict) -> None:
    """Phases 12-14: K6 against its plain version, the DLRM serving path,
    and K6's times.  Fills K6's entries of ``launches``, ``max_abs`` and
    ``totals``."""
    import torch.nn.functional as F

    from repro_torch import backend, params
    from repro_torch.configs import base, dlrm_mlperf
    from repro_torch.data import synthetic
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.models.common import mlp_apply

    k6 = "embedding_bag"
    backend.full_fp32()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 products are on; DLRM serves in f32")
    bag_checks(dev, max_abs)

    # 13. The DLRM serving path.
    cfg = dlrm_mlperf.make_config(vocab_sizes=tuple(
        min(v, DLRM_ROW_CAP) for v in dlrm.CRITEO_1TB_VOCABS))
    n_cand = base.RECSYS_SHAPES["retrieval_cand"].params["n_candidates"]
    p99_b, bulk_b = (base.RECSYS_SHAPES[k].params["batch"]
                     for k in ("serve_p99", "serve_bulk"))
    weight_bytes = 4 * cfg.param_count()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    if free < weight_bytes + DLRM_ACTIVATION_BYTES:
        raise MemoryError(f"{cfg.name}: {weight_bytes / 1e9:.2f} GB of "
                          f"weights and {DLRM_ACTIVATION_BYTES / 1e9:.0f} GB "
                          f"of activations, {free / 1e9:.2f} GB free")
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    model = dlrm.DLRM(cfg, device=dev, generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def criteo(step: int, batch: int) -> dict:
        return synthetic.criteo_batch(0, step, batch=batch,
                                      n_dense=cfg.n_dense,
                                      vocab_sizes=cfg.vocab_sizes,
                                      multi_hot=cfg.multi_hot)

    t0 = time.perf_counter()
    p99 = [criteo(i, p99_b) for i in range(SERVE_P99_REQUESTS)]
    bulk = [criteo(SERVE_P99_REQUESTS + i, bulk_b)
            for i in range(SERVE_BULK_BATCHES)]
    query = {"dense": torch.from_numpy(
        criteo(SERVE_P99_REQUESTS + SERVE_BULK_BATCHES, 1)["dense"]).to(dev)}
    cand = torch.randn(n_cand, cfg.embed_dim, generator=gen, device=dev)
    data_s = time.perf_counter() - t0
    print(f"# DLRM set-up: {cfg.name}, widths as published, "
          f"{sum(cfg.vocab_sizes)} table rows (40M-row tables cut to "
          f"{DLRM_ROW_CAP}), {cfg.param_count()} parameters, "
          f"{weight_bytes / 1e9:.2f} GB f32 drawn on the card in "
          f"{init_s:.3f} s ({free / 1e9:.2f} of {total / 1e9:.2f} GB free "
          f"before); seeded Criteo batches made on the host in {data_s:.3f} s;"
          " one warm-up request at each batch")
    dlrm.serve(model, p99[0])
    dlrm.serve(model, bulk[0])
    dlrm.score_candidates(model, query, cand)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    p99_s, bulk_s = [], []
    for batch in p99:
        t0 = time.perf_counter()
        p99_out = dlrm.serve(model, batch)
        p99_s.append(time.perf_counter() - t0)
    for batch in bulk:
        t0 = time.perf_counter()
        bulk_out = dlrm.serve(model, batch)
        bulk_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    scores = dlrm.score_candidates(model, query, cand)
    torch.cuda.synchronize()
    ret_s = time.perf_counter() - t0
    launches[k6] = ops.LAUNCHES[k6]
    peak = torch.cuda.max_memory_allocated()
    forwards = SERVE_P99_REQUESTS + SERVE_BULK_BATCHES
    print(f"# DLRM serving path launches: {json.dumps({k6: launches[k6]})} "
          f"over {forwards} forwards")
    if launches[k6] != cfg.n_sparse * forwards:
        raise AssertionError(f"K6 launched {launches[k6]} times in "
                             f"{forwards} forwards; expected "
                             f"{cfg.n_sparse} per forward")
    for name, out, n in (("serve_p99 logits", p99_out, p99_b),
                         ("serve_bulk logits", bulk_out, bulk_b)):
        if out.shape != (n,) or not np.all(np.isfinite(out)):
            raise AssertionError(f"{name}: shape {out.shape} or not finite")
    if scores.shape != (n_cand,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"retrieval scores {tuple(scores.shape)}")
    bulk_med = statistics.median(bulk_s)
    print(f"# DLRM serving: {SERVE_P99_REQUESTS} serve_p99 requests (B = "
          f"{p99_b}, host clock, copy in + forward + logits back): p50 "
          f"{percentile(p99_s, 50) * 1e3:.3f} ms, p99 "
          f"{percentile(p99_s, 99) * 1e3:.3f} ms; {SERVE_BULK_BATCHES} "
          f"serve_bulk batches (B = {bulk_b}): median "
          f"{bulk_med * 1e3:.3f} ms, {bulk_b / bulk_med:.0f} samples/s "
          f"({bulk_b * SERVE_BULK_BATCHES / sum(bulk_s):.0f} over all "
          f"{SERVE_BULK_BATCHES}); retrieval_cand ({n_cand} candidates) "
          f"{ret_s * 1e3:.3f} ms; peak device memory {peak / 2**30:.2f} GiB "
          f"({peak / 1e9:.2f} GB) | {card}")

    # The checks: the plain embedding bag on the card, bit for bit; f32 on
    # the card against the CPU; retrieval against the CPU.
    last = bulk[-1]
    with torch.inference_mode():
        dense = torch.from_numpy(last["dense"]).to(dev)
        sparse = torch.from_numpy(last["sparse"]).to(dev)
        feats = torch.stack([model.bottom(dense)] + [
            eb.embedding_bag_plain(tab, sparse[:, t, :])
            for t, tab in enumerate(model.tables)], dim=1)
        plain = model.top_logits(feats).cpu().numpy()
        del dense, sparse, feats
    if not np.array_equal(bulk_out, plain):
        raise AssertionError("serve_bulk logits differ from the forward with "
                             "the plain embedding bag: max abs err "
                             f"{float(np.abs(bulk_out - plain).max())}")
    print(f"# DLRM check: serve_bulk logits (B = {bulk_b}) bit-identical to "
          "the forward with the plain embedding bag on the card")
    bot_cpu = {k: [t.cpu() for t in v] for k, v in model.mlp("bot").items()}
    with torch.inference_mode():
        user = mlp_apply(bot_cpu, query["dense"].cpu(), final_act=True)
        expect = cand.cpu() @ user[0]
    ret_err = rel_err(scores.cpu(), expect)
    small = dlrm_mlperf.make_config(vocab_sizes=tuple(
        min(v, DLRM_CHECK_ROW_CAP) for v in dlrm.CRITEO_1TB_VOCABS))
    weights = params.dlrm_params(small, seed=1)
    batch = synthetic.criteo_batch(1, 0, batch=DLRM_CHECK_BATCH,
                                   n_dense=small.n_dense,
                                   vocab_sizes=small.vocab_sizes)
    on_card = dlrm.serve(params.load_dlrm(weights, small, device=dev), batch)
    on_cpu = dlrm.serve(params.load_dlrm(weights, small, device="cpu"), batch)
    f32_err = rel_err(torch.from_numpy(on_card), torch.from_numpy(on_cpu))
    for name, err, tol in (
            (f"f32 logits, card (K6) vs CPU (plain), tables capped at "
             f"{DLRM_CHECK_ROW_CAP} rows ({4 * small.param_count() / 1e9:.2f}"
             f" GB), B = {DLRM_CHECK_BATCH}", f32_err, DLRM_TOLERANCE),
            (f"retrieval scores ({n_cand}), card vs CPU", ret_err,
             RETRIEVAL_TOLERANCE)):
        print(f"# DLRM check: {name}: max rel err {err:.3e} (tolerance "
              f"{tol:.0e})")
        if not err < tol:
            raise AssertionError(f"DLRM {name}: {err}")

    # 14. K6 per table at both batches, the sums over one serve_bulk forward
    # into the kernels line; then the profiler split.
    d = cfg.embed_dim
    tot = totals[k6]
    for name, batch in (("serve_p99", p99[0]), ("serve_bulk", last)):
        b = batch["sparse"].shape[0]
        sparse = torch.from_numpy(batch["sparse"]).to(dev)
        feats = torch.empty(b, cfg.n_sparse + 1, d, device=dev)
        row = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bytes_ms", "ops_ms")}
        for t, tab in enumerate(model.tables):
            idx, slot = sparse[:, t, :], feats[:, t + 1]
            flat = idx.contiguous()
            hot = idx.shape[1]
            uniq = np.unique(batch["sparse"][:, t, :]).size
            nbytes = 4 * (uniq * d + b * d + b * hot)
            cell = {
                "ms": time_ms(torch, lambda: eb.embedding_bag(tab, idx,
                                                              out=slot)),
                "plain_ms": time_ms(torch, lambda: eb.embedding_bag_plain(
                    tab, idx)),
                "library_ms": time_ms(torch, lambda: F.embedding_bag(
                    flat, tab, mode="sum")),
                "bytes_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
                "ops_ms": 1e3 * b * d * (hot - 1) / PEAK_F32_OPS_PER_S}
            cell["bound_ms"] = max(cell["bytes_ms"], cell["ops_ms"])
            for k, v in cell.items():
                row[k] += v
            print(f"# time {k6} {name} table {t} (V={tab.shape[0]}, "
                  f"{uniq} distinct of {b * hot} ids): kernel "
                  f"{cell['ms']:.4f} ms, plain {cell['plain_ms']:.4f} ms, "
                  f"library (F.embedding_bag) {cell['library_ms']:.4f} ms, "
                  f"bound {cell['bound_ms']:.4f} ms ({nbytes} B)")
        print(f"# time {k6} {name} (B = {b}, f32), sum over the "
              f"{cfg.n_sparse} tables: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms,"
              f" bound {row['bound_ms']:.4f} ms | {card}")
        if name == "serve_bulk":
            tot.update(row)
        del sparse, feats
    bulk_kinds = device_time_by_kind(lambda: dlrm.serve(model, last), "K6",
                                     "embedding_bag_kernel")
    p99_kinds = device_time_by_kind(
        lambda: [dlrm.serve(model, b) for b in p99[:PROFILED_REQUESTS]], "K6",
        "embedding_bag_kernel")
    for label, kinds, host_ms, n in (
            (f"serve_bulk request (B = {bulk_b})", bulk_kinds,
             1e3 * bulk_med, 1),
            (f"serve_p99 request (B = {p99_b})", p99_kinds,
             1e3 * percentile(p99_s, 50), PROFILED_REQUESTS)):
        busy = sum(kinds.values()) / n
        parts = ", ".join(f"{k} {v / n:.3f} ms" for k, v in kinds.items())
        print(f"# where the time goes, {label} (torch.profiler device time"
              f"{'' if n == 1 else f', mean of {n} requests'}): {parts}; "
              f"device busy {busy:.3f} ms of {host_ms:.3f} ms host clock "
              f"({100 * busy / host_ms:.1f}%, the rest idle) | {card}")
    del model, cand, scores
    torch.cuda.empty_cache()


def big_tune_candidates(Scenario) -> list:
    """The 80 concrete scenarios of the big tune, in the tuner's canonical
    order (dataflow-major, capacity innermost)."""
    from repro_torch.core import registry

    base = big_tune_dict()
    caps = base.pop("optimize")["space"]["tile_vertices"]
    out = []
    for df in registry.names():
        for cap in caps:
            d = json.loads(json.dumps(base))
            d["dataflow"], d["composition"]["tile_vertices"] = df, cap
            d["label"] = f"tune-big/{df}/tv{cap:g}"
            out.append(Scenario.from_dict(d))
    return out


def result_records(results) -> list:
    """Every number of a list of ``ScenarioResult``s (the drift gate)."""
    return [(r.total_bits, r.total_iterations, r.offchip_bits, r.cache_bits,
             r.onchip_bits, dict(r.breakdown), dict(r.iteration_breakdown),
             r.n_tiles) for r in results]


def k4_sweep_ms(trace, caps, dev) -> tuple[float, float]:
    """K4 over a trace's capacities (CUDA events, median of 20 each, summed)
    and the byte bound of the same work."""
    from repro_torch.kernels import segment_reduce as sr

    tensors = trace._device_factorization(dev)
    u, s_idx = tensors[0].shape[0], tensors[1].element_size()
    k4_ms = bound_ms = 0.0
    for cap in caps:
        n_tiles, K = trace._geometry(cap)
        k4_ms += time_ms(torch, lambda: sr.schedule_counts(
            *tensors, K, n_tiles, trace.n_edges))
        bound_ms += 1e3 * (u * (2 * s_idx + 1 + 8) + 16 * n_tiles) \
            / PEAK_BYTES_PER_S
    return k4_ms, bound_ms


def tune_phase(dev, card: str) -> dict:
    """Phase 18: the design-space tuner on the card.  Returns the phase's
    launches and the 80 concrete big-tune scenarios' results (phase 19
    holds the served ones to them)."""
    import tempfile

    from repro_torch.api import (Scenario, cli, evaluate_scenarios,
                                 template)
    from repro_torch.core import trace as trace_mod
    from repro_torch.core.tune import tune_scenario
    from repro_torch.kernels import ops

    k4 = "segment_reduce.schedule_counts"
    t_phase = time.perf_counter()
    trace_mod.clear_trace_cache()
    trace_mod.reset_trace_stats()
    ops.reset_launches()

    # (a) tune_smoke.json through the front door: 4 capacities of its trace
    # scenario on K4, its full-graph scenario on the host.
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tune_smoke.json"
        rc = cli.main(["--tune", str(TUNE_SMOKE), "--device", "cuda",
                       "--json", str(path)])
        payload = json.loads(path.read_text()) if rc == 0 else None
    if rc != 0 or [r["expect_ok"] for r in payload["results"]] != [True] * 2:
        raise AssertionError(f"--tune tune_smoke.json exited {rc}")
    smoke_launches = ops.LAUNCHES[k4]
    print(f"# tune_smoke.json: exit 0, both pins held, "
          f"{smoke_launches} K4 launches")
    if smoke_launches != 4:
        raise AssertionError(f"tune_smoke launched K4 {smoke_launches} times")

    # (b) tune_cora, and the hetero tune of tests/test_hetero.py:308 on the
    # card, held to the same tune on the CPU (plain K4).
    cora = evaluate_scenarios(template("tune_cora").scenarios,
                              device=dev).results[0].meta["tune"]
    hetero = Scenario.hetero(
        "engn", dataset="typed_blocks",
        params={"n_nodes": 200, "n_edges": 900, "seed": 3}, n_relations=2,
        N=[30.0, 20.0], T=16.0, tile_vertices=64,
        widths=[[30.0, 20.0], 16.0, 5.0],
        optimize={"objective": "movement",
                  "space": {"dataflow": ["engn", "hygcn"],
                            "tile_vertices": [32, 64, 128],
                            "residency": ["spill", "resident"]}})
    before = ops.LAUNCHES[k4]
    het = tune_scenario(hetero, device=dev)
    het_launches = ops.LAUNCHES[k4] - before
    trace_mod.resolve_trace_dataset(
        "typed_blocks", {"n_nodes": 200, "n_edges": 900, "seed": 3,
                         "n_relations": 2}).clear_schedules()
    if tune_scenario(hetero, device="cpu").to_dict() != het.to_dict():
        raise AssertionError("the hetero tune differs from the CPU's")
    print(f"# tune_cora: best {cora['best']['dataflow']} tile_vertices "
          f"{cora['best']['tile_vertices']:g} {cora['best']['residency']} "
          f"objective {cora['best']['objective']!r}, frontier "
          f"{len(cora['frontier'])} points; hetero tune: "
          f"{het.n_candidates} candidates, best {het.best.dataflow} "
          f"tile_vertices {het.best.tile_vertices:g} residency "
          f"{'+'.join(het.best.residency)}, {het_launches} K4 launches, "
          "equal to the CPU's tune")
    if het_launches != 6:
        raise AssertionError(f"the hetero tune launched K4 {het_launches} "
                             "times, not 2 relations x 3 capacities")

    # (c) Full scale: benchmarks/tune.py's big tune over BIG_TRACE, cold.
    trace_mod.clear_trace_cache()
    trace_mod.reset_trace_stats()
    before = ops.LAUNCHES[k4]
    scenario = Scenario.from_dict(big_tune_dict())
    caps = [int(c) for c in scenario.optimize["space"]["tile_vertices"]]
    t0 = time.perf_counter()
    big = trace_mod.resolve_trace_dataset("power_law_stream", BIG_TRACE)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    big._pair_factorization()
    fact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    big._device_factorization(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = tune_scenario(scenario, device=dev)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    stats = trace_mod.trace_cache_info()["stats"]
    tune_launches = ops.LAUNCHES[k4] - before
    print(f"# big tune: {tr.n_candidates} candidates ({tr.method}, "
          f"{tr.n_groups} groups) over V={big.n_nodes} E={big.n_edges}; "
          f"trace stats {json.dumps(stats, sort_keys=True)}; "
          f"{tune_launches} K4 launches")
    if (stats["trace_builds"], stats["factorizations"],
            stats["schedule_computes"], tune_launches) != (
                1, 1, len(caps), len(caps)):
        raise AssertionError(f"big tune: {stats}, {tune_launches} launches")
    if tr.n_candidates != 5 * len(caps) or tr.method != "exhaustive":
        raise AssertionError(f"big tune: {tr.n_candidates} {tr.method}")
    got = tr.to_dict()
    digest = frontier_digest(got)
    print(f"# big tune best: {json.dumps(got['best'], sort_keys=True)}; "
          f"frontier {len(got['frontier'])} points, sha256 {digest}")
    if (got["best"] != BIG_TUNE_PIN["best"]
            or digest != BIG_TUNE_PIN["frontier_sha256"]):
        raise AssertionError(f"big tune differs from the reference's pin "
                             f"{BIG_TUNE_PIN}")

    # Split: K4's schedules and the closed forms, each rerun alone.
    big.clear_schedules()
    t0 = time.perf_counter()
    big.schedules(caps, device=dev)
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    concrete = big_tune_candidates(Scenario)
    t0 = time.perf_counter()
    oracle = evaluate_scenarios(concrete, device=dev)
    eval_s = time.perf_counter() - t0
    objs = np.array([r.total_bits for r in oracle.results])
    best = int(np.argmin(objs))
    if (best != tr.best.index or objs[best] != tr.best.objective
            or oracle.n_evaluations != 5):
        raise AssertionError(f"np.argmin over the {len(concrete)} "
                             f"scenarios: #{best} {objs[best]!r} vs the "
                             f"tuner's #{tr.best.index} "
                             f"{tr.best.objective!r}")
    # The same tune on the CPU (K4's plain version), bit for bit.
    big.clear_schedules()
    before = ops.LAUNCHES[k4]
    t0 = time.perf_counter()
    cpu = tune_scenario(scenario, device="cpu")
    cpu_s = time.perf_counter() - t0
    if cpu.to_dict() != got:
        raise AssertionError("the CPU-device tune differs from the card's")
    if ops.LAUNCHES[k4] != before:
        raise AssertionError("the CPU-device tune launched K4")
    print(f"# big tune: bit-identical to the CPU-device tune; best = "
          f"np.argmin over the {len(concrete)} concrete scenarios (#{best}, "
          f"one evaluate_scenarios call, {oracle.n_evaluations} groups)")
    k4_ms, bound_ms = k4_sweep_ms(big, caps, dev)
    cold_s = gen_s + fact_s + upload_s + tune_s
    print(f"# time big tune (host clock): {cold_s:.3f} s cold = generation "
          f"{gen_s:.3f} + factorization {fact_s:.3f} + upload {upload_s:.3f} "
          f"+ tune {tune_s:.3f} s; rerun alone: K4 schedules {sched_s:.4f} "
          f"s, closed forms over the {len(concrete)} scenarios {eval_s:.4f} "
          f"s; the CPU-device tune (plain K4) {cpu_s:.3f} s; K4 over the "
          f"{len(caps)} launches {k4_ms:.4f} ms (CUDA events, median of 20 "
          f"each), byte bound {bound_ms:.4f} ms "
          f"({100 * bound_ms / k4_ms:.1f}%) | {card}")
    print(f"# phase 18 took {time.perf_counter() - t_phase:.1f} s (host "
          "clock)")
    return {"launches": dict(ops.LAUNCHES), "oracle": oracle.results}


def serve_pool(Scenario) -> list:
    """benchmarks/serve.py's 24-scenario pool: tile, full, trace, hetero,
    minibatch and tune kinds."""
    from repro_torch.core import registry

    dataflows = list(registry.names())
    pool = [Scenario.tile(df, K=K, label=f"tile-{df}-{int(K)}",
                          workload="serve-load")
            for df in dataflows for K in (256.0, 1024.0, 4096.0)]
    for df in dataflows[:2]:
        pool.append(Scenario.full_graph(
            df, V=2708.0, E=10556.0, N=1433.0, T=7.0,
            widths=(1433.0, 16.0, 7.0), tile_vertices=512.0,
            label=f"full-{df}", workload="serve-load"))
    for df in dataflows[:2]:
        for cap in (256.0, 1024.0):
            pool.append(Scenario.trace(
                df, dataset="power_law", params=SERVE_TRACE_PARAMS,
                N=64.0, T=16.0, tile_vertices=cap, widths=(64.0, 32.0, 16.0),
                label=f"trace-{df}-{int(cap)}", workload="serve-load"))
    pool.append(Scenario.hetero(
        dataflows[0], dataset="typed_power_law", n_relations=3,
        params=SERVE_TYPED_PARAMS, N=[30.0, 20.0, 10.0], T=5.0,
        tile_vertices=512.0, label="hetero-serve", workload="serve-load"))
    pool.append(Scenario.minibatch(
        dataflows[1], dataset="power_law", params=SERVE_TRACE_PARAMS,
        batch_nodes=64, fanout=(4, 4), n_batches=4, N=64.0, T=16.0,
        label="minibatch-serve", workload="serve-load"))
    pool.append(Scenario.trace(
        dataflows[0], dataset="power_law", params=SERVE_TRACE_PARAMS,
        N=32.0, T=8.0, tile_vertices=512.0,
        optimize={"objective": "movement",
                  "space": {"tile_vertices": [256.0, 512.0, 1024.0]}},
        label="tune-serve", workload="serve-load"))
    return pool


def serve_requests(pool, n_requests: int, seed: int) -> list:
    """benchmarks/serve.py's duplicate-heavy load: each request samples 1-3
    pool scenarios."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 4, size=n_requests)
    return [[pool[i] for i in rng.integers(0, len(pool), size=int(k))]
            for k in sizes]


def serve_from_clients(engine, requests, n_clients: int) -> list:
    """Each client thread fires an interleaved slice of the requests as
    fast as the engine takes them, after a common barrier; returns the
    ``ServeResult``s in request order."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    chunks = [requests[c::n_clients] for c in range(n_clients)]
    barrier = threading.Barrier(n_clients)

    def client(reqs):
        barrier.wait()
        return [engine.submit_future(r) for r in reqs]

    with ThreadPoolExecutor(max_workers=n_clients) as ex:
        chunk_handles = list(ex.map(client, chunks))
    handles = [None] * len(requests)
    for c, hs in enumerate(chunk_handles):
        for k, h in enumerate(hs):
            handles[c + k * n_clients] = h
    return [h.result(timeout=600) for h in handles]


def serve_phase(dev, card: str, oracle) -> dict:
    """Phase 19: the serve engine and the disk cache on the card.  Returns
    the phase's launches."""
    import os
    import shutil
    import tempfile
    import threading

    from repro_torch.api import (Scenario, ServeEngine, coalesce_scenarios,
                                 evaluate_scenarios)
    from repro_torch.core import schedule_cache
    from repro_torch.core import trace as trace_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as sr

    k4 = "segment_reduce.schedule_counts"
    t_phase = time.perf_counter()
    trace_mod.clear_trace_cache()
    trace_mod.reset_trace_stats()
    ops.reset_launches()

    # (a) benchmarks/serve.py's load.  First the pool cold, from 16
    # clients: every schedule comes from K4 on the dispatcher thread.
    pool = serve_pool(Scenario)
    threads: list[str] = []
    kernel = sr.schedule_counts

    def recorded(*args, **kw):
        threads.append(threading.current_thread().name)
        return kernel(*args, **kw)

    sr.schedule_counts = recorded
    try:
        with ServeEngine(window_s=SERVE_WINDOW_S, device=dev) as eng:
            cold = serve_from_clients(eng, [[s] for s in pool],
                                      SERVE_CLIENTS)
    finally:
        sr.schedule_counts = kernel
    stats = trace_mod.trace_cache_info()["stats"]
    cold_launches = ops.LAUNCHES[k4]
    print(f"# serve, the pool cold: {len(pool)} requests, "
          f"{cold_launches} K4 launches from threads {sorted(set(threads))}, "
          f"{stats['schedule_computes']} schedule computes")
    if (cold_launches != stats["schedule_computes"]
            or cold_launches != len(threads) or cold_launches != 6
            or set(threads) != {"repro-torch-serve"}):
        raise AssertionError(f"cold serve: {cold_launches} K4 launches, "
                             f"{stats}, threads {set(threads)}")
    if result_records([r.results[0] for r in cold]) != result_records(
            evaluate_scenarios(pool, device=dev).results):
        raise AssertionError("the cold pool differs from serial evaluation")

    # Then the load, warm, as benchmarks/serve.py runs it.
    requests = serve_requests(pool, SERVE_REQUESTS, SERVE_SEED)
    n_scen = sum(len(r) for r in requests)
    distinct_used = len({s for req in requests for s in req})
    trace_mod.reset_trace_stats()
    before = ops.LAUNCHES[k4]
    t0 = time.perf_counter()
    serial = [evaluate_scenarios(req, device=dev).results
              for req in requests]
    naive_s = time.perf_counter() - t0
    engine = ServeEngine(window_s=SERVE_WINDOW_S, device=dev)
    t0 = time.perf_counter()
    with engine:
        served = serve_from_clients(engine, requests, SERVE_CLIENTS)
    served_s = time.perf_counter() - t0
    metrics = engine.metrics()
    drift = [i for i, (a, b) in enumerate(zip(serial, served))
             if result_records(a) != result_records(b.results)]
    if drift:
        raise AssertionError(f"served results differ from serial at "
                             f"requests {drift[:10]}")
    # Each window's evaluations are its distinct scenarios' plan groups
    # plus its tuner runs.
    windows: dict[int, list] = {}
    for req, sr_ in zip(requests, served):
        windows.setdefault(sr_.serve["window"], []).append((req, sr_.serve))
    for w, members in windows.items():
        serve = members[0][1]
        distinct, _ = coalesce_scenarios([s for req, _ in members
                                          for s in req])
        evals = (len({s.plan_key() for s in distinct if s.optimize is None})
                 + sum(s.optimize is not None for s in distinct))
        if (serve["fallback"] or serve["n_requests"] != len(members)
                or serve["n_distinct_scenarios"] != len(distinct)
                or serve["n_evaluations"] != evals):
            raise AssertionError(f"window {w}: {serve} vs {len(members)} "
                                 f"requests, {len(distinct)} distinct, "
                                 f"{evals} evaluations")
    if (metrics["evaluations"] != sum(m[0][1]["n_evaluations"]
                                      for m in windows.values())
            or metrics["windows"] != len(windows)
            or ops.LAUNCHES[k4] != before):
        raise AssertionError(f"serve metrics {metrics}, {len(windows)} "
                             "windows, or K4 launched on warm caches")
    lat = np.array([x.serve["latency_s"] * 1e3 for x in served])
    naive_rate, served_rate = n_scen / naive_s, n_scen / served_s
    print(f"# serve load: {SERVE_REQUESTS} requests / {n_scen} scenarios "
          f"({distinct_used} distinct) from {SERVE_CLIENTS} clients, window "
          f"{SERVE_WINDOW_S * 1e3:g} ms: bit-identical to serial; "
          f"{metrics['windows']} windows, {metrics['evaluations']} "
          f"evaluations = each window's distinct plan groups and tunes "
          f"(coalesce rate {metrics['coalesce_rate']:.3f}); 0 K4 launches "
          "(warm)")
    print(f"# time serve load (host clock): served {served_rate:.1f} "
          f"scenarios/s ({served_s:.3f} s), request latency p50 "
          f"{np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f} "
          f"ms; naive serial loop {naive_rate:.1f} scenarios/s "
          f"({naive_s:.3f} s); speedup {served_rate / naive_rate:.2f}x | "
          f"{card}")

    # (b) Full scale: 16 clients at once, a cold LRU, the 80 concrete
    # BIG_TRACE scenarios: single flight.
    concrete = big_tune_candidates(Scenario)
    caps = pow2_caps(BIG_TRACE["n_nodes"], SWEEP_POINTS)
    n_caps = len(caps)
    trace_mod.clear_trace_cache()
    trace_mod.reset_trace_stats()
    before = ops.LAUNCHES[k4]
    t0 = time.perf_counter()
    with ServeEngine(window_s=SERVE_WINDOW_S, device=dev) as eng:
        big = serve_from_clients(eng, [[s] for s in concrete],
                                 SERVE_CLIENTS)
        n_windows = eng.metrics()["windows"]
    big_s = time.perf_counter() - t0
    stats = trace_mod.trace_cache_info()["stats"]
    big_launches = ops.LAUNCHES[k4] - before
    if ((stats["trace_builds"], stats["factorizations"],
         stats["schedule_computes"], big_launches) != (1, 1, n_caps, n_caps)
            or result_records([r.results[0] for r in big])
            != result_records(oracle)):
        raise AssertionError(f"single flight: {stats}, {big_launches} K4 "
                             "launches, or results differ from serial")
    print(f"# serve at full scale: {len(concrete)} BIG_TRACE scenarios from "
          f"{SERVE_CLIENTS} clients at once in {n_windows} windows, cold: 1 "
          f"trace build, 1 factorization, {n_caps} schedule computes, "
          f"{big_launches} K4 launches; bit-identical to serial; "
          f"{big_s:.3f} s (host clock) | {card}")

    # (c) The disk cache: a cold pass stores the graph and every schedule,
    # a warm pass after the LRU is cleared loads them and launches nothing.
    root = tempfile.mkdtemp(prefix="repro-torch-trace-")
    os.environ["REPRO_TORCH_TRACE_CACHE"] = root
    try:
        passes = []
        for _ in range(2):
            trace_mod.clear_trace_cache()
            trace_mod.reset_trace_stats()
            schedule_cache.reset_cache_stats()
            before = ops.LAUNCHES[k4]
            t0 = time.perf_counter()
            tr = trace_mod.resolve_trace_dataset("power_law_stream",
                                                 BIG_TRACE)
            scheds = tr.schedules(caps, device=dev)
            torch.cuda.synchronize()
            passes.append((time.perf_counter() - t0, scheds,
                           trace_mod.trace_cache_info()["stats"],
                           schedule_cache.cache_stats(),
                           ops.LAUNCHES[k4] - before))
        (cold_s, cold_scheds, cold_stats, cold_disk, cold_k4), \
            (warm_s, warm_scheds, warm_stats, warm_disk, warm_k4) = passes
        same_schedules(warm_scheds, cold_scheds, "disk vs K4 schedules")
        if ((cold_stats["trace_builds"], cold_stats["factorizations"],
             cold_stats["schedule_computes"], cold_k4,
             cold_disk["counters"]["graph_stores"],
             cold_disk["counters"]["schedule_stores"])
                != (1, 1, n_caps, n_caps, 1, n_caps)
                or (warm_stats["trace_builds"], warm_stats["factorizations"],
                    warm_stats["schedule_computes"],
                    warm_stats["schedule_disk_hits"], warm_k4,
                    warm_disk["counters"]["graph_hits"])
                != (0, 0, 0, n_caps, 0, 1)):
            raise AssertionError(f"disk cache: cold {cold_stats} "
                                 f"{cold_disk['counters']} {cold_k4} K4, "
                                 f"warm {warm_stats} {warm_disk['counters']} "
                                 f"{warm_k4} K4")
        print(f"# disk cache: cold pass 1 build, 1 factorization, {cold_k4} "
              f"K4 launches, stored 1 graph + {n_caps} schedules "
              f"({warm_disk['bytes']} B); warm pass 0 builds, 0 "
              f"factorizations, {n_caps} schedule_disk_hits, 0 K4 launches, "
              f"schedules bit-identical")
        print(f"# time disk cache (host clock): cold resolve + {n_caps} "
              f"schedules {cold_s:.3f} s, warm {warm_s:.4f} s | {card}")
    finally:
        trace_mod.clear_trace_cache()
        shutil.rmtree(root, ignore_errors=True)
        os.environ["REPRO_TORCH_TRACE_CACHE"] = "0"
    print(f"# phase 19 took {time.perf_counter() - t_phase:.1f} s (host "
          "clock)")
    return dict(ops.LAUNCHES)


def flex_library(q, k, v, window, cap):
    """The library call for K5's gemma2 function: PyTorch's compiled
    ``flex_attention`` with a tanh soft-cap ``score_mod``, a causal (and
    windowed) block mask built once outside the call, and ``enable_gqa``,
    on (B, H, S, D) views of the same inputs.  Returns a thunk giving
    (B, S, H, D); its kernels compile on the first call, into ``build/``."""
    import os

    # Inductor's and Triton's caches go under the checkout's build/ (torch
    # sets the first to a default when it loads inductor, so it is set here).
    build = Path(__file__).resolve().parent / "build"
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    inductor_config.compile_threads = 1  # no pool of compile workers
    s = q.shape[1]

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        keep = ki <= qi
        return keep if window is None else keep & (qi - ki < window)

    mask = create_block_mask(mask_mod, None, None, s, s, device=q.device)
    call = torch.compile(flex_attention, dynamic=False)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def run():
        with torch.inference_mode():
            return call(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                        enable_gqa=True).transpose(1, 2)

    return run


def flex_time(q, k, v, window, cap, expect) -> str:
    """The time of :func:`flex_library` and its error against ``expect``,
    as printed; a library that cannot run gives the error it raised."""
    try:
        run = flex_library(q, k, v, window, cap)
        err = rel_err(run(), expect)
        ms = time_ms(torch, run)
    except Exception as exc:  # the library's failure is recorded, not ours
        first = (str(exc).strip().splitlines() or [""])[0][:240]
        return (f"no library time (flex_attention failed: "
                f"{type(exc).__name__}: {first})")
    return (f"library {ms:.4f} ms (flex_attention, max rel err {err:.3e} "
            "to the plain version)")


def k5_sliced_check(q, k, v, window, cap, heads=None) -> tuple:
    """K5 through the counted wrapper on a whole (B, S, H, D) input, held to
    its plain version computed one batch entry and one kv head's query
    group at a time (a (1, H/Hk, S, S) f32 score matrix each, 8.6 GB at
    gemma2's S 32,768), or ``heads`` query heads of a group at a time.
    Returns (kernel output, plain output)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    with torch.inference_mode():
        got = ops.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=cap)
        expect = torch.empty_like(got)
        rep = q.shape[2] // k.shape[2]
        width = heads or rep
        for bi in range(q.shape[0]):
            for h0 in range(0, q.shape[2], width):
                g = h0 // rep
                sl = slice(h0, h0 + width)
                expect[bi:bi + 1, :, sl] = fa.flash_attention_plain(
                    q[bi:bi + 1, :, sl], k[bi:bi + 1, :, g:g + 1],
                    v[bi:bi + 1, :, g:g + 1], window=window, softcap=cap)
    torch.cuda.synchronize()
    return got, expect


def gemma2_phases(dev, card: str, launches: dict) -> None:
    """Phases 20-21: gemma2-2b served at full width and depth through the
    registry, its checks, and K5 held and timed at the cell's shape.  Adds
    the served prefill's K5 launches to ``launches``."""
    from dataclasses import replace

    from repro_torch import backend, params
    from repro_torch.configs import LM_SHAPES, get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr

    k5 = "flash_attention"
    backend.full_fp32()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    # 20. The cell: the registry's published config at prefill_32k, B cut.
    cfg = get_arch("gemma2-2b").make_config()
    shape = LM_SHAPES["prefill_32k"].params
    b, s = GEMMA2_BATCH, shape["seq"]
    max_seq = s + GEMMA2_STEPS
    t0 = time.perf_counter()
    model = params.draw_transformer(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters drawn, "
                             f"{cfg.param_count()} in the config")
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)),
                              device=dev)
    prefill = tr.make_prefill_step(cfg, max_seq=max_seq)
    serve = tr.make_serve_step(cfg, max_seq)
    print(f"# gemma2 set-up: {cfg.name} {cfg.n_layers} layers d "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv heads "
          f"x {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window "
          f"pattern {cfg.window_pattern}, softcaps {cfg.attn_softcap} / "
          f"{cfg.final_softcap}, {n_params} parameters "
          f"({n_params * 2 / 1e9:.2f} GB {cfg.dtype}) drawn on the card in "
          f"{draw_s:.3f} s; cell prefill_32k (S {s}) with B cut "
          f"{shape['batch']} -> {b}, max_seq {max_seq}; one warm-up prefill")
    prefill(model, prompts)  # cuBLAS handles and plans; not counted
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    logits, cache = prefill(model, prompts)
    end.record()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_ms = start.elapsed_time(end)
    per_prefill = ops.LAUNCHES[k5]
    token = logits.argmax(-1, keepdim=True)
    generated, served_logits, step_s = [token], [logits], []
    for step in range(GEMMA2_STEPS):
        t0 = time.perf_counter()
        step_logits, cache = serve(model, cache, token, s + step)
        token = step_logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        generated.append(token)
        served_logits.append(step_logits)
    served = ops.LAUNCHES[k5]
    peak = torch.cuda.max_memory_allocated()
    print(f"# gemma2 serving launches: {json.dumps({k5: served})} "
          f"({per_prefill} in the prefill)")
    if per_prefill != cfg.n_layers or served != cfg.n_layers:
        raise AssertionError(f"K5 launched {per_prefill} times in the "
                             f"gemma2 prefill and {served} in all; expected "
                             f"{cfg.n_layers}, one per layer")
    launches[k5] += served
    out = torch.cat(generated, dim=1)
    for name, t in (("prefill logits", logits),
                    ("last decode logits", step_logits)):
        if t.shape != (b, cfg.vocab) or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"gemma2 {name}: shape {tuple(t.shape)} "
                                 "or not finite")
    if out.shape != (b, GEMMA2_STEPS + 1) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"gemma2 generated tokens {tuple(out.shape)}")
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    if shapes != {f"{n}{i}": e for i, e in enumerate(tr.cache_shapes(
            cfg, b, max_seq)) for n in "kv"}:
        raise AssertionError(f"gemma2 cache shapes {shapes}")
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    weight_bytes = n_params * 2
    print(f"# gemma2 serving: prefill of {b} x {s} tokens "
          f"{prefill_s * 1e3:.3f} ms host clock, {prefill_ms:.3f} ms CUDA "
          f"events, {b * s / prefill_s:.0f} prefill tokens/s; "
          f"{GEMMA2_STEPS} decode steps: p50 "
          f"{percentile(step_s, 50) * 1e3:.3f} ms, p99 "
          f"{percentile(step_s, 99) * 1e3:.3f} ms per step ({b} tokens); "
          f"KV caches {cache_bytes / 1e9:.2f} GB {json.dumps(shapes)}; peak "
          f"device memory {peak / 1e9:.2f} GB (limit "
          f"{GEMMA2_PEAK_LIMIT / 1e9:.0f}); at B {2 * b} the same parts "
          f"(weights once, the rest per sequence) would peak at "
          f"{(weight_bytes + 2 * (peak - weight_bytes)) / 1e9:.2f} GB | "
          f"{card}")
    if peak > GEMMA2_PEAK_LIMIT:
        raise AssertionError(f"gemma2 cell peak memory {peak} B")
    del logits, step_logits, cache
    torch.cuda.empty_cache()
    # Where the device time goes: one more prefill and 8 decode steps under
    # torch.profiler, outside the counted run.
    pre_kinds = device_time_by_kind(lambda: prefill(model, prompts), "K5",
                                    "flash_wgmma_kernel")
    # One more prefill keeps what its first local and first global layer
    # hand K5 (the cell's own q, k, v), and its caches are held to them:
    # slot p % window of the ring holds position p for the last window
    # positions, and the global cache holds all S, zero past it.
    kinds = {"local": cfg.window_pattern[0], "global": None}
    captured = {}
    counted = ops.flash_attention

    def keep(q, k, v, **kw):
        if len(captured) < len(kinds):
            captured[list(kinds)[len(captured)]] = (q, k, v)
        return counted(q, k, v, **kw)

    ops.flash_attention = keep
    try:
        _, cache = prefill(model, prompts)
    finally:
        ops.flash_attention = counted
    window = kinds["local"]
    ring = torch.arange(s - window, s, device=dev)
    ring_ok = all(torch.equal(cache[f"{n}0"][0][:, ring % window],
                              t[:, ring])
                  for n, t in zip("kv", captured["local"][1:]))
    global_ok = all(torch.equal(cache[f"{n}1"][0][:, :s], t)
                    and not bool(cache[f"{n}1"][0][:, s:].any())
                    for n, t in zip("kv", captured["global"][1:]))
    print(f"# gemma2 caches after a {s}-token prefill: the {window}-slot "
          f"ring holds positions {s - window}..{s - 1} at slot p % {window}"
          f" {'exactly' if ring_ok else 'NOT'}; the {max_seq}-slot global "
          f"cache holds positions 0..{s - 1} "
          f"{'exactly, zero past them' if global_ok else 'NOT'}")
    if not (ring_ok and global_ok):
        raise AssertionError("gemma2 prefill caches disagree with the keys "
                             "and values K5 was given")
    token = generated[0]

    def decode_steps():
        nonlocal cache, token
        for step in range(PROFILED_STEPS):
            lg, cache = serve(model, cache, token, s + step)
            token = lg.argmax(-1, keepdim=True)

    dec_kinds = device_time_by_kind(decode_steps, "K5", "flash_wgmma_kernel")
    del cache
    torch.cuda.empty_cache()
    step_ms = 1e3 * percentile(step_s, 50)
    for label, kinds_ms, host_ms, n in (
            ("prefill", pre_kinds, prefill_ms, 1),
            ("decode step", dec_kinds, step_ms, PROFILED_STEPS)):
        busy = sum(kinds_ms.values()) / n
        parts = ", ".join(f"{k} {v / n:.3f} ms" for k, v in kinds_ms.items())
        print(f"# where the time goes, gemma2 {label} (torch.profiler device"
              f" time{'' if n == 1 else f', mean of {n} steps'}): {parts}; "
              f"device busy {busy:.3f} ms of {host_ms:.3f} ms "
              f"({100 * busy / host_ms:.1f}%, the rest idle) | {card}")
    # The served logits against a recomputation: forward's causal pass (K5
    # on every layer) over the prompts and the 32 tokens fed to the decode
    # steps, zero-padded to K5's 128-row blocks (causal, so the padding
    # changes no earlier position), with the head on the served positions
    # only (forward's logits at this size would take 134 GB).
    fed = torch.cat([prompts, out[:, :GEMMA2_STEPS]], dim=1)
    padded = torch.nn.functional.pad(fed, (0, -fed.shape[1] % 128))
    with torch.inference_mode():
        again = tr._logits(cfg, model, tr._prefill_layers(
            cfg, model, padded)[0][:, s - 1:s + GEMMA2_STEPS])
    got = torch.stack(served_logits, dim=1)
    err = rel_err(got, again)
    agree = int((again.argmax(-1) == out).sum())
    print(f"# gemma2 bf16 served logits (the prefill's and {GEMMA2_STEPS} "
          f"decode steps', B {b}) vs one causal pass over the {fed.shape[1]}"
          f" fed tokens (padded to {padded.shape[1]}): max rel err "
          f"{err:.3e} (tolerance {GEMMA2_DECODE_TOLERANCE:.0e}); greedy "
          f"tokens agree at {agree} of {out.numel()}")
    if not err < GEMMA2_DECODE_TOLERANCE:
        raise AssertionError(f"gemma2 served logits: {err}")
    # How far each bf16 path lies from the same positions of batch row 0
    # computed in f32 (the drawn weights widened; K5's f32 kernel).
    model.float()
    with torch.inference_mode():
        exact = tr._logits(cfg, model, tr._prefill_layers(
            cfg, model, padded[:1])[0][:, s - 1:s + GEMMA2_STEPS])
    print(f"# gemma2 batch row 0 against the same {GEMMA2_STEPS + 1} "
          f"positions in f32: served (bf16 decode) max rel err "
          f"{rel_err(got[:1], exact):.3e}, prefill path (bf16 K5) "
          f"{rel_err(again[:1], exact):.3e}")
    del model, prompts, again, got, served_logits, exact
    torch.cuda.empty_cache()

    # The f32 checks at full width and vocab, depth cut to 4 layers.
    cfg32 = replace(cfg, n_layers=GEMMA2_CHECK_LAYERS, dtype="float32")
    model32 = params.draw_transformer(cfg32, seed=0, device=dev)
    n_ring = GEMMA2_RING_PROMPT + GEMMA2_RING_STEPS
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, n_ring)))
    gpu_tokens = tokens.to(dev)
    lg_card, _ = tr.make_prefill_step(cfg32)(
        model32, gpu_tokens[:, :GEMMA2_CHECK_PROMPT])
    lg_card = lg_card.cpu()
    full = tr.forward(cfg32, model32, gpu_tokens)
    prefill32 = tr.make_prefill_step(cfg32, max_seq=n_ring)
    serve32 = tr.make_serve_step(cfg32, n_ring)
    lg, cache = prefill32(model32, gpu_tokens[:, :GEMMA2_RING_PROMPT])
    errs = {f"prefill {GEMMA2_RING_PROMPT} vs forward": rel_err(
        lg, full[:, GEMMA2_RING_PROMPT - 1])}
    worst = (0.0, None)
    for pos in range(GEMMA2_RING_PROMPT, n_ring):
        lg, cache = serve32(model32, cache, gpu_tokens[:, pos:pos + 1], pos)
        worst = max(worst, (rel_err(lg, full[:, pos]), pos))
    errs[f"decode {GEMMA2_RING_PROMPT}..{n_ring - 1} through the "
         f"{cfg.window_pattern[0]}-slot ring vs forward over {n_ring} "
         f"(worst at pos {worst[1]})"] = worst[0]
    del full, cache, lg
    model32.cpu()
    lg_cpu, _ = tr.make_prefill_step(cfg32)(
        model32, tokens[:, :GEMMA2_CHECK_PROMPT])
    errs[f"card (K5) vs CPU (plain) prefill B=1 S={GEMMA2_CHECK_PROMPT}"] = (
        rel_err(lg_card, lg_cpu))
    for name, err in errs.items():
        print(f"# gemma2 f32 {GEMMA2_CHECK_LAYERS} layers d {cfg.d_model} "
              f"vocab {cfg.vocab}: {name} max rel err {err:.3e} (tolerance "
              f"{SERVE_TOLERANCE:.0e})")
        if not err < SERVE_TOLERANCE:
            raise AssertionError(f"gemma2 f32 {name}: {err}")
    del model32
    torch.cuda.empty_cache()
    print(f"# phase 20 took {time.perf_counter() - t_phase:.1f} s (host "
          "clock)")

    # 21. K5 on the cell's own q, k, v per layer kind: held to its plain
    # version slice by slice, timed beside its bound and the library's
    # flex_attention; then phase 9's windowed gemma2 case.
    t_phase = time.perf_counter()
    h, hk, d, cap = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.attn_softcap
    rows = {}
    for kind, window in kinds.items():
        q, k, v = captured.pop(kind)
        got, expect = k5_sliced_check(q, k, v, window, cap)
        err, outside = rel_err(got, expect), beyond_bf16_step(got, expect)
        label = (f"gemma2-2b {kind} layer B={b} S={s} H={h} Hk={hk} D={d} "
                 f"window={window} softcap {cap} bf16")
        print(f"# check {k5} {label} (the served prefill's own q, k, v; "
              f"plain version per batch entry and kv head group): max rel "
              f"err {err:.3e} (tolerance {ATTN_TOLERANCE['bf16']:.0e}), max "
              f"abs err {abs_err(got, expect):.3e}, {outside} elements "
              "beyond one bf16 step")
        if not err < ATTN_TOLERANCE["bf16"] or outside:
            raise AssertionError(f"K5 disagrees with its plain version at "
                                 f"{label}: {err}, {outside} elements "
                                 "beyond one bf16 step")
        del got
        nbytes, nops = k5_work(b, s, h, hk, d, window)
        bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
        ops_ms = 1e3 * nops / PEAK_BF16_OPS_PER_S
        with torch.inference_mode():
            ms = time_ms(torch, lambda: fa.flash_attention(
                q, k, v, window=window, softcap=cap))
        lib = flex_time(q, k, v, window, cap, expect)
        rows[kind] = {"ms": ms, "bound_ms": max(bytes_ms, ops_ms)}
        print(f"# time {k5} {label}: kernel {ms:.4f} ms "
              f"({nops / ms / 1e9:.1f} TFLOP/s, "
              f"{100 * rows[kind]['bound_ms'] / ms:.1f}% of the bound), "
              f"bound {rows[kind]['bound_ms']:.4f} ms ({nops} op over the "
              f"admitted keys at the bf16 tensor-core rate; {nbytes} B take "
              f"{bytes_ms:.4f} ms); {lib}; no plain time (it runs slice by "
              f"slice here) | {card}")
        del q, k, v, expect
        torch.cuda.empty_cache()
    per_prefill_ms = cfg.n_groups * sum(r["ms"] for r in rows.values())
    bound_ms = cfg.n_groups * sum(r["bound_ms"] for r in rows.values())
    print(f"# time {k5} gemma2-2b, one prefill's {cfg.n_layers} layers: "
          f"{cfg.n_groups} x ({rows['local']['ms']:.4f} + "
          f"{rows['global']['ms']:.4f}) = {per_prefill_ms:.3f} ms, "
          f"{100 * per_prefill_ms / prefill_ms:.1f}% of the prefill "
          f"({prefill_ms:.3f} ms); bound {bound_ms:.3f} ms | {card}")
    cb, cs, ch, chk, cd, _, _, cw, ccap = GEMMA2_WINDOW_CASE
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(cb, cs, n, cd, generator=gen).to(
        dev, torch.bfloat16) for n in (ch, chk, chk))
    nbytes, nops = k5_work(cb, cs, ch, chk, cd, cw)
    bound = 1e3 * max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_BF16_OPS_PER_S)
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, window=cw,
                                                   softcap=ccap))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, window=cw, softcap=ccap), reps=5)
    expect = fa.flash_attention_plain(q, k, v, window=cw, softcap=ccap)
    lib = flex_time(q, k, v, cw, ccap, expect)
    print(f"# time {k5} gemma2-2b windowed check case B={cb} S={cs} H={ch} "
          f"Hk={chk} D={cd} window={cw} softcap {ccap} bf16: kernel "
          f"{ms:.4f} ms ({100 * bound / ms:.1f}% of the bound), plain "
          f"{plain_ms:.4f} ms (median of 5), bound {bound:.4f} ms, {lib} | "
          f"{card}")
    del q, k, v, expect
    torch.cuda.empty_cache()
    print(f"# phase 21 took {time.perf_counter() - t_phase:.1f} s (host "
          "clock)")


def bridge_phase(dev, card: str, launches: dict) -> tuple:
    """Phase 22: the workload bridges on the card, held to the CPU and to
    the reference's pin.  Adds the phase's launches to ``launches`` and
    returns the ogb_products graph's (senders, receivers) for phase 24."""
    import contextlib
    import io
    import tempfile

    from repro_torch.api import cli, evaluate_groups, evaluate_scenarios
    from repro_torch.configs import (GNN_SHAPES, REGISTRY, get_arch,
                                     workload_scenarios)
    from repro_torch.core import trace as trace_mod
    from repro_torch.kernels import ops

    k4 = "segment_reduce.schedule_counts"
    t_phase = time.perf_counter()
    trace_mod.clear_trace_cache()
    ops.reset_launches()
    # (a) The front door's bridges, on the card and on the CPU.
    runs = {"gemma2-2b + dlrm-mlperf": ["--workload", "gemma2-2b",
                                        "--workload", "dlrm-mlperf"],
            "gcn-cora full_graph_sm + molecule": [
                "--workload", "gcn-cora", "--shape", "full_graph_sm",
                "--shape", "molecule"]}
    with tempfile.TemporaryDirectory() as tmp:
        for label, argv in runs.items():
            payloads = {}
            for device in ("cuda", "cpu"):
                path = Path(tmp) / f"{device}.json"
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()) as rows:
                    rc = cli.main(argv + ["--device", device, "--json",
                                          str(path)])
                host_s = time.perf_counter() - t0
                if rc != 0:
                    raise AssertionError(f"--workload {label} on {device} "
                                         f"exited {rc}")
                payloads[device] = json.loads(path.read_text())
            same = payloads["cuda"]["results"] == payloads["cpu"]["results"]
            n_rows = len(rows.getvalue().splitlines()) - 3
            print(f"# bridge {' '.join(argv)}: exit 0 on cuda and cpu, "
                  f"{n_rows} CSV rows, {payloads['cuda']['n_scenarios']} "
                  f"scenarios in {payloads['cuda']['n_evaluations']} "
                  f"evaluations, {'bit-identical' if same else 'DIFFERENT'}"
                  f" on both devices; {host_s:.3f} s host clock on the CPU "
                  f"| {card}")
            if not same:
                raise AssertionError(f"--workload {label}: card and CPU "
                                     "rows differ")
    # (b) The trace reading of gcn-cora's cells, through to_scenarios.
    arch = get_arch("gcn-cora")

    def card_and_cpu(scens, label):
        before = ops.LAUNCHES[k4]
        t0 = time.perf_counter()
        res = evaluate_scenarios(scens, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        n_k4 = ops.LAUNCHES[k4] - before
        for sc in scens:  # the schedule LRU is blind to the device
            trace_mod.resolve_trace_dataset(
                sc.graph["dataset"], sc.graph["params"]).clear_schedules()
        t0 = time.perf_counter()
        ref = evaluate_scenarios(scens, device="cpu")
        cpu_s = time.perf_counter() - t0
        same = result_records(res.results) == result_records(ref.results)
        print(f"# bridge {label} trace: {len(scens)} scenarios, {n_k4} K4 "
              f"launches, {'bit-identical' if same else 'DIFFERENT'} to "
              f"the CPU; {card_s:.3f} s on the card, {cpu_s:.3f} s on the "
              f"CPU (host clock) | {card}")
        if not same:
            raise AssertionError(f"trace bridge {label}: card and CPU "
                                 "differ")
        if n_k4 < 1:
            raise AssertionError(f"trace bridge {label}: K4 never launched")
        for r in res.results:
            if not (np.isfinite(r.total_bits) and r.total_bits > 0):
                raise AssertionError(f"{r.scenario.label}: {r.total_bits}")
        return card_s

    card_and_cpu(arch.to_scenarios(shapes=("full_graph_sm", "molecule"),
                                   graph_kind="trace"),
                 "gcn-cora full_graph_sm + molecule")
    # The realistic-size bridge: ogb_products' V and E.
    scens = arch.to_scenarios(shapes=("ogb_products",), graph_kind="trace")
    graph = scens[0].graph
    trace_mod.reset_trace_stats()
    t0 = time.perf_counter()
    big = trace_mod.resolve_trace_dataset(graph["dataset"], graph["params"])
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    U = big._pair_factorization()[0].size
    fact_s = time.perf_counter() - t0
    p = GNN_SHAPES["ogb_products"].params
    if (big.n_nodes, big.n_edges) != (p["n_nodes"], p["n_edges"]):
        raise AssertionError(f"ogb_products trace V={big.n_nodes} "
                             f"E={big.n_edges}")
    eval_s = card_and_cpu(scens, "gcn-cora ogb_products")
    stats = trace_mod.trace_cache_info()["stats"]
    cap = scens[0].composition.tile_vertices
    k4_ms, k4_bound = k4_sweep_ms(big, [int(cap)], dev)
    print(f"# bridge ogb_products set-up: {graph['dataset']} "
          f"V={big.n_nodes} E={big.n_edges} U={U}, generated in "
          f"{gen_s:.3f} s, factorized in {fact_s:.3f} s, evaluated (5 "
          f"dataflows, capacity {cap:g}) in {eval_s:.3f} s on the card "
          f"(host clock); trace work {json.dumps(stats, sort_keys=True)}; K4"
          f" at the capacity {k4_ms:.4f} ms (CUDA events, median of 20) "
          f"beside its byte bound {k4_bound:.4f} ms | {card}")
    ogb_edges = (big.senders, big.receivers)
    del big
    trace_mod.clear_trace_cache()
    # (c) Every architecture's grid against the reference's pin.
    t0 = time.perf_counter()
    groups = evaluate_groups(workload_scenarios(), device=dev)
    grid_s = time.perf_counter() - t0
    digest = grid_digest([(g.output, len(g.indices)) for g in groups])
    print(f"# bridge grid: workload_scenarios() over {len(REGISTRY)} "
          f"architectures, "
          f"{sum(len(g.indices) for g in groups)} scenarios in "
          f"{len(groups)} evaluations, {grid_s:.3f} s (host clock), sha256 "
          f"{digest} ("
          f"{'= pin' if digest == BRIDGE_DIGEST else 'PIN ' + BRIDGE_DIGEST}"
          f") | {card}")
    if digest != BRIDGE_DIGEST:
        raise AssertionError("the bridges' grid differs from the "
                             "reference's")
    phase = dict(ops.LAUNCHES)
    print(f"# bridge phase launches: {json.dumps(phase)}; phase 22 took "
          f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    for kname, count in phase.items():
        launches[kname] += count
    return ogb_edges


def sharded_phase(dev, card: str, launches: dict) -> None:
    """Phase 23: the sharded trace pipeline, with K4 scheduling its 10^8-edge
    graph.  Adds the phase's launches to ``launches``."""
    from repro_torch.api import Scenario, evaluate_scenarios
    from repro_torch.core import trace as trace_mod
    from repro_torch.distributed import trace_shard
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as sr

    k4 = "segment_reduce.schedule_counts"
    t_phase = time.perf_counter()
    trace_mod.clear_trace_cache()
    ops.reset_launches()
    n_default = trace_shard.default_shard_count()
    # (a) The drift gate at 10^7 edges: every shard count's factorization
    # equals the single-host one (values, order, dtypes).
    single = trace_mod.resolve_trace_dataset("power_law_stream", BIG_TRACE)
    u_snd, u_rcv, _, mp = single._pair_factorization()
    drift = {}
    for n_shards in SHARD_COUNTS + (n_default,):
        t0 = time.perf_counter()
        fact = trace_shard.sharded_power_law_factorization(
            **BIG_TRACE, n_shards=n_shards)
        drift[n_shards] = (trace_shard.factorization_drift(
            fact, (u_snd, u_rcv, mp)), time.perf_counter() - t0)
    print(f"# sharded drift gate: power_law_stream V={single.n_nodes} "
          f"E={single.n_edges} U={u_snd.size}; "
          + "; ".join(f"{n} shards {errs} in {s:.3f} s"
                      for n, (errs, s) in drift.items())
          + f" (host clock) | {card}")
    if any(errs for errs, _ in drift.values()):
        raise AssertionError(f"sharded factorization drift: {drift}")

    # (b) The front door: one power_law_sharded scenario on the card equals
    # the same scenario on power_law_stream.
    kw = dict(params=BIG_TRACE, N=30.0, T=5.0, tile_vertices=float(
        pow2_caps(BIG_TRACE["n_nodes"], 8)[-1]))
    before = ops.LAUNCHES[k4]
    res = {ds: evaluate_scenarios([Scenario.trace("engn", dataset=ds, **kw)],
                                  device=dev).results[0]
           for ds in ("power_law_sharded", "power_law_stream")}
    front_k4 = ops.LAUNCHES[k4] - before
    a, b = res["power_law_sharded"], res["power_law_stream"]
    if (result_records([a]) != result_records([b])
            or a.meta["trace"]["edge_list_free"] is not True
            or b.meta["trace"]["edge_list_free"] is not False):
        raise AssertionError(f"front door: {a.total_bits} vs "
                             f"{b.total_bits}, {a.meta} vs {b.meta}")
    print(f"# sharded front door: engn at capacity {kw['tile_vertices']:g}, "
          f"power_law_sharded total_bits {a.total_bits!r} == "
          f"power_law_stream's, meta {json.dumps(a.meta['trace'])}; "
          f"{front_k4} K4 launches")
    if front_k4 < 1:
        raise AssertionError("the front door launched no K4")
    del single, fact
    trace_mod.clear_trace_cache()

    # (c) The 10^8-edge row, no cut: K4 schedules its 16 capacities, held to
    # the sharded engine bit for bit.
    stats: dict = {}
    t0 = time.perf_counter()
    huge = trace_shard.build_power_law_trace(**HUGE_TRACE, stats=stats)
    build_s = time.perf_counter() - t0
    U = int(stats["n_unique_pairs"])
    caps = pow2_caps(huge.n_nodes, SWEEP_POINTS)
    t0 = time.perf_counter()
    huge._device_factorization(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    before = ops.LAUNCHES[k4]
    t0 = time.perf_counter()
    k4_scheds = huge.schedules(caps, engine="torch", device=dev)
    torch.cuda.synchronize()
    k4_sweep_s = time.perf_counter() - t0
    sweep_k4 = ops.LAUNCHES[k4] - before
    huge.clear_schedules()
    t0 = time.perf_counter()
    sharded_scheds = huge.schedules(caps, engine="sharded")
    sharded_s = time.perf_counter() - t0
    same_schedules(k4_scheds, sharded_scheds,
                   "10^8 edges: K4 vs the sharded engine")
    print(f"# sharded 10^8: power_law_sharded V={huge.n_nodes} "
          f"E={huge.n_edges} U={U}, {stats['n_shards']} shards "
          f"({stats['n_generation_shards']} generating), edge-list-free "
          f"{not huge.has_edge_list}; {sweep_k4} K4 launches for "
          f"{len(caps)} capacities {caps}; every schedule field "
          "bit-identical to the sharded engine")
    if sweep_k4 != len(caps) or huge.has_edge_list:
        raise AssertionError(f"K4 launches {sweep_k4} for {len(caps)} "
                             "capacities")
    print(f"# time sharded 10^8 (host clock): generation and sort "
          f"{stats['t_generate_sort_s']:.3f} s, exchange and factorization "
          f"{stats['t_exchange_factorize_s']:.3f} s, CSR "
          f"{stats['t_csr_s']:.3f} s (build {build_s:.3f} s); upload "
          f"{upload_s:.3f} s; sharded NumPy sweep {sharded_s:.3f} s, K4 "
          f"sweep {k4_sweep_s:.3f} s; peak RSS "
          f"{stats['rss_exchange_factorize_kb'] / 2**20:.2f} GiB after "
          f"factorization, {stats['rss_csr_kb'] / 2**20:.2f} GiB after the "
          f"CSR | {card}")
    tensors = huge._device_factorization(dev)
    s_idx = tensors[1].element_size()
    k4_tot = bound_tot = 0.0
    for cap in caps:
        n_tiles, K = huge._geometry(cap)
        ms = time_ms(torch, lambda: sr.schedule_counts(
            *tensors, K, n_tiles, huge.n_edges))
        nbytes = U * (2 * s_idx + 1 + 8) + 16 * n_tiles
        bound = 1e3 * nbytes / PEAK_BYTES_PER_S
        k4_tot += ms
        bound_tot += bound
        print(f"# time {k4} 10^8 cap={cap} (n_tiles={n_tiles}, "
              f"{sr.k4_route(U, n_tiles, huge.n_edges).describe()}): "
              f"{ms:.4f} ms, bound {bound:.4f} ms ({nbytes} B, "
              f"{100 * bound / ms:.1f}%) | {card}")
    print(f"# time {k4} 10^8, the {len(caps)} capacities: {k4_tot:.4f} ms, "
          f"bound {bound_tot:.4f} ms ({100 * bound_tot / k4_tot:.1f}%) "
          f"| {card}")
    del huge, tensors, k4_scheds, sharded_scheds
    torch.cuda.empty_cache()

    # (d) Typed counts: the sharded per-relation counts equal K4's.
    t0 = time.perf_counter()
    typed = trace_mod.resolve_trace_dataset("typed_power_law", TYPED_TRACE)
    rels = typed.relation_traces()
    typed_s = time.perf_counter() - t0
    caps = pow2_caps(typed.n_nodes, SWEEP_POINTS)
    before = ops.LAUNCHES[k4]
    k4_typed = [rel.schedules(caps, device=dev) for rel in rels]
    typed_k4 = ops.LAUNCHES[k4] - before
    t0 = time.perf_counter()
    for i, cap in enumerate(caps):
        n_tiles, K = rels[0]._geometry(cap)
        halo, remote = trace_shard.typed_sharded_schedule_counts(
            typed, K, n_tiles)
        for r in range(typed.n_relations):
            s = k4_typed[r][i]
            if not (np.array_equal(halo[r], s.halo_counts.astype(np.int64))
                    and np.array_equal(remote[r], s.remote_edge_counts
                                       .astype(np.int64))):
                raise AssertionError(f"typed sharded counts differ from "
                                     f"K4's: relation {r}, cap {cap}")
    typed_sharded_s = time.perf_counter() - t0
    print(f"# sharded typed: typed_power_law V={typed.n_nodes} "
          f"E={typed.n_edges} R={typed.n_relations}; "
          f"typed_sharded_schedule_counts equal K4's ({typed_k4} launches) "
          f"per relation at {len(caps)} capacities; set-up {typed_s:.3f} s, "
          f"sharded counts {typed_sharded_s:.3f} s (host clock) | {card}")
    if typed_k4 != typed.n_relations * len(caps):
        raise AssertionError(f"typed K4 launches {typed_k4}")
    del typed, rels, k4_typed
    trace_mod.clear_trace_cache()
    phase = dict(ops.LAUNCHES)
    print(f"# sharded phase launches: {json.dumps(phase)}; phase 23 took "
          f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    for kname, count in phase.items():
        launches[kname] += count


def gnn_graph(name: str, shape: str, cfg, seed: int = 0) -> dict:
    """A seeded graph of one GNN shape for one model, as numpy fields of a
    ``GraphBatch``: ``full_graph_sm`` a Cora-sized power-law graph
    (self-loops for all but EquiformerV2, as the reference's trainer draws
    it), ``molecule`` ``molecule_batch``'s 128 graphs with graph ids and a
    per-graph readout; edge features, regression targets and positions
    seeded; EquiformerV2's Wigner blocks from the positions."""
    from repro_torch.configs import GNN_SHAPES
    from repro_torch.data import synthetic
    from repro_torch.data.wigner import rotation_to_z, wigner_stack

    p = GNN_SHAPES[shape].params
    rng = np.random.default_rng(seed + 1)
    n_classes = getattr(cfg, "n_classes", 1)
    if shape == "molecule":
        b = synthetic.molecule_batch(seed, 0, batch=p["batch"],
                                     n_nodes=p["n_nodes"],
                                     n_edges=p["n_edges"], d_feat=p["d_feat"])
        B, n = p["batch"], p["n_nodes"]
        off = (np.arange(B) * n)[:, None]
        kw = dict(node_feat=b["node_feat"].reshape(B * n, -1),
                  senders=(b["senders"] + off).ravel().astype(np.int32),
                  receivers=(b["receivers"] + off).ravel().astype(np.int32),
                  graph_ids=np.repeat(np.arange(B), n).astype(np.int32),
                  n_graphs=B,
                  labels=rng.integers(0, n_classes, B).astype(np.int32))
        pos = b["positions"].reshape(B * n, 3)
        target = b["labels"]
    else:
        ga = synthetic.power_law_graph(
            seed, n_nodes=p["n_nodes"], n_edges=p["n_edges"],
            d_feat=p["d_feat"], n_classes=n_classes,
            self_loops=name != "equiformer-v2")
        kw = dict(node_feat=ga.node_feat, senders=ga.senders,
                  receivers=ga.receivers, labels=ga.labels)
        pos = rng.standard_normal((ga.n_nodes, 3))
        target = rng.standard_normal((1, 1)).astype(np.float32)
    E, N = kw["senders"].size, kw["node_feat"].shape[0]
    if name in ("gatedgcn", "meshgraphnet"):
        kw["edge_feat"] = rng.standard_normal(
            (E, cfg.d_edge_in)).astype(np.float32)
    if name == "meshgraphnet":
        kw["labels"] = rng.standard_normal((N, cfg.d_out)).astype(np.float32)
    if name == "equiformer-v2":
        if np.any(kw["senders"] == kw["receivers"]):
            raise AssertionError(f"{shape}: EquiformerV2's edges hold a "
                                 "self-loop, which has no edge frame")
        vecs = pos[kw["senders"]] - pos[kw["receivers"]]
        kw["wigner"] = wigner_stack(np.stack([rotation_to_z(v) for v in vecs]),
                                    cfg.l_max, m_max=cfg.m_max)
        kw["positions"] = pos.astype(np.float32)
        kw["labels"] = target
    return kw


def ogb_gcn_graph(ogb_edges: tuple) -> dict:
    """GCN's graph at ogb_products whole, as numpy fields of a
    ``GraphBatch``: phase 22's seeded edges with one self-loop per vertex
    (as ``power_law_graph(self_loops=True)`` appends them), seeded
    features and labels."""
    from repro_torch.configs import GNN_SHAPES

    p = GNN_SHAPES["ogb_products"].params
    V, n_classes = p["n_nodes"], GNN_N_CLASSES["ogb_products"]
    rng = np.random.default_rng(22)
    loops = np.arange(V, dtype=np.int32)
    return dict(
        node_feat=rng.standard_normal((V, p["d_feat"]), dtype=np.float32),
        senders=np.concatenate([ogb_edges[0], loops]),
        receivers=np.concatenate([ogb_edges[1], loops]),
        labels=rng.integers(0, n_classes, V).astype(np.int32))


def gnn_phase(dev, card: str, ogb_edges: tuple) -> None:
    """Phase 24: the four GNN models at their published configs on the
    card, held to the CPU; GCN at ogb_products' full size.  The models run
    no hand-written kernel, as the reference's run no Pallas kernel: the
    counters are zeroed before and must read 0 after."""
    from repro_torch import params
    from repro_torch.configs import GNN_SHAPES, get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.gnn import (GraphBatch, equiformer_v2, gatedgcn,
                                        gcn, meshgraphnet)

    t_phase = time.perf_counter()
    ops.reset_launches()
    loaders = {"gcn-cora": (params.load_gcn, gcn.loss_fn),
               "gatedgcn": (params.load_gatedgcn, gatedgcn.loss_fn),
               "meshgraphnet": (params.load_meshgraphnet,
                                meshgraphnet.loss_fn),
               "equiformer-v2": (params.load_equiformer_v2,
                                 equiformer_v2.loss_fn)}
    cpu = torch.device("cpu")
    for name, (load, loss_fn) in loaders.items():
        for shape in ("full_graph_sm", "molecule"):
            mk = {"d_in": GNN_SHAPES[shape].params["d_feat"]}
            if name in ("gcn-cora", "gatedgcn"):
                mk["n_classes"] = GNN_N_CLASSES[shape]
                if shape == "molecule":
                    mk["readout"] = "graphs"
            cfg = get_arch(name).make_config(**mk)
            t0 = time.perf_counter()
            arrays = gnn_graph(name, shape, cfg)
            graph_s = time.perf_counter() - t0
            weights = params.gnn_params(cfg, seed=0)
            out = []
            held = (name, shape) not in GNN_CARD_ONLY
            with torch.no_grad():
                for d in (dev, cpu) if held else (dev,):  # the card first
                    model = load(weights, cfg, device=d)
                    g = GraphBatch(**arrays).to(d)
                    t0 = time.perf_counter()
                    y = model(g)
                    loss, _ = loss_fn(model, g)
                    if d.type == "cuda":
                        torch.cuda.synchronize()
                    out.append((y.cpu(), float(loss),
                                time.perf_counter() - t0))
                    if len(out) == 1:
                        card_ms = time_ms(torch, lambda: model(g), reps=5)
                    del model, g
            (y, loss, card_s), = out[:1]
            if held:
                (y_cpu, loss_cpu, cpu_s), = out[1:]
                err = rel_err(y, y_cpu)
                loss_err = abs(loss - loss_cpu) / max(abs(loss_cpu), 1e-30)
                versus = (f"card vs CPU: output {err:.3e}, loss "
                          f"{loss_err:.3e} (tolerance {GNN_TOLERANCE:.0e})")
                cpu_line = f" / {cpu_s:.3f} s CPU"
            else:
                err = loss_err = 0.0
                versus = ("card vs CPU held at full_graph_sm only "
                          "(GNN_CARD_ONLY)")
                cpu_line = ""
            n_params = sum(np.asarray(a).size for a in
                           _leaves(weights))
            print(f"# gnn {name} {shape}: N={arrays['node_feat'].shape[0]} "
                  f"E={arrays['senders'].size}, {n_params} parameters, "
                  f"output {tuple(y.shape)}, loss {loss!r}; {versus}; "
                  f"forward {card_ms:.4f} ms on the card (CUDA events, "
                  f"median of 5), forward and loss {card_s:.3f} s card"
                  f"{cpu_line}, graph {graph_s:.3f} s (host clock) | {card}")
            if not (bool(torch.isfinite(y).all()) and np.isfinite(loss)):
                raise AssertionError(f"{name} {shape}: not finite")
            if not (err < GNN_TOLERANCE and loss_err < GNN_TOLERANCE):
                raise AssertionError(f"{name} {shape}: card vs CPU {err}, "
                                     f"loss {loss_err}")

    # GCN at ogb_products, whole.
    p = GNN_SHAPES["ogb_products"].params
    V, n_classes = p["n_nodes"], GNN_N_CLASSES["ogb_products"]
    cfg = get_arch("gcn-cora").make_config(d_in=p["d_feat"],
                                           n_classes=n_classes)
    t0 = time.perf_counter()
    arrays = ogb_gcn_graph(ogb_edges)
    graph_s = time.perf_counter() - t0
    E = arrays["senders"].size
    weights = params.gnn_params(cfg, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        model = params.load_gcn(weights, cfg, device=dev)
        g = GraphBatch(**arrays).to(dev)
        t0 = time.perf_counter()
        logits = model(g)
        loss, metrics = gcn.loss_fn(model, g)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        fwd_ms = time_ms(torch, lambda: model(g), reps=5)
        kinds = device_time_by_kind(lambda: model(g), "gathers and scatters",
                                    ("index", "gather", "scatter"))
        peak = torch.cuda.max_memory_allocated()
        logits, loss = logits.cpu(), float(loss)
        del model, g
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = params.load_gcn(weights, cfg, device=cpu)
        g = GraphBatch(**arrays).to(cpu)
        expect = model(g)
        # loss_fn's own formula on the logits, without a second forward.
        loss_cpu = float(gcn.masked_cross_entropy(expect, g.labels,
                                                  g.nmask())[0])
        cpu_s = time.perf_counter() - t0
        del model, g
    err = rel_err(logits, expect)
    loss_err = abs(loss - loss_cpu) / max(abs(loss_cpu), 1e-30)
    nbytes = (arrays["node_feat"].nbytes + 2 * 8 * E
              + 4 * V * n_classes + sum(np.asarray(a).nbytes
                                        for a in _leaves(weights)))
    bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    msg_bytes = 4 * E * (cfg.d_hidden + n_classes)
    busy = sum(kinds.values())
    print(f"# gnn gcn-cora ogb_products: V={V} E={E} (phase 22's edges and "
          f"{V} self-loops), d_feat {p['d_feat']}, {n_classes} classes, no "
          f"cut; logits {tuple(logits.shape)}, loss {loss!r}, acc "
          f"{float(metrics['acc'])!r}; card vs CPU: logits {err:.3e}, loss "
          f"{loss_err:.3e} (tolerance {GNN_TOLERANCE:.0e}) | {card}")
    print(f"# time gnn gcn-cora ogb_products: forward {fwd_ms:.3f} ms (CUDA "
          f"events, median of 5; first forward and loss {first_s:.3f} s, "
          f"CPU forward and loss {cpu_s:.3f} s, graph {graph_s:.3f} s, host "
          f"clock), byte bound {bound_ms:.4f} ms ({nbytes} B at "
          f"{PEAK_BYTES_PER_S:.3g} B/s, {100 * bound_ms / fwd_ms:.1f}%); the "
          f"layers' gathered messages {msg_bytes / 1e9:.2f} GB; peak device "
          f"memory {peak / 1e9:.2f} GB; device time by kind: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in kinds.items())
          + f" (busy {busy:.3f} ms) | {card}")
    if not (bool(torch.isfinite(logits).all()) and np.isfinite(loss)):
        raise AssertionError("ogb_products logits not finite")
    if not (err < GNN_TOLERANCE and loss_err < GNN_TOLERANCE):
        raise AssertionError(f"ogb_products card vs CPU {err}, loss "
                             f"{loss_err}")
    # The cuts: the other three models' per-layer edge tensors at
    # ogb_products' E, in f32.
    E0 = p["n_edges"]
    mgn = get_arch("meshgraphnet").make_config()
    ggcn = get_arch("gatedgcn").make_config()
    eqv = get_arch("equiformer-v2").make_config()
    wig = sum(eqv.m_dim(l) * (2 * l + 1) for l in range(eqv.l_max + 1))
    print(f"# gnn cut at ogb_products (E={E0}, f32; the card holds 80 GB): "
          f"meshgraphnet's edge-MLP input E x {3 * mgn.d_hidden} = "
          f"{4 * E0 * 3 * mgn.d_hidden / 1e9:.1f} GB; gatedgcn's edge state "
          f"E x {ggcn.d_hidden} = {4 * E0 * ggcn.d_hidden / 1e9:.1f} GB per "
          f"tensor, five such a layer (e, C e, D h gathered, E h gathered, "
          f"B h gathered) = {5 * 4 * E0 * ggcn.d_hidden / 1e9:.1f} GB; "
          f"equiformer-v2's Wigner blocks E x {wig} = "
          f"{4 * E0 * wig / 1e9:.1f} GB and its messages E x {eqv.L2} x "
          f"{eqv.d_hidden} = {4 * E0 * eqv.L2 * eqv.d_hidden / 1e12:.2f} TB")
    phase = dict(ops.LAUNCHES)
    print(f"# gnn phase launches: {json.dumps(phase)} (the reference's GNN "
          f"models reach no Pallas kernel); phase 24 took "
          f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    if any(phase.values()):
        raise AssertionError(f"the GNN models launched kernels: {phase}")


def moe_plain_slots(flat_e, n_experts: int, capacity: int) -> tuple:
    """The capacity dispatch's keep mask and slots computed another way:
    each assignment's rank among the assignments to its expert, from a
    stable argsort of the (token-major) expert ids.  Returns (keep, slot)
    with slot 0 where keep is false, as the reference writes it."""
    e = flat_e.long()
    order = torch.argsort(e, stable=True)
    counts = torch.bincount(e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(e)
    rank[order] = torch.arange(e.numel(), device=e.device) - starts[e[order]]
    keep = rank < capacity
    return keep, torch.where(keep, rank, 0)


def moe_loop(layer, h, token_of, flat_e, keep, flat_g) -> torch.Tensor:
    """The experts in fp32, one at a time over the tokens kept for it: each
    token's gated sum (T, d), fp32."""
    import torch.nn.functional as F

    hf = h.float()
    out = torch.zeros_like(hf)
    for e in range(layer.moe.w_gate.shape[0]):
        sel = keep & (flat_e == e)
        tokens = token_of[sel].long()
        if tokens.numel() == 0:
            continue
        xe = hf[tokens]
        y = (F.silu(xe @ layer.moe.w_gate[e].float())
             * (xe @ layer.moe.w_up[e].float())) @ layer.moe.w_down[e].float()
        out.index_add_(0, tokens, y * flat_g[sel][:, None])
    return out


def moe_dispatch_check(cfg, layer, n: int, h, out, packed, label: str) -> str:
    """Check (a) at layer ``n``: the served prefill's keep mask and slots
    (``packed``, what ``_pack_assignments`` returned there) against
    :func:`moe_plain_slots` bit for bit, its routing against a plain
    softmax top-k, and its MoE output ``out`` (plus the dense residual
    branch, where the config has one, on both sides) against
    :func:`moe_loop` at the bf16 tolerance.  Returns the printed line."""
    from repro_torch.models import moe
    from repro_torch.models.common import swiglu

    m = cfg.moe
    T = h.shape[0]
    C = moe._capacity(T, m)
    token_of, flat_e, slot, keep, flat_g = packed
    with torch.inference_mode():
        probs = torch.softmax(h.float() @ layer.moe.router.float(), dim=-1)
        route = torch.topk(probs, m.top_k, dim=-1).indices.reshape(-1)
        routed = torch.equal(route, flat_e.long())
        pkeep, pslot = moe_plain_slots(flat_e, m.n_experts, C)
        same = (torch.equal(keep, pkeep) and torch.equal(slot.long(), pslot)
                and torch.equal(token_of.long(), torch.arange(
                    T, device=h.device).repeat_interleave(m.top_k)))
        expect = moe_loop(layer, h, token_of, flat_e, pkeep, flat_g)
        got = out
        if m.dense_residual_d_ff:
            got = out + swiglu(h, layer.res_gate, layer.res_up,
                               layer.res_down)
            expect = expect + swiglu(h.float(), layer.res_gate.float(),
                                     layer.res_up.float(),
                                     layer.res_down.float())
        err = rel_err(got, expect)
    dropped = int((~keep).sum())
    line = (f"# check {label} MoE layer {n} (the served prefill's own input, "
            f"T {T}, C {C}): keep mask and slots "
            f"{'bit-identical to' if same else 'DIFFER from'} a stable "
            f"argsort's ranks, routing {'equal to' if routed else 'NOT'} a "
            f"plain softmax top-{m.top_k}; {dropped} of {keep.numel()} "
            f"assignments dropped; output"
            f"{' + dense residual' if m.dense_residual_d_ff else ''} vs a "
            f"per-expert fp32 loop over the kept tokens: max rel err "
            f"{err:.3e} (tolerance {MOE_LOOP_TOLERANCE:.0e})")
    print(line)
    if not (same and routed and err < MOE_LOOP_TOLERANCE):
        raise AssertionError(f"{label} MoE layer {n}: dispatch "
                             f"{'ok' if same else 'differs'}, routing "
                             f"{'ok' if routed else 'differs'}, err {err}")
    return line


def moe_reckoning(cfg, b: int, s: int, max_seq: int) -> dict:
    """The memory of a prefill of B x S tokens, in bytes, as reckoned from
    the shapes: bf16 weights; per sequence the KV cache and the tensors
    ``moe_ffn_capacity`` holds at T = S, A = T x k assignments: the (T + 1,
    d) copy of x it gathers from, the (E, C, d) buffer and its output
    ``out_buf``, the SwiGLU's three (E, C, f) intermediates, the gated
    outputs ``y_a`` (A, d), and ``_pack_assignments``' (E, A) int32 one-hot
    with its running count.  They are held in turn, not all at once, so the
    sum bounds the layer's share from above."""
    from repro_torch.models import moe

    m = cfg.moe
    C = moe._capacity(s, m)
    a = s * m.top_k
    parts = {"x copy": (s + 1) * cfg.d_model * 2,
             "buffer and out_buf": 2 * m.n_experts * C * cfg.d_model * 2,
             "SwiGLU intermediates": 3 * m.n_experts * C * m.d_ff_expert * 2,
             "y_a": a * cfg.d_model * 2,
             "one-hot and running count": 2 * m.n_experts * a * 4}
    weights = 2 * cfg.param_count()
    kv = cfg.n_layers * 2 * max_seq * cfg.n_kv_heads * cfg.d_head * 2
    moe_bytes = sum(parts.values())
    return {"weights": weights, "kv": kv, "moe": moe_bytes, "parts": parts,
            "C": C, "total": weights + b * (kv + moe_bytes)}


def moe_k5_check(cfg, q, k, v, label: str, card: str) -> None:
    """Check (b): K5 on a served prefill's own layer-0 q, k, v held to its
    plain version at the bf16 tolerance and the one-step element gate, one
    query head at a time (a kv head's query group would hold 30-34 GB of
    fp32 scores at S 32,768), then timed beside its bound."""
    from repro_torch.kernels import flash_attention as fa

    k5 = "flash_attention"
    b, s = q.shape[:2]
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    got, expect = k5_sliced_check(q, k, v, None, None, heads=1)
    err, outside = rel_err(got, expect), beyond_bf16_step(got, expect)
    where = (f"{label} layer 0 B={b} S={s} H={h} Hk={hk} D={d} (GQA "
             f"{h // hk}:1) bf16")
    print(f"# check {k5} {where} (the served prefill's own q, k, v; plain "
          f"version per batch entry and query head): max rel err {err:.3e} "
          f"(tolerance {ATTN_TOLERANCE['bf16']:.0e}), max abs err "
          f"{abs_err(got, expect):.3e}, {outside} elements beyond one bf16 "
          "step")
    if not err < ATTN_TOLERANCE["bf16"] or outside:
        raise AssertionError(f"K5 disagrees with its plain version at "
                             f"{where}: {err}, {outside} elements beyond one "
                             "bf16 step")
    del got, expect
    nbytes, nops = k5_work(b, s, h, hk, d)
    bound = 1e3 * max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_BF16_OPS_PER_S)
    with torch.inference_mode():
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v))
    print(f"# time {k5} {where}: kernel {ms:.4f} ms ({nops / ms / 1e9:.1f} "
          f"TFLOP/s, {100 * bound / ms:.1f}% of the bound), bound "
          f"{bound:.4f} ms ({nops} op at the bf16 tensor-core rate) | {card}")


def mean_pairwise_cosine(h) -> float:
    """The mean cosine over all pairs of distinct rows of ``h`` (T, d), in
    fp32: (|sum of unit rows|^2 - T) / (T (T - 1))."""
    u = torch.nn.functional.normalize(h.float(), dim=-1)
    t = u.shape[0]
    total = u.sum(0)
    return float((total @ total - t) / (t * (t - 1)))


def moe_serving(dev, card: str, cfg, b: int, steps: int, label: str,
                launches: dict, check_layers, peak_limit: float) -> tuple:
    """One MoE cell: ``cfg`` drawn on the card from seed 0 in bf16, one
    warm-up prefill, then with the counts zeroed one prefill of B x 32,768
    seeded tokens (``prefill_32k``) and ``steps`` greedy decode steps; K5
    must launch once per layer, all in the prefill, and the peak device
    memory stay under ``peak_limit``.  Then a prefill and 8
    decode steps under ``torch.profiler``, and one more prefill that keeps
    layer 0's q, k, v, every layer's drop count and, at ``check_layers``,
    the MoE input, output and packing.  Returns (model, captures)."""
    from repro_torch import params
    from repro_torch.configs import LM_SHAPES
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr

    k5 = "flash_attention"
    s = LM_SHAPES["prefill_32k"].params["seq"]
    max_seq = s + steps
    m = cfg.moe
    t0 = time.perf_counter()
    model = params.draw_transformer(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters drawn, "
                             f"{cfg.param_count()} in the config")
    stds = {name: (float(w.float().std()), w.shape[-2] ** -0.5)
            for name, w in (("w_gate", model.layers[0].moe.w_gate[0]),
                            ("w_down", model.layers[0].moe.w_down[0]))}
    print(f"# {label} draw: layer 0 expert 0 " + ", ".join(
        f"{name} std {got:.6f} vs fan_in^-0.5 {want:.6f} ("
        f"{100 * (got / want - 1):+.2f}%)" for name, (got, want)
        in stds.items()))
    if any(abs(got / want - 1) > MOE_DRAW_STD_TOL
           for got, want in stds.values()):
        raise AssertionError(f"{label} expert weights drawn at {stds}")
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)), device=dev)
    prefill = tr.make_prefill_step(cfg, max_seq=max_seq)
    serve = tr.make_serve_step(cfg, max_seq)
    print(f"# {label} set-up: {cfg.n_layers} layers d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads x {cfg.d_head}, "
          f"{m.n_experts} experts top-{m.top_k} d_ff {m.d_ff_expert}"
          f"{f' + dense residual d_ff {m.dense_residual_d_ff}' if m.dense_residual_d_ff else ''}"
          f", capacity factor {m.capacity_factor} (C {moe._capacity(b * s, m)}"
          f" at T {b * s}), vocab {cfg.vocab}; {n_params} parameters "
          f"({n_params * 2 / 1e9:.2f} GB bf16) drawn on the card in "
          f"{draw_s:.3f} s; prefill_32k at B {b}, S {s}, max_seq {max_seq}, "
          f"{steps} decode steps; one warm-up prefill")
    prefill(model, prompts)  # cuBLAS handles and plans; not counted
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    logits, cache = prefill(model, prompts)
    end.record()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_ms = start.elapsed_time(end)
    per_prefill = ops.LAUNCHES[k5]
    token = logits.argmax(-1, keepdim=True)
    generated, step_s = [token], []
    for step in range(steps):
        t0 = time.perf_counter()
        step_logits, cache = serve(model, cache, token, s + step)
        token = step_logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        generated.append(token)
    served = ops.LAUNCHES[k5]
    peak = torch.cuda.max_memory_allocated()
    print(f"# {label} serving launches: {json.dumps({k5: served})} "
          f"({per_prefill} in the prefill)")
    if per_prefill != cfg.n_layers or served != cfg.n_layers:
        raise AssertionError(f"K5 launched {per_prefill} times in the "
                             f"{label} prefill and {served} in all; expected "
                             f"{cfg.n_layers}, one per layer, all in the "
                             "prefill")
    launches[k5] += served
    out = torch.cat(generated, dim=1)
    for name, t in (("prefill logits", logits),
                    ("last decode logits", step_logits)):
        if t.shape != (b, cfg.vocab) or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label} {name}: shape {tuple(t.shape)} "
                                 "or not finite")
    if out.shape != (b, steps + 1) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"{label} generated tokens {tuple(out.shape)}")
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    if shapes != {f"{n}{i}": e for i, e in enumerate(tr.cache_shapes(
            cfg, b, max_seq)) for n in "kv"}:
        raise AssertionError(f"{label} cache shapes {shapes}")
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    print(f"# {label} serving: prefill of {b} x {s} tokens "
          f"{prefill_s * 1e3:.3f} ms host clock, {prefill_ms:.3f} ms CUDA "
          f"events, {b * s / prefill_s:.0f} prefill tokens/s; {steps} decode "
          f"steps: p50 {percentile(step_s, 50) * 1e3:.3f} ms, p99 "
          f"{percentile(step_s, 99) * 1e3:.3f} ms per step ({b} tokens); KV "
          f"caches {cache_bytes / 1e9:.2f} GB; peak device memory "
          f"{peak / 1e9:.2f} GB of {torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}"
          f" | {card}")
    if peak > peak_limit:
        raise AssertionError(f"{label} cell peak memory {peak} B")
    del logits, step_logits, cache
    torch.cuda.empty_cache()
    # Where the device time goes: a prefill and 8 decode steps under
    # torch.profiler, outside the counted run.
    split = {"routing and dispatch": ("index", "gather", "scatter", "scan",
                                      "topk", "sort")}
    pre_kinds = device_time_by_kind(lambda: prefill(model, prompts), "K5",
                                    "flash_wgmma_kernel", extra=split)
    # One more prefill keeps what it hands K5 at layer 0, each layer's
    # dropped assignments, and at the checked layers the MoE input, output
    # and packing.
    captured = {"drops": [], "moe": {}, "pack": {}}
    counted, capacity_ffn = ops.flash_attention, moe.moe_ffn_capacity
    pack = moe._pack_assignments

    def keep_qkv(q, k, v, **kw):
        captured.setdefault("qkv", (q, k, v))
        return counted(q, k, v, **kw)

    def keep_moe(params_, x, mcfg):
        y, aux = capacity_ffn(params_, x, mcfg)
        n = len(captured["drops"]) - 1
        if n in check_layers:
            captured["moe"][n] = (x, y)
        return y, aux

    def keep_pack(*args):
        packed = pack(*args)
        if len(captured["drops"]) in check_layers:
            captured["pack"][len(captured["drops"])] = packed
        captured["drops"].append((~packed[3]).sum())
        return packed

    ops.flash_attention = keep_qkv
    moe.moe_ffn_capacity, moe._pack_assignments = keep_moe, keep_pack
    try:
        _, cache = prefill(model, prompts)
    finally:
        ops.flash_attention = counted
        moe.moe_ffn_capacity, moe._pack_assignments = capacity_ffn, pack
    token = generated[0]

    def decode_steps():
        nonlocal cache, token
        for step in range(PROFILED_STEPS):
            lg, cache = serve(model, cache, token, s + step)
            token = lg.argmax(-1, keepdim=True)

    dec_kinds = device_time_by_kind(decode_steps, "K5", "flash_wgmma_kernel",
                                    extra=split)
    del cache
    torch.cuda.empty_cache()
    step_ms = 1e3 * percentile(step_s, 50)
    for what, kinds_ms, host_ms, n in (
            ("prefill", pre_kinds, prefill_ms, 1),
            ("decode step", dec_kinds, step_ms, PROFILED_STEPS)):
        busy = sum(kinds_ms.values()) / n
        parts = ", ".join(f"{k} {v / n:.3f} ms" for k, v in kinds_ms.items())
        print(f"# where the time goes, {label} {what} (torch.profiler device"
              f" time{'' if n == 1 else f', mean of {n} steps'}; routing and "
              f"dispatch: index, gather, scatter, scan, top-k and sort "
              f"kernels, the embedding lookup among them): {parts}; device "
              f"busy {busy:.3f} ms of {host_ms:.3f} ms "
              f"({100 * busy / host_ms:.1f}%, the rest idle) | {card}")
    share = [float(d) / (b * s * m.top_k) for d in captured["drops"]]
    cosine = {n: mean_pairwise_cosine(captured["moe"][n][0])
              for n in sorted(captured["moe"])}
    ranked = sorted(share)
    print(f"# {label} drops: share of the prefill's {b * s * m.top_k} "
          f"assignments dropped per layer (C {moe._capacity(b * s, m)}): min "
          f"{ranked[0]:.4%}, median {statistics.median(ranked):.4%}, max "
          f"{ranked[-1]:.4%} over {len(share)} layers; " + ", ".join(
              f"layer {n} {share[n]:.4%} dropped, mean pairwise cosine of "
              f"its MoE inputs {c:.4f}" for n, c in cosine.items()))
    if len(share) != cfg.n_layers:
        raise AssertionError(f"{label}: {len(share)} MoE layers packed")
    return model, captured


def moe_phases(dev, card: str, launches: dict) -> None:
    """Phases 25-26: qwen3-moe-30b-a3b whole and arctic-480b with its depth
    cut, served at full width through the registry, with their checks.  Adds
    each served prefill's K5 launches to ``launches``."""
    from dataclasses import replace

    from repro_torch import backend, params
    from repro_torch.configs import LM_SHAPES, get_arch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr

    backend.full_fp32()
    torch.cuda.empty_cache()
    # 25. qwen3-moe-30b-a3b, full width and depth.
    t_phase = time.perf_counter()
    cfg = get_arch("qwen3-moe-30b-a3b").make_config()
    shape = LM_SHAPES["prefill_32k"].params
    s, b = shape["seq"], QWEN3_MOE_BATCH
    total = torch.cuda.get_device_properties(0).total_memory
    r = {n: moe_reckoning(cfg, n, s, s + QWEN3_MOE_STEPS) for n in (1, 2, 3)}
    print(f"# qwen3-moe reckoning: weights {r[1]['weights'] / 1e9:.2f} GB "
          f"bf16; per sequence the KV cache {r[1]['kv'] / 1e9:.2f} GB and "
          f"the MoE transients at T {s} (C {r[1]['C']}) "
          f"{r[1]['moe'] / 1e9:.2f} GB (" + ", ".join(
              f"{name} {n / 1e9:.2f} GB" for name, n in r[1]["parts"].items())
          + "); B 1 / 2 / 3 reckon to "
          + " / ".join(f"{r[n]['total'] / 1e9:.2f}" for n in (1, 2, 3))
          + f" GB of the card's {total / 1e9:.2f} GB; cut: prefill_32k's "
          f"batch {shape['batch']} -> {b} (B 2 while the cell peaks at most "
          f"{QWEN3_MOE_PEAK_LIMIT / 1e9:.0f} GB, else 1)")
    model, cap = moe_serving(dev, card, cfg, b, QWEN3_MOE_STEPS, "qwen3-moe",
                             launches, (0, cfg.n_layers - 1),
                             QWEN3_MOE_PEAK_LIMIT)
    # (a) the dispatch at the first and the last layer.
    for n in sorted(cap["moe"]):
        h, out = cap["moe"].pop(n)
        moe_dispatch_check(cfg, model.layers[n], n, h, out,
                           cap["pack"].pop(n), "qwen3-moe")
        del h, out
    q, k, v = cap.pop("qkv")
    del model, cap
    torch.cuda.empty_cache()
    # (b) K5 on the prefill's own q, k, v at layer 0 (GQA 8:1).
    moe_k5_check(cfg, q, k, v, "qwen3-moe", card)
    del q, k, v
    torch.cuda.empty_cache()
    # (c) and (d) in f32 at full width and vocab, depth cut to 2 layers.
    cfg32 = replace(cfg, n_layers=MOE_CHECK_LAYERS, dtype="float32")
    model32 = params.draw_transformer(cfg32, seed=0, device=dev)
    T, cf = MOE_FFN_CASE
    case = replace(cfg.moe, capacity_factor=cf)
    x = torch.randn(T, cfg.d_model, generator=torch.Generator().manual_seed(
        2)).to(dev)
    with torch.inference_mode():
        y_ref, _ = moe.moe_ffn_reference(model32.layers[0].moe, x, case)
        y_cap, _ = moe.moe_ffn_capacity(model32.layers[0].moe, x, case)
    err = rel_err(y_cap, y_ref)
    print(f"# check qwen3-moe moe_ffn_capacity vs moe_ffn_reference, f32 at "
          f"full width (d {cfg.d_model}, {case.n_experts} experts top-"
          f"{case.top_k}, d_ff {case.d_ff_expert}), T {T}, capacity factor "
          f"{cf} (C {moe._capacity(T, case)}: nothing drops): max rel err "
          f"{err:.3e} (tolerance {TOLERANCE['f32']:.0e})")
    if not err < TOLERANCE["f32"]:
        raise AssertionError(f"qwen3-moe capacity vs reference path: {err}")
    del x, y_ref, y_cap
    n_tok = MOE_CHECK_PROMPT + MOE_CHECK_STEPS
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, n_tok)))

    def run(model_, toks):
        """Prefill, caches, 8 teacher-forced decode steps and every router
        call's top-k, on the model's device."""
        routes = []
        router = moe.router_topk

        def keep_route(*args):
            idx, gates, aux = router(*args)
            routes.append(idx.cpu())
            return idx, gates, aux

        moe.router_topk = keep_route
        try:
            lg, cache = tr.make_prefill_step(cfg32, max_seq=n_tok)(
                model_, toks[:, :MOE_CHECK_PROMPT])
            steps = []
            serve32 = tr.make_serve_step(cfg32, n_tok)
            for pos in range(MOE_CHECK_PROMPT, n_tok):
                step_lg, cache = serve32(model_, cache, toks[:, pos:pos + 1],
                                         pos)
                steps.append(step_lg.cpu())
        finally:
            moe.router_topk = router
        return (lg.cpu(), {k_: c.cpu() for k_, c in cache.items()}, steps,
                routes)

    card_out = run(model32, tokens.to(dev))
    model32.cpu()
    torch.cuda.empty_cache()
    cpu_out = run(model32, tokens)
    differ = sum(int((a != c).sum()) for a, c in zip(card_out[3], cpu_out[3]))
    print(f"# check qwen3-moe f32 {MOE_CHECK_LAYERS} layers, vocab "
          f"{cfg.vocab}: router top-{cfg.moe.top_k} indices card vs CPU over "
          f"{len(card_out[3])} calls (prefill and {MOE_CHECK_STEPS} decode "
          f"steps at {MOE_CHECK_LAYERS} layers): {differ} assignments differ")
    if differ or len(card_out[3]) != len(cpu_out[3]):
        raise AssertionError(f"qwen3-moe routing differs card vs CPU at "
                             f"{differ} assignments")
    errs = {f"prefill logits B=1 S={MOE_CHECK_PROMPT}": rel_err(card_out[0],
                                                                cpu_out[0])}
    for key in cpu_out[1]:
        errs[f"cache {key}"] = rel_err(card_out[1][key], cpu_out[1][key])
    errs[f"{MOE_CHECK_STEPS} decode steps (worst)"] = max(
        rel_err(a, c) for a, c in zip(card_out[2], cpu_out[2]))
    for name, err in errs.items():
        print(f"# check qwen3-moe f32 card vs CPU: {name} max rel err "
              f"{err:.3e} (tolerance {SERVE_TOLERANCE:.0e})")
        if not err < SERVE_TOLERANCE:
            raise AssertionError(f"qwen3-moe f32 {name}: {err}")
    del model32, card_out, cpu_out
    torch.cuda.empty_cache()
    print(f"# phase 25 took {time.perf_counter() - t_phase:.1f} s (host "
          "clock)")

    # 26. arctic-480b at full width, depth cut.
    t_phase = time.perf_counter()
    full = get_arch("arctic-480b").make_config()
    cfg = replace(full, n_layers=ARCTIC_LAYERS)
    per_layer = (full.param_count() - cfg.param_count()) / (
        full.n_layers - ARCTIC_LAYERS)
    print(f"# arctic reckoning: {full.param_count()} parameters "
          f"({2 * full.param_count() / 1e9:.2f} GB bf16), "
          f"{2 * per_layer / 1e9:.2f} GB a layer; cut: depth "
          f"{full.n_layers} -> {ARCTIC_LAYERS} ({2 * cfg.param_count() / 1e9:.2f}"
          f" GB with the embeddings; {ARCTIC_LAYERS + 1} layers would take "
          f"{2 * (cfg.param_count() + per_layer) / 1e9:.2f} GB of the card's "
          f"{total / 1e9:.2f}), prefill_32k's batch {shape['batch']} -> 1")
    model, cap = moe_serving(dev, card, cfg, 1, ARCTIC_STEPS, "arctic",
                             launches, (0,), QWEN3_MOE_PEAK_LIMIT)
    h, out = cap["moe"].pop(0)
    moe_dispatch_check(cfg, model.layers[0], 0, h, out, cap["pack"].pop(0),
                       "arctic")
    q, k, v = cap.pop("qkv")
    del model, cap, h, out
    torch.cuda.empty_cache()
    # (b) K5 on the prefill's own q, k, v at layer 0 (GQA 7:1).
    moe_k5_check(cfg, q, k, v, "arctic", card)
    del q, k, v
    torch.cuda.empty_cache()
    print(f"# phase 26 took {time.perf_counter() - t_phase:.1f} s (host "
          "clock)")



def tree_rel_err(got, want, share: float = 1e-2, keep=None) -> float:
    """The worst leaf of two trees of tensors: each leaf's max abs error
    relative to its own largest entry, or to ``share`` of the tree's
    largest where a leaf is near zero.  ``keep``, a tree of boolean masks
    (or None) beside ``want``'s leaves, limits each leaf's error to the
    entries it keeps."""
    from repro_torch.tree import tree_leaves

    g = [t.detach().float().cpu() for t in tree_leaves(got)]
    w = [t.detach().float().cpu() for t in tree_leaves(want)]
    masks = [None] * len(w) if keep is None else tree_leaves(keep)
    if len(g) != len(w) or len(masks) != len(w):
        raise AssertionError(f"{len(g)} leaves against {len(w)}")
    top = max(float(t.abs().max()) if t.numel() else 0.0 for t in w)
    worst = 0.0
    for a, b, m in zip(g, w, masks):
        diff = (a - b).abs() if m is None else (a - b).abs()[m.cpu()]
        scale = max(float(b.abs().max()) if b.numel() else 0.0, share * top,
                    1e-30)
        worst = max(worst, float(diff.max()) / scale if diff.numel()
                    else 0.0)
    return worst


def synced(step_fn):
    """``step_fn`` that waits for the card at its end, so the loop's step
    time is the step's."""
    def run(state, batch):
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        return state, metrics
    return run


def exact_gnn_gradient(step_fn, state, batch):
    """The gradient of a GNN trainer's loss at ``state``, evaluated in f64
    on the CPU: every floating tensor of the weights and the graph widened,
    and the tensors the models make f64 by default."""
    import dataclasses

    from repro_torch.tree import tree_map

    def wide(t):
        return (t.double() if torch.is_tensor(t) and t.is_floating_point()
                else t)

    fields = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        fields[f.name] = ({k: wide(w) for k, w in v.items()}
                          if isinstance(v, dict) else wide(v))
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return step_fn.grad_fn(tree_map(wide, state[0]),
                               dataclasses.replace(batch, **fields))[1]
    finally:
        torch.set_default_dtype(before)


def card_vs_cpu_steps(family: str, arch, args, dev, n: int,
                      exact=None) -> dict:
    """``n`` steps of the trainer's set-up on the card and on the CPU from
    the CPU's weights, each step taken in its two halves (``grad_fn``, then
    the optimizer, which spends the gradients' buffers).  The worst
    relative errors (:func:`tree_rel_err`):

    - ``step_*``: the card's step from the CPU's state before it, which
      chaotic dynamics cannot magnify: ``step_loss``; ``step_grad`` the
      gradient; ``step_update`` the
      parameters and moments after the card's optimizer spent the card's
      gradient against the CPU's optimizer spending the same gradient;
      ``step_params`` the parameters after the two steps over the entries
      whose CPU gradient is not zero to rounding (above
      ``GRAD_ROUNDING_SHARE`` of its leaf's largest); ``step_moments``;
    - ``traj_*``: the two free trajectories: the losses, the parameters
      over the entries whose CPU gradient was above that share at every
      step (``kept``, their share of all), the moments, and every
      parameter and moment (``traj_state``);
    - with ``exact(step_fn, state, batch)``, an f64 gradient on the CPU:
      ``exact_cpu`` and ``exact_card``, the CPU's and the card's f32
      gradients against it from the same states."""
    from repro_torch.launch import train
    from repro_torch.optim.optimizers import apply_updates
    from repro_torch.tree import tree_leaves, tree_map

    def copy_to(tree, device):
        return tree_map(lambda t: t.to(device, copy=True), tree)

    def gradient(step_fn, state, batch):
        (_, metrics), grads = step_fn.grad_fn(state[0], batch)
        return metrics, grads

    def update(step_fn, state, grads):
        params, opt_state = state
        updates, opt_state = step_fn.optimizer.update(grads, opt_state,
                                                      params)
        return (apply_updates(params, updates,
                              donate=step_fn.optimizer.donate), opt_state)

    cpu = torch.device("cpu")
    cpu_state, cpu_step, cpu_batch = train.SETUPS[family](arch, args, cpu)
    card_state = copy_to(cpu_state, dev)
    _, card_step, card_batch = train.SETUPS[family](arch, args, dev)
    err = dict.fromkeys(("step_loss", "step_grad", "step_update",
                         "step_params", "step_moments", "traj_loss")
                        + (("exact_cpu", "exact_card") if exact else ()),
                        0.0)

    def loss_err(a, b):
        return abs(float(a["loss"]) - float(b["loss"])) / max(
            abs(float(b["loss"])), 1e-30)

    kept = None
    for i in range(n):
        forced = copy_to(cpu_state, dev)
        m_forced, g_forced = gradient(card_step, forced, card_batch(i))
        m_card, g_card = gradient(card_step, card_state, card_batch(i))
        m_cpu, g_cpu = gradient(cpu_step, cpu_state, cpu_batch(i))
        step = {"step_grad": tree_rel_err(g_forced, g_cpu)}
        if exact:
            g_exact = exact(cpu_step, cpu_state, cpu_batch(i))
            step["exact_cpu"] = tree_rel_err(g_cpu, g_exact)
            step["exact_card"] = tree_rel_err(g_forced, g_exact)
            del g_exact
        keep = tree_map(lambda g: g.abs() > GRAD_ROUNDING_SHARE
                        * g.abs().max(), g_cpu)
        kept = keep if kept is None else tree_map(torch.logical_and, kept,
                                                  keep)
        same = update(cpu_step, copy_to(cpu_state, cpu),
                      copy_to(g_forced, cpu))
        forced = update(card_step, forced, g_forced)
        card_state = update(card_step, card_state, g_card)
        cpu_state = update(cpu_step, cpu_state, g_cpu)
        step.update(
            traj_loss=loss_err(m_card, m_cpu),
            step_loss=loss_err(m_forced, m_cpu),
            step_update=tree_rel_err(forced, same),
            step_params=tree_rel_err(forced[0], cpu_state[0], keep=keep),
            step_moments=tree_rel_err(forced[1], cpu_state[1]))
        for key, value in step.items():
            err[key] = max(err[key], value)
        del forced, same, g_forced, g_card, g_cpu
    err["traj_params"] = tree_rel_err(card_state[0], cpu_state[0], keep=kept)
    err["traj_moments"] = tree_rel_err(card_state[1], cpu_state[1])
    err["traj_state"] = tree_rel_err(card_state, cpu_state)
    err["kept"] = (sum(int(m.sum()) for m in tree_leaves(kept))
                   / sum(m.numel() for m in tree_leaves(kept)))
    return err


def check_line(err: dict) -> str:
    """:func:`card_vs_cpu_steps`'s errors, as the phases print them."""
    exact = (f" (against an f64 gradient: the CPU's f32 "
             f"{err['exact_cpu']:.3e}, the card's {err['exact_card']:.3e})"
             if "exact_cpu" in err else "")
    return (f"each step from the CPU's state: loss {err['step_loss']:.3e}, "
            f"gradients {err['step_grad']:.3e}{exact}, the update of one "
            f"gradient (parameters and moments) {err['step_update']:.3e}, "
            f"parameters whose gradient is not zero to rounding "
            f"{err['step_params']:.3e}, moments {err['step_moments']:.3e}; "
            f"the free trajectories: losses {err['traj_loss']:.3e}, the "
            f"{100 * err['kept']:.1f}% of parameters whose gradient never "
            f"was zero to rounding {err['traj_params']:.3e}, moments "
            f"{err['traj_moments']:.3e}, every parameter and moment "
            f"{err['traj_state']:.3e} (tolerance {TRAIN_TOLERANCE:.0e})")


def hold(err: dict, resolved: bool, label: str) -> None:
    """Raises unless ALWAYS_KEYS and, where the f32 gradient is
    ``resolved``, RESOLVED_KEYS are below TRAIN_TOLERANCE."""
    keys = ALWAYS_KEYS + (RESOLVED_KEYS if resolved else ())
    bad = {k: err[k] for k in keys if not err[k] < TRAIN_TOLERANCE}
    if bad:
        raise AssertionError(f"{label} card vs CPU: {bad} (all: {err})")


def train_args(*argv) -> object:
    from repro_torch.launch import train

    return train.build_parser().parse_args([str(a) for a in argv])


def substrate_phase(dev, card: str) -> None:
    """Phase 27: the optimizers, compression and checkpoints on the card
    against the CPU, and K6's autograd ``Function`` (forward bit-identical,
    table gradient against autograd through the plain bag)."""
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.data import synthetic
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.optim import optimizers as optim
    from repro_torch.optim.compression import compress_decompress
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(27)
    leaves = [(1024, 576), (576,), (49152, 64), (9, 64), (30, 1536)]
    base = [torch.randn(s, generator=gen) for s in leaves]
    grads = [[torch.randn(s, generator=gen) * 3 for s in leaves]
             for _ in range(3)]

    def as_tree(ts):
        return {"w": ts[0], "b": ts[1], "nested": {"z": ts[2],
                                                   "a": [ts[3], ts[4]]}}

    runs = {
        "adamw clip 1.0, cosine, wd 0.1": lambda: optim.adamw(
            optim.cosine_schedule(3e-3, warmup=2, total=10),
            weight_decay=0.1),
        "adamw donated": lambda: optim.adamw(
            optim.cosine_schedule(3e-3, warmup=2, total=10),
            weight_decay=0.1, donate=True),
        "sgd momentum 0.9, clip 1.0": lambda: optim.sgd(0.05, clip_norm=1.0),
    }
    states = {}
    for name, make in runs.items():
        out = []
        for d in (dev, cpu):
            opt = make()
            p = as_tree([t.clone().to(d) for t in base])
            s = opt.init(p)
            for g in grads:
                u, s = opt.update(as_tree([t.clone().to(d) for t in g]), s, p)
                p = optim.apply_updates(p, u, donate=opt.donate)
            out.append((p, s))
        err = tree_rel_err(out[0], out[1])
        states[name] = out
        print(f"# substrate {name}: 3 updates of a 5-leaf tree "
              f"({sum(t.numel() for t in base)} parameters), card vs CPU max "
              f"rel err {err:.3e} (tolerance {OPTIM_TOLERANCE:.0e})")
        if not err < OPTIM_TOLERANCE:
            raise AssertionError(f"{name}: card vs CPU {err}")
    g_card = grads[0][2].to(dev)
    e_card = torch.zeros_like(g_card)
    g_cpu, e_cpu = grads[0][2].clone(), torch.zeros_like(grads[0][2])
    for _ in range(3):
        (d1, e_card), (d2, e_cpu) = (compress_decompress(g_card, e_card),
                                     compress_decompress(g_cpu, e_cpu))
        if not (torch.equal(d1.cpu(), d2) and torch.equal(e_card.cpu(),
                                                          e_cpu)):
            raise AssertionError("compress_decompress differs card vs CPU")
    print(f"# substrate compress_decompress: 3 error-feedback rounds of "
          f"{g_cpu.numel()} values bit-identical card vs CPU")
    card_state = states["adamw clip 1.0, cosine, wd 0.1"][0]
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(3, card_state)
        like_cpu = tree_map(lambda t: torch.zeros_like(t, device=cpu),
                            card_state)
        _, on_cpu = mgr.restore(like_cpu)
        mgr.save(4, on_cpu)
        _, back = mgr.restore(like_cpu, device=dev)
    same = all(torch.equal(a.cpu(), b) and b.device.type == "cpu"
               and c.device == a.device and torch.equal(a, c)
               for a, b, c in zip(tree_leaves(card_state),
                                  tree_leaves(on_cpu), tree_leaves(back)))
    print(f"# substrate checkpoint: a CUDA (params, AdamW state) of "
          f"{len(tree_leaves(card_state))} leaves saved, restored onto the "
          f"CPU, saved again and restored onto the card: equal leaf for leaf "
          f"{same}")
    if not same:
        raise AssertionError("checkpoint round trip card -> CPU -> card")

    cfg = dlrm_mlperf.make_config(vocab_sizes=tuple(
        min(v, BAG_GRAD_ROW_CAP) for v in dlrm.CRITEO_1TB_VOCABS))
    batch = synthetic.criteo_batch(27, 0, batch=BAG_GRAD_BATCH,
                                   n_dense=cfg.n_dense,
                                   vocab_sizes=cfg.vocab_sizes,
                                   multi_hot=cfg.multi_hot)
    sparse = torch.from_numpy(batch["sparse"]).to(dev)
    worst, exact = 0.0, True
    for t, v in enumerate(cfg.vocab_sizes):
        table = torch.randn(v, cfg.embed_dim, generator=gen).to(dev)
        ids = sparse[:, t, :]
        ct = torch.randn(BAG_GRAD_BATCH, cfg.embed_dim,
                         generator=gen).to(dev)
        t1 = table.clone().requires_grad_()
        out = ops.embedding_bag_autograd(t1, ids)
        (out * ct).sum().backward()
        with torch.no_grad():
            exact &= torch.equal(out, eb.embedding_bag_plain(table, ids))
        t2 = table.clone().requires_grad_()
        acc = torch.zeros(BAG_GRAD_BATCH, cfg.embed_dim, device=dev)
        for h in range(ids.shape[1]):
            acc = acc + t2[ids[:, h].long()]
        (acc * ct).sum().backward()
        worst = max(worst, rel_err(t1.grad, t2.grad))
    print(f"# substrate K6 autograd Function at DLRM-MLPerf widths (26 "
          f"tables capped at {BAG_GRAD_ROW_CAP} rows, D {cfg.embed_dim}, B "
          f"{BAG_GRAD_BATCH}): forward bit-identical to the plain version "
          f"{exact}; table gradient (index_add_) vs autograd through the "
          f"plain gather-and-add max rel err {worst:.3e} (tolerance "
          f"{BAG_GRAD_TOLERANCE:.0e})")
    if not (exact and worst < BAG_GRAD_TOLERANCE):
        raise AssertionError(f"K6 Function: forward {exact}, grad {worst}")
    print(f"# phase 27 took {time.perf_counter() - t_phase:.1f} s (host "
          "clock)")


def step_kinds(grad_fn, optimizer, state, batch, kernel: str, fragments,
               extra=None) -> tuple[dict, list]:
    """One step's device time by kind, the gradient and the update profiled
    apart (the update is every kernel of ``optimizer.update`` and
    ``apply_updates``), and the 8 kernels that took longest."""
    from repro_torch.optim.optimizers import apply_updates

    params, opt_state = state
    names: dict = {}
    out: dict = {}

    def grad():
        out["grads"] = grad_fn(params, batch)[1]

    kinds = device_time_by_kind(grad, kernel, fragments, extra,
                                by_name=names)
    grads = out.pop("grads")

    def update():
        u, _ = optimizer.update(grads, opt_state, params)
        apply_updates(params, u, donate=optimizer.donate)

    opt = device_time_by_kind(update, kernel, fragments, extra,
                              by_name=names)
    kinds["optimizer (AdamW update, applied)"] = sum(opt.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    top += [(f"[{kernel}] {n}", ms) for n, ms in names.items()
            if any(f in n.lower() for f in ((fragments,)
                                            if isinstance(fragments, str)
                                            else fragments))][:2]
    return kinds, top


def lm_training_phase(dev, card: str) -> None:
    """Phase 28: SmolLM-135M trained at full width and depth at
    ``train_4k`` (B cut to 8) through ``launch.train``, with a checkpoint
    every 2 steps and a failure injected at step 3, held to an
    uninterrupted run; K5 launches 0 (training attention is the chunked
    plain path, as in the reference); the device time of a step by kind;
    and the f32 trajectory at 2 layers, card vs CPU."""
    import dataclasses
    import tempfile
    from functools import partial

    from repro_torch import backend
    from repro_torch.configs import LM_SHAPES, get_arch
    from repro_torch.distributed.resilience import run_resilient
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import transformer as tr
    from repro_torch.optim.optimizers import adamw, cosine_schedule
    from repro_torch.tree import value_and_grad

    t_phase = time.perf_counter()
    backend.full_fp32()
    torch.cuda.empty_cache()
    arch = get_arch("smollm-135m")
    cfg = arch.make_config()
    shape = LM_SHAPES["train_4k"].params
    s, b = shape["seq"], LM_TRAIN_BATCH
    n_params = cfg.param_count()
    state_bytes = train.TRAIN_BYTES_PER_PARAM * n_params
    argv = ["--arch", arch.name, "--full", "--batch", b, "--seq", s,
            "--steps", LM_TRAIN_STEPS, "--lr", TRAIN_LR, "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        state, failed = train.train(train_args(
            *argv, "--checkpoint-every", LM_TRAIN_EVERY, "--fail-at",
            LM_TRAIN_FAIL, "--ckpt-dir", ckpt))
        failed_s = time.perf_counter() - t0
        kept = sorted(p.name for p in Path(ckpt).iterdir())
    peak = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    # The uninterrupted run: the trainer's set-up and loop, no checkpoint,
    # each step waited for (its dt is the step's time).
    args = train_args(*argv)
    state, step_fn, batch_fn = train.SETUPS["lm"](arch, args, dev)
    t0 = time.perf_counter()
    state, clean = run_resilient(state=state, step_fn=synced(step_fn),
                                 batch_fn=batch_fn, n_steps=LM_TRAIN_STEPS,
                                 log_every=0)
    clean_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"# smollm train set-up: {cfg.name} {cfg.n_layers} layers d "
          f"{cfg.d_model}, {n_params} parameters, f32 weights drawn on the "
          f"card (params.draw_transformer, seed 0), bf16 compute, remat "
          f"{cfg.remat!r}, q_chunk {cfg.q_chunk}; AdamW (cosine schedule, "
          f"lr {TRAIN_LR}, warm-up 20, wd 0.1, clip 1.0); {state_bytes / 1e9:.2f}"
          f" GB of weights, gradients and moments; cut: train_4k's batch "
          f"{shape['batch']} -> {b} (S {s})")
    steps = [h["step"] for h in failed]
    expect = (list(range(LM_TRAIN_FAIL))
              + list(range(LM_TRAIN_FAIL - LM_TRAIN_FAIL % LM_TRAIN_EVERY,
                           LM_TRAIN_STEPS)))
    print(f"# smollm train run (launch.train.train, checkpoint every "
          f"{LM_TRAIN_EVERY}, failure at step {LM_TRAIN_FAIL}): steps "
          f"{steps}, checkpoints kept {kept}, {failed_s:.1f} s with the "
          f"saves and the restore; uninterrupted run {clean_s:.1f} s (host "
          f"clock)")
    if steps != expect:
        raise AssertionError(f"smollm rollback replayed steps {steps}, "
                             f"expected {expect}")
    by_step = {h["step"]: h for h in clean}
    worst = 0.0
    for h in failed:
        for key in ("loss", "ce"):
            want = by_step[h["step"]][key]
            worst = max(worst, abs(h[key] - want) / max(abs(want), 1e-30))
    losses = [h["loss"] for h in clean]
    print(f"# smollm train check: the failed run's history (before and "
          f"after the rollback) vs the uninterrupted run's, max rel err "
          f"{worst:.3e} (tolerance {LM_ROLLBACK_TOLERANCE:.0e}); loss "
          f"{losses[0]!r} -> {losses[-1]!r}; launches {json.dumps(launches)}")
    if not worst < LM_ROLLBACK_TOLERANCE:
        raise AssertionError(f"smollm rollback history differs: {worst}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"smollm loss did not fall: {losses}")
    if any(launches.values()):
        raise AssertionError(f"smollm training launched kernels: {launches}")
    dts = [h["dt"] for h in clean]
    p50 = percentile(dts, 50)
    total = torch.cuda.get_device_properties(0).total_memory
    per_seq = (peak - state_bytes) / b
    b_max = int((total - state_bytes) // per_seq)
    print(f"# smollm train times: step p50 {p50 * 1e3:.1f} ms, p99 "
          f"{percentile(dts, 99) * 1e3:.1f} ms over {len(dts)} steps (first "
          f"{dts[0] * 1e3:.1f} ms), {b * s / p50:.0f} tokens/s; peak device "
          f"memory {peak / 1e9:.2f} GB | {card}")
    print(f"# smollm train reckoning: peak {peak / 1e9:.2f} GB = "
          f"{state_bytes / 1e9:.2f} GB of state + {per_seq / 1e9:.3f} GB a "
          f"sequence of {s} tokens; the card's {total / 1e9:.2f} GB admit B "
          f"{b_max} (train_4k asks {shape['batch']})")
    optimizer = adamw(cosine_schedule(TRAIN_LR, warmup=20,
                                      total=LM_TRAIN_STEPS),
                      weight_decay=0.1, donate=True)
    grad_fn = value_and_grad(partial(tr.loss_fn, cfg))
    t_profile = time.perf_counter()
    kinds, top = step_kinds(
        grad_fn, optimizer, state, batch_fn(0), "f32 products (attention "
        "einsums)", ("sgemm", "f32f32", "gemm_f32", "_sss_"))
    busy = sum(kinds.values())
    print(f"# where the time goes, smollm train step (B {b}, S {s}; "
          f"torch.profiler device time, gradient and update profiled "
          f"apart): " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                 kinds.items())
          + f"; device busy {busy:.1f} ms of a {p50 * 1e3:.1f} ms step "
          f"({100 * busy / (p50 * 1e3):.1f}%, the rest idle) | {card}")
    print("# smollm train top kernels: " + "; ".join(
        f"{name[:90]} {ms:.1f} ms" for name, ms in top))
    del state, step_fn, batch_fn, grad_fn
    torch.cuda.empty_cache()

    # f32 at 2 layers, full width and vocab: card vs CPU from one draw.
    t_check = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS,
                                dtype="float32")
    arch32 = dataclasses.replace(arch, make_config=lambda: cfg32)
    err = card_vs_cpu_steps("lm", arch32, train_args(
        "--arch", arch.name, "--full", "--batch", LM_CHECK_BATCH, "--seq",
        LM_CHECK_SEQ, "--steps", LM_CHECK_STEPS, "--lr", TRAIN_LR,
        "--device", "cpu"), dev, LM_CHECK_STEPS)
    print(f"# smollm train f32 check ({LM_CHECK_LAYERS} layers, full width "
          f"and vocab {cfg.vocab}, B {LM_CHECK_BATCH}, S {LM_CHECK_SEQ}, "
          f"{LM_CHECK_STEPS} steps, TF32 off), card vs CPU: "
          + check_line(err))
    hold(err, True, "smollm f32")
    if not err["traj_state"] < TRAIN_TOLERANCE:
        raise AssertionError(f"smollm f32 card vs CPU: {err}")
    torch.cuda.empty_cache()
    print(f"# phase 28 took {time.perf_counter() - t_phase:.1f} s (host "
          f"clock): the two runs {failed_s + clean_s:.1f} s, set-up and "
          f"reckoning {t_profile - t_phase - failed_s - clean_s:.1f} s, the "
          f"profiled step {t_check - t_profile:.1f} s, the f32 card-vs-CPU "
          f"check {time.perf_counter() - t_check:.1f} s")


def gnn_training_phase(dev, card: str) -> None:
    """Phase 29: the four GNNs trained at their published configs through
    the trainer on a full_graph_sm-sized graph (GCN-Cora with a failure
    injected), every loss falling, and 5 steps card vs CPU from the same
    weights, at the trainer's seed.  No kernel
    launches: the reference's GNN training reaches no Pallas kernel."""
    import tempfile

    from repro_torch import backend, params
    from repro_torch.configs import GNN_SHAPES, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    backend.full_fp32()
    ops.reset_launches()
    p = GNN_SHAPES["full_graph_sm"].params
    check_s = 0.0
    for name in ("gcn-cora", "gatedgcn", "meshgraphnet", "equiformer-v2"):
        arch = get_arch(name)
        steps = GCN_TRAIN_STEPS if name == "gcn-cora" else GNN_TRAIN_STEPS
        argv = ["--arch", name, "--full", "--gnn-nodes", p["n_nodes"],
                "--gnn-edges", p["n_edges"], "--lr", GNN_TRAIN_LR]
        extra = (["--fail-at", GCN_TRAIN_FAIL] if name == "gcn-cora" else [])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as ckpt:
            t0 = time.perf_counter()
            state, hist = train.train(train_args(
                *argv, *extra, "--steps", steps, "--checkpoint-every",
                GNN_TRAIN_EVERY, "--device", "cuda", "--ckpt-dir", ckpt))
            run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        # Step times: the trainer's step, each waited for.
        args = train_args(*argv, "--device", "cuda")
        _, step_fn, batch_fn = train.SETUPS["gnn"](arch, args, dev)
        g = batch_fn(0)
        dts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step_fn(state, g)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        del state, step_fn, batch_fn, g
        losses = [h["loss"] for h in hist]
        n_params = sum(np.asarray(a).size for a in _leaves(
            params.gnn_params(arch.make_config(), 0)))
        print(f"# gnn train {name}: published config ({n_params} "
              f"parameters), V {p['n_nodes']} E {p['n_edges']}, {len(hist)} "
              f"steps{' with a failure at step ' + str(GCN_TRAIN_FAIL) if extra else ''}"
              f" at lr {GNN_TRAIN_LR} in {run_s:.2f} s (host clock); loss "
              f"{losses[0]!r} -> {losses[-1]!r} ("
              + " ".join(f"{v:.4g}" for v in losses)
              + f"); step p50 {percentile(dts, 50) * 1e3:.2f} ms (5 steps "
              f"waited for); peak device memory {peak / 1e9:.3f} GB | {card}")
        records = (steps + GCN_TRAIN_FAIL % GNN_TRAIN_EVERY if extra
                   else steps)
        if not (all(np.isfinite(losses)) and len(hist) == records
                and losses[-1] < losses[0]):
            raise AssertionError(f"{name} run: {len(hist)} records, loss "
                                 f"{losses}")
        # Card vs CPU, 5 steps from the same weights (the CPU's, copied).
        n, e = GNN_CHECK_GRAPH
        resolved = name not in GNN_F32_UNRESOLVED
        t_check = time.perf_counter()
        err = card_vs_cpu_steps("gnn", arch, train_args(
            "--arch", name, "--full", "--gnn-nodes", n, "--gnn-edges", e,
            "--lr", GNN_TRAIN_LR, "--seed", 0, "--device", "cpu"), dev,
            GNN_CHECK_STEPS, exact=None if resolved else exact_gnn_gradient)
        print(f"# gnn train {name} check (seed 0, V {n} E {e}, "
              f"{GNN_CHECK_STEPS} steps, TF32 off), card vs CPU: "
              + check_line(err) + ("" if resolved else
                                   "; held: " + ", ".join(ALWAYS_KEYS)))
        hold(err, resolved, name)
        check_s += time.perf_counter() - t_check
    phase = dict(ops.LAUNCHES)
    took = time.perf_counter() - t_phase
    print(f"# gnn train launches: {json.dumps(phase)} (the reference's GNN "
          f"training reaches no Pallas kernel); phase 29 took {took:.1f} s "
          f"(host clock): training runs and step times {took - check_s:.1f}"
          f" s, card-vs-CPU checks {check_s:.1f} s")
    if any(phase.values()):
        raise AssertionError(f"GNN training launched kernels: {phase}")


def dlrm_training_phase(dev, card: str, launches: dict) -> None:
    """Phase 30: DLRM-MLPerf trained at published widths and train_batch
    with every table capped at 4M rows, K6 in each step's forward (exactly
    26 launches a step) and the table gradients by ``index_add_``; the
    device time of a step by kind; 3 steps card vs CPU in f32 at 65,536-row
    tables, at the trainer's seed.  Adds the steps' K6
    launches to ``launches``."""
    import dataclasses

    from repro_torch import backend
    from repro_torch.configs import RECSYS_SHAPES, get_arch
    from repro_torch.distributed.resilience import run_resilient
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import dlrm

    t_phase = time.perf_counter()
    backend.full_fp32()
    torch.cuda.empty_cache()
    arch = get_arch("dlrm-mlperf")
    full = arch.make_config()
    cfg = arch.make_config(vocab_sizes=tuple(
        min(v, DLRM_TRAIN_ROW_CAP) for v in dlrm.CRITEO_1TB_VOCABS))
    serve_cap = arch.make_config(vocab_sizes=tuple(
        min(v, DLRM_ROW_CAP) for v in dlrm.CRITEO_1TB_VOCABS))
    per = train.TRAIN_BYTES_PER_PARAM
    b = RECSYS_SHAPES["train_batch"].params["batch"]
    free, total = torch.cuda.mem_get_info(dev)
    print(f"# dlrm train reckoning ({per} B a parameter: f32 weights, "
          f"gradients, two moments): published {sum(full.vocab_sizes)} rows "
          f"{per * full.param_count() / 1e9:.2f} GB; the serving cap "
          f"({DLRM_ROW_CAP} rows a table) {sum(serve_cap.vocab_sizes)} rows "
          f"{per * serve_cap.param_count() / 1e9:.2f} GB; cut: every table "
          f"capped at {DLRM_TRAIN_ROW_CAP} rows, {sum(cfg.vocab_sizes)} rows"
          f", {4 * cfg.param_count() / 1e9:.2f} GB of f32 weights and "
          f"{per * cfg.param_count() / 1e9:.2f} GB with gradients and "
          f"moments ({free / 1e9:.2f} of {total / 1e9:.2f} GB free); no "
          f"checkpoint (the state is {12 * cfg.param_count() / 1e9:.2f} GB)")
    arch_cut = dataclasses.replace(arch, make_config=lambda: cfg)
    args = train_args("--arch", arch.name, "--full", "--batch", b, "--lr",
                      TRAIN_LR, "--steps", DLRM_TRAIN_STEPS, "--device",
                      "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step_fn, batch_fn = train.SETUPS["recsys"](arch_cut, args, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = [batch_fn(i) for i in range(DLRM_TRAIN_STEPS + 1)]
    data_s = time.perf_counter() - t0
    state, _ = step_fn(state, batches[-1])   # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    state, hist = run_resilient(state=state, step_fn=synced(step_fn),
                                batch_fn=lambda i: batches[i],
                                n_steps=DLRM_TRAIN_STEPS, log_every=0)
    k6 = ops.LAUNCHES["embedding_bag"]
    others = {k: v for k, v in ops.LAUNCHES.items() if k != "embedding_bag"}
    peak = torch.cuda.max_memory_allocated()
    launches["embedding_bag"] += k6
    dts = [h["dt"] for h in hist]
    losses = [h["loss"] for h in hist]
    p50 = percentile(dts, 50)
    print(f"# dlrm train: {DLRM_TRAIN_STEPS} AdamW steps (lr {TRAIN_LR}, "
          f"clip 1.0) at B {b} after one warm-up step; set-up {init_s:.2f} s "
          f"(weights drawn on the card), Criteo batches {data_s:.2f} s (host"
          f"); K6 launches {k6} ({k6 / DLRM_TRAIN_STEPS:.0f} a step), other "
          f"kernels {json.dumps(others)}; loss {losses[0]!r} -> "
          f"{losses[-1]!r}")
    if k6 != cfg.n_sparse * DLRM_TRAIN_STEPS or any(others.values()):
        raise AssertionError(f"K6 launched {k6} times in {DLRM_TRAIN_STEPS} "
                             f"steps; expected {cfg.n_sparse} a step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"dlrm training losses {losses}")
    print(f"# dlrm train times: step p50 {p50 * 1e3:.2f} ms, p99 "
          f"{percentile(dts, 99) * 1e3:.2f} ms, {b / p50:.0f} samples/s; peak"
          f" device memory {peak / 1e9:.2f} GB | {card}")
    kinds, top = step_kinds(
        step_fn.grad_fn, step_fn.optimizer, state, batches[0], "K6",
        "embedding_bag_kernel",
        {"index_add_ backward": ("indexfunc", "index_add")})
    # K6 by CUDA events: after the earlier phases the profiler records few
    # or none of K6's launches here, though a fresh process sees all 26
    # (PERF.md, PR 24), so its K6 figure stays out of the busy share.
    seen = kinds.pop("K6")
    sparse, tables = batches[0]["sparse"], state[0]["tables"]
    k6_ms = time_ms(torch, lambda: [eb.embedding_bag(t, sparse[:, i, :])
                                    for i, t in enumerate(tables)], reps=5)
    busy = sum(kinds.values()) + k6_ms
    print(f"# where the time goes, dlrm train step (B {b}; torch.profiler "
          f"device time, gradient and update profiled apart; K6 by CUDA "
          f"events, its 26 bags timed alone, median of 5): K6 {k6_ms:.3f} "
          f"ms (the profiler recorded {seen:.3f} ms of it), "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.items())
          + f"; device busy {busy:.2f} ms of a {p50 * 1e3:.2f} ms step "
          f"({100 * busy / (p50 * 1e3):.1f}%, the rest idle) | {card}")
    print("# dlrm train top kernels: " + "; ".join(
        f"{name[:90]} {ms:.2f} ms" for name, ms in top))
    del state, step_fn, batch_fn, batches
    torch.cuda.empty_cache()

    small = arch.make_config(vocab_sizes=tuple(
        min(v, DLRM_TRAIN_CHECK_CAP) for v in dlrm.CRITEO_1TB_VOCABS))
    before = ops.LAUNCHES["embedding_bag"]
    # The trainer's seed holds every key, the free trajectories included.
    err = card_vs_cpu_steps("recsys", dataclasses.replace(
        arch, make_config=lambda: small), train_args(
        "--arch", arch.name, "--full", "--batch", DLRM_TRAIN_CHECK_BATCH,
        "--lr", TRAIN_LR, "--seed", 0, "--device", "cpu"), dev,
        DLRM_TRAIN_STEPS)
    print(f"# dlrm train f32 check (seed 0, tables capped at "
          f"{DLRM_TRAIN_CHECK_CAP} rows, B {DLRM_TRAIN_CHECK_BATCH}, "
          f"{DLRM_TRAIN_STEPS} steps, TF32 off; K6 on the card, the plain "
          f"bag on the CPU), card vs CPU: " + check_line(err))
    hold(err, True, "dlrm f32")
    ops.LAUNCHES["embedding_bag"] = before  # comparisons, not the path
    torch.cuda.empty_cache()
    print(f"# phase 30 took {time.perf_counter() - t_phase:.1f} s (host "
          "clock)")


#: Phase 31, the distributed substrate over NCCL, one rank a card.
#: DLRM-MLPerf: the published tables where a card's shards fit (26.32 GB a
#: card on 4 cards), else each table capped at DLRM_ROW_CAP (phase 13's
#: cut); a few serve_p99 and serve_bulk forwards; the 4-ranks-against-1
#: check at phase 13's 65,536-row tables, B 512.
DIST_P99_FORWARDS, DIST_BULK_FORWARDS = 4, 2
#: What a card keeps free beside its table shards for the uncapped tables:
#: the bags and the all-reduce's buffer at serve_bulk (about 0.9 GB), the
#: MLPs, cuBLAS's workspace and the rank's CUDA context.
DIST_TABLE_HEADROOM = 8e9
#: SmolLM-135M at phase 10's prefill (8 x 1920, max_seq 2048), then 8
#: decode steps; the f32 check at B 2, S 256 with 8 more steps.
DIST_DECODE_STEPS, DIST_F32_BATCH, DIST_F32_PROMPT = 8, 2, 256
DIST_F32_TOLERANCE = 1e-4
#: One qwen3-moe-30b-a3b layer: each rank's tokens (B 2 x 2,048).
DIST_MOE_TOKENS = 4096
#: qwen3-moe-30b-a3b's prefill on the policy path at full width, B 1.
#: reduced: depth (48 -> 2), sequence (prefill_32k, 32,768 -> 4,096),
#: capacity factor (1.25 -> n_experts / top_k = 16: an expert has a slot
#: for every token, so neither path drops one, and ranks that each route a
#: quarter of the tokens compare with one card that routes them all).
DIST_QWEN_LAYERS, DIST_QWEN_PROMPT = 2, 4096
#: The ring and all-gather SpMM on phase 22's ogb_products edges.
DIST_SPMM_WIDTH, DIST_SPMM_REPS, DIST_SPMM_TOLERANCE = 100, 3, 1e-5


def _rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def _host_ms(fn, reps: int, sync) -> float:
    """Median host-clock time of ``reps`` calls, each between two
    synchronisations of the card (and of the ranks)."""
    samples = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        samples.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(samples)


def distributed_rank(rank: int, world: int, job: dict) -> dict:
    """Phase 31 on one NCCL rank (its card is ``cuda:rank``): DLRM-MLPerf
    vocab-parallel, SmolLM-135M through the policy path, one qwen3-moe
    layer expert-parallel, qwen3-moe's prefill with TP heads and EP
    experts, and the ring and all-gather SpMM, each against its
    single-device path.  Returns the lines to print (each rank's K6
    shard check, the rest from rank 0), the counted launches and the
    ledger's bytes."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import backend, params
    from repro_torch.configs import (GNN_SHAPES, RECSYS_SHAPES, dlrm_mlperf,
                                     qwen3_moe_30b_a3b, smollm_135m)
    from repro_torch.core import comm_model
    from repro_torch.data import synthetic
    from repro_torch.distributed import comm, ring
    from repro_torch.distributed.sharding import make_policy
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import dlrm
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tr
    from repro_torch.models.gnn.layers import gather_scatter_sum

    backend.full_fp32()
    dev = rank_device(rank)
    policy = make_policy(make_test_mesh((1, world), ("data", "model")))
    everyone = policy.group(policy.all_axes)
    tp_group = policy.group("model")
    lines: list[str] = []
    result = {"lines": lines, "launches": {}, "ledger": {}}

    def say(msg: str, every: bool = False) -> None:
        if rank == 0 or every:
            lines.append(f"rank {rank}: {msg}" if every else msg)

    def card_sync() -> None:
        torch.cuda.synchronize(dev)

    def sync() -> None:
        card_sync()
        dist.barrier(group=everyone)

    t_rank = time.perf_counter()
    # (a) DLRM-MLPerf, vocab-parallel.
    cap = job["dlrm_cap"]
    cfg = dlrm_mlperf.make_config(vocab_sizes=tuple(
        min(v, cap) if cap else v for v in dlrm.CRITEO_1TB_VOCABS))
    t0 = time.perf_counter()
    model = params.shard_dlrm(None, cfg, policy, device=dev, seed=0)
    card_sync()
    draw_s = time.perf_counter() - t0
    shard_gb = sum(t.numel() for t in model.tables) * 4 / 1e9
    say(f"dlrm set-up: {cfg.name}, {sum(cfg.vocab_sizes)} table rows "
        f"({'published' if not cap else f'40M-row tables cut to {cap}'}), "
        f"shards {sorted(set(model.shards))}, {shard_gb:.2f} GB of tables "
        f"on this card drawn in {draw_s:.3f} s", every=True)
    p99_b, bulk_b = (RECSYS_SHAPES[k].params["batch"]
                     for k in ("serve_p99", "serve_bulk"))

    def criteo(step: int, b: int, vocab) -> dict:
        return synthetic.criteo_batch(0, step, batch=b, n_dense=cfg.n_dense,
                                      vocab_sizes=vocab, multi_hot=1)

    np_batches = ([criteo(i, p99_b, cfg.vocab_sizes)
                   for i in range(DIST_P99_FORWARDS)]
                  + [criteo(100 + i, bulk_b, cfg.vocab_sizes)
                     for i in range(DIST_BULK_FORWARDS)])
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in np_batches]
    # K6 on this rank's shards, against its plain version (not counted).
    exact, k6_err = True, 0.0
    for t, table in enumerate(model.tables):
        ids = dlrm.shard_ids(model, t, batches[-1]["sparse"][:, t, :])
        got = eb.embedding_bag(table, ids)
        want = eb.embedding_bag_plain(table, ids)
        exact &= bool(torch.equal(got, want))
        k6_err = max(k6_err, float((got - want).abs().max()))
    card_sync()
    say(f"dlrm K6 on this rank's 26 table shards (B {bulk_b}, ids outside "
        f"a shard on its zero row) vs plain: bit-identical {exact}, max abs "
        f"err {k6_err:.3e}", every=True)
    if not exact:
        raise AssertionError(f"rank {rank}: K6 differs on its shards")
    for b in (batches[0], batches[-1]):  # warm-up: cuBLAS plans
        dlrm.forward(cfg, model, b, policy=policy)
    sync()
    ops.reset_launches()
    outs, wire = [], []
    for b in batches:
        with comm.recording() as ledger:
            outs.append(dlrm.forward(cfg, model, b, policy=policy))
        wire.append(ledger.total_wire_bytes_per_chip)
    sync()
    k6 = ops.LAUNCHES["embedding_bag"]
    result["launches"]["embedding_bag"] = k6
    forwards = len(batches)
    if k6 != cfg.n_sparse * forwards:
        raise AssertionError(f"K6 launched {k6} times in {forwards} "
                             "sharded forwards")
    bulk_ms = _host_ms(lambda: dlrm.forward(cfg, model, batches[-1],
                                            policy=policy), 3, sync)
    n_sharded = sum(t.shape[0] == r + 1
                    for t, r in zip(model.tables, model.rows))
    result["ledger"]["dlrm_serve_bulk"] = wire[-1]
    say(f"dlrm sharded path: K6 {k6} launches over {forwards} forwards "
        f"({cfg.n_sparse} a forward); serve_bulk forward {bulk_ms:.3f} ms "
        f"(host clock, median of 3) = {bulk_b / bulk_ms * 1e3:.1f} samples/s;"
        f" ledger: one all-reduce of the {n_sharded} sharded tables' "
        f"partial bags a forward ({ledger.ops[0].result_bytes:.0f} B at B "
        f"{bulk_b}), {wire[0]:.0f} B a rank on the wire at serve_p99, "
        f"{wire[-1]:.0f} B at serve_bulk")
    if world == 1:
        view = model.single_device_view()
        same = all(np.array_equal(out.cpu().numpy(), dlrm.serve(view, b))
                   for out, b in zip(outs, np_batches))
        say(f"dlrm world 1: sharded logits vs the single-device serve on "
            f"the same tables (views shard[:rows]): bit-identical {same}")
        if not same:
            raise AssertionError("the sharded DLRM differs from serve")
        del view
    del model, batches, outs
    torch.cuda.empty_cache()
    # 4 ranks against 1: every table at 65,536 rows, from one numpy tree.
    small = dlrm_mlperf.make_config(vocab_sizes=tuple(
        min(v, DLRM_CHECK_ROW_CAP) for v in dlrm.CRITEO_1TB_VOCABS))
    tree = params.dlrm_params(small, seed=0)
    sm = params.shard_dlrm(tree, small, policy, device=dev)
    b = {k: torch.from_numpy(v).to(dev) for k, v in criteo(
        7, DLRM_CHECK_BATCH, small.vocab_sizes).items()}
    got = comm.all_gather(dlrm.forward(small, sm, b, policy=policy),
                          everyone, 0)
    if rank == 0:
        ref = params.load_dlrm(tree, small, device=dev)(b)
        err = _rel(got, ref)
        say(f"dlrm {world} ranks vs 1 at {DLRM_CHECK_ROW_CAP}-row tables, "
            f"B {DLRM_CHECK_BATCH}: max rel err {err:.3e} (tolerance "
            f"{DLRM_TOLERANCE:.0e})")
        if not err < DLRM_TOLERANCE:
            raise AssertionError(f"sharded DLRM vs one card: {err}")
        del ref
    del tree, sm, b, got
    torch.cuda.empty_cache()

    # (b) SmolLM-135M through the policy path.
    cfg = smollm_135m.make_config()
    full = params.draw_transformer(cfg, seed=0, device=dev)
    sharded = params.shard_transformer(full, cfg, policy, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    dec = tr.DecodePolicy(cache_seq_axes=("model",), batch_axes=("data",))
    pre_s = tr.make_prefill_step(cfg, max_seq=SERVE_MAX_SEQ, policy=policy,
                                 decode=dec)
    pre_1 = tr.make_prefill_step(cfg, max_seq=SERVE_MAX_SEQ)
    pre_s(sharded, prompts)  # warm-up
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    with comm.recording() as ledger:
        lg_s, cache_s = pre_s(sharded, prompts)
    sync()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    k5 = ops.LAUNCHES["flash_attention"]
    result["launches"]["flash_attention"] = k5
    tp_heads = cfg.n_heads % world == 0 and cfg.n_kv_heads % world == 0
    expect = cfg.n_layers if tp_heads else 0
    if k5 != expect:
        raise AssertionError(f"K5 launched {k5} times in the sharded "
                             f"prefill, expected {expect}")
    pre_1(full, prompts)  # warm-up
    card_sync()
    t0 = time.perf_counter()
    lg_1, cache_1 = pre_1(full, prompts)
    card_sync()
    single_ms = 1e3 * (time.perf_counter() - t0)
    err = _rel(lg_s, lg_1)
    identical = bool(torch.equal(lg_s, lg_1))
    mode = ("TP heads, K5 on each rank" if tp_heads
            else "context parallel, the chunked path")
    say(f"smollm sharded prefill ({mode}): B {SERVE_BATCH} x "
        f"{SERVE_PROMPT}, {k5} K5 launches, {prefill_ms:.1f} ms against "
        f"{single_ms:.1f} ms single-device on this card (host clock, one "
        f"call each after a warm-up), ledger {ledger.counts()} "
        f"{ledger.total_wire_bytes_per_chip:.0f} B a rank; logits vs "
        f"make_prefill_step: bit-identical {identical}, max rel err "
        f"{err:.3e}")
    if (world == 1 and not identical) or not err < MOE_LOOP_TOLERANCE:
        raise AssertionError(f"sharded prefill logits differ: {err}")
    nccl = {"NCCL": ("nccl",)}
    kinds = [device_time_by_kind(lambda: fn(m_, prompts), "K5",
                                 "flash_wgmma_kernel", extra=nccl)
             for fn, m_ in ((pre_s, sharded), (pre_1, full))]
    say("smollm prefill device ms by kind (torch.profiler), sharded vs "
        "single-device: " + "; ".join(
            f"{k} {kinds[0][k]:.3f} vs {kinds[1][k]:.3f}" for k in kinds[0]))
    step_s = tr.make_serve_step(cfg, SERVE_MAX_SEQ, policy=policy,
                                decode=dec)
    step_1 = tr.make_serve_step(cfg, SERVE_MAX_SEQ)
    tok, worst = lg_1.argmax(-1, keepdim=True), 0.0
    for i in range(DIST_DECODE_STEPS):
        a, _ = step_1(full, cache_1, tok, SERVE_PROMPT + i)
        b_, _ = step_s(sharded, cache_s, tok, SERVE_PROMPT + i)
        worst = max(worst, _rel(b_, a))
        tok = a.argmax(-1, keepdim=True)
    say(f"smollm {DIST_DECODE_STEPS} sharded decode steps (bf16) vs "
        f"single-device: max rel err {worst:.3e} (tolerance "
        f"{MOE_LOOP_TOLERANCE:.0e})")
    if not worst < MOE_LOOP_TOLERANCE:
        raise AssertionError(f"sharded decode differs: {worst}")
    del full, sharded, cache_s, cache_1
    torch.cuda.empty_cache()
    full = params.draw_transformer(cfg, seed=1, device=dev,
                                   dtype=torch.float32)
    sharded = params.shard_transformer(full, cfg, policy, device=dev)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab, (DIST_F32_BATCH, DIST_F32_PROMPT)), device=dev)
    max_seq = DIST_F32_PROMPT + DIST_DECODE_STEPS
    a, cache_1 = tr.make_prefill_step(cfg, max_seq=max_seq)(full, prompts)
    b_, cache_s = tr.make_prefill_step(cfg, max_seq=max_seq, policy=policy,
                                       decode=dec)(sharded, prompts)
    worst = _rel(b_, a)
    step_s = tr.make_serve_step(cfg, max_seq, policy=policy, decode=dec)
    step_1 = tr.make_serve_step(cfg, max_seq)
    tok = a.argmax(-1, keepdim=True)
    for i in range(DIST_DECODE_STEPS):
        a, _ = step_1(full, cache_1, tok, DIST_F32_PROMPT + i)
        b_, _ = step_s(sharded, cache_s, tok, DIST_F32_PROMPT + i)
        worst = max(worst, _rel(b_, a))
        tok = a.argmax(-1, keepdim=True)
    say(f"smollm f32 at B {DIST_F32_BATCH}, S {DIST_F32_PROMPT}: sharded "
        f"prefill and {DIST_DECODE_STEPS} decode steps vs single-device, max "
        f"rel err {worst:.3e} (tolerance {DIST_F32_TOLERANCE:.0e})")
    if not worst < DIST_F32_TOLERANCE:
        raise AssertionError(f"f32 sharded serving differs: {worst}")
    del full, sharded, cache_s, cache_1
    torch.cuda.empty_cache()

    # (c) One qwen3-moe-30b-a3b layer, expert-parallel.
    qcfg = qwen3_moe_30b_a3b.make_config()
    m, d = qcfg.moe, qcfg.d_model
    gen = torch.Generator(dev).manual_seed(0)
    bf16 = torch.bfloat16

    def draw(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev)
                * fan_in ** -0.5).to(bf16)

    layer = {"router": draw((d, m.n_experts), d),
             "w_gate": draw((m.n_experts, d, m.d_ff_expert), d),
             "w_up": draw((m.n_experts, d, m.d_ff_expert), d),
             "w_down": draw((m.n_experts, m.d_ff_expert, d), m.d_ff_expert)}
    e_loc = m.n_experts // world
    local = {k: (v if k == "router" else v[rank * e_loc:(rank + 1) * e_loc])
             for k, v in layer.items()}
    x = torch.randn((DIST_MOE_TOKENS, d), generator=torch.Generator(
        dev).manual_seed(1 + rank), device=dev).to(bf16)
    with comm.recording() as ledger:
        y_ep, aux_ep = moe_lib.moe_ffn_ep(local, x, m, group=tp_group)
    y_1, aux_1 = moe_lib.moe_ffn_capacity(layer, x, m)
    card_sync()
    identical = bool(torch.equal(y_ep, y_1))
    err = _rel(y_ep, y_1)
    a2a = ledger.by_kind().get("all-to-all", 0.0)
    modelled = comm_model.moe_dispatch_sync(
        DIST_MOE_TOKENS, d, m.top_k, world, 1).total("ici")
    result["ledger"]["moe_all_to_all"] = a2a
    say(f"qwen3-moe layer (E {m.n_experts}, top {m.top_k}, d {d}, f "
        f"{m.d_ff_expert}, bf16) moe_ffn_ep over {world} ranks, T "
        f"{DIST_MOE_TOKENS} a rank, vs moe_ffn_capacity on the rank's "
        f"tokens: bit-identical {identical}, max rel err {err:.3e}; aux "
        f"{float(aux_ep):.6f} vs {float(aux_1):.6f}; ledger all-to-all "
        f"{a2a:.0f} B a rank vs moe_dispatch_sync {modelled:.0f} B")
    if (world == 1 and not identical) or not err < MOE_LOOP_TOLERANCE:
        raise AssertionError(f"moe_ffn_ep differs: {err}")
    del layer, local, x, y_ep, y_1
    torch.cuda.empty_cache()

    # (c') qwen3-moe-30b-a3b's prefill through the policy path: 32 / 4
    # heads divide 4, so K5 runs on each rank's heads, with EP experts.
    # In bf16 a rank's reduction order can flip a token's top-8 experts
    # against one card's, so the logits are held at world size 1 (bit for
    # bit) and, at any world size, in f32 (1e-4).
    qcfg = dataclasses.replace(
        qcfg, n_layers=DIST_QWEN_LAYERS, moe=dataclasses.replace(
            qcfg.moe, capacity_factor=qcfg.moe.n_experts / qcfg.moe.top_k))
    q_heads = (qcfg.n_heads % world == 0 and qcfg.n_kv_heads % world == 0)
    h_loc, hk_loc = ((qcfg.n_heads // world, qcfg.n_kv_heads // world)
                     if q_heads else (qcfg.n_heads, qcfg.n_kv_heads))
    prompts = torch.as_tensor(np.random.default_rng(4).integers(
        0, qcfg.vocab, (1, DIST_QWEN_PROMPT)), device=dev)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        key = "bf16" if dtype == torch.bfloat16 else "f32"
        # K5 on a rank's operands (its heads, the whole sequence) against
        # its plain version; not counted.
        q, k, v = (torch.randn((1, DIST_QWEN_PROMPT, n, qcfg.d_head),
                               generator=gen, device=dev).to(dtype)
                   for n in (h_loc, hk_loc, hk_loc))
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        errs[f"K5 {key}"] = rel_err(got, want)
        outside = beyond_bf16_step(got, want) if key == "bf16" else 0
        if not errs[f"K5 {key}"] < ATTN_TOLERANCE[key] or outside:
            raise AssertionError(f"K5 {key} on a rank's {h_loc} / {hk_loc} "
                                 f"heads: {errs[f'K5 {key}']}, {outside} "
                                 "elements beyond one bf16 step")
        del q, k, v, got, want
        full = params.draw_transformer(qcfg, seed=4, device=dev, dtype=dtype)
        sharded = params.shard_transformer(full, qcfg, policy, device=dev)
        pre_s = tr.make_prefill_step(qcfg, max_seq=DIST_QWEN_PROMPT,
                                     policy=policy, decode=dec)
        pre_1 = tr.make_prefill_step(qcfg, max_seq=DIST_QWEN_PROMPT)
        if key == "bf16":
            pre_s(sharded, prompts)  # warm-up
            sync()
            ops.reset_launches()
            t0 = time.perf_counter()
            with comm.recording() as ledger:
                lg_s, _ = pre_s(sharded, prompts)
            sync()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            k5_q = ops.LAUNCHES["flash_attention"]
            result["launches"]["flash_attention"] += k5_q
            if k5_q != (qcfg.n_layers if q_heads else 0):
                raise AssertionError(f"K5 launched {k5_q} times in the "
                                     "sharded qwen3-moe prefill")
            result["ledger"]["qwen3_moe_prefill"] = \
                ledger.total_wire_bytes_per_chip
        else:
            lg_s, _ = pre_s(sharded, prompts)
        lg_1, _ = pre_1(full, prompts)
        card_sync()
        errs[key] = _rel(lg_s, lg_1)
        if key == "bf16":
            identical = bool(torch.equal(lg_s, lg_1))
            finite = bool(torch.isfinite(lg_s).all())
            if not finite or (world == 1 and not identical):
                raise AssertionError(f"sharded qwen3-moe bf16 prefill: "
                                     f"finite {finite}, bit-identical "
                                     f"{identical}")
        del full, sharded, lg_s, lg_1
        torch.cuda.empty_cache()
    say(f"qwen3-moe prefill ({'TP heads' if q_heads else 'context parallel'}"
        f", {h_loc} / {hk_loc} heads and {qcfg.moe.n_experts // world} "
        f"experts a rank, {qcfg.n_layers} layers, capacity factor "
        f"{qcfg.moe.capacity_factor:g} so that no token drops), B 1 x "
        f"{DIST_QWEN_PROMPT}: K5 on a rank's operands vs plain, max rel err "
        f"bf16 {errs['K5 bf16']:.3e}, f32 {errs['K5 f32']:.3e}; bf16: "
        f"{k5_q} K5 launches, {prefill_ms:.1f} ms (host clock, one call "
        f"after a warm-up), ledger {ledger.counts()} "
        f"{ledger.total_wire_bytes_per_chip:.0f} B a rank, logits vs "
        f"make_prefill_step bit-identical {identical}, max rel err "
        f"{errs['bf16']:.3e} (held bit for bit at world size 1 only); f32 "
        f"logits max rel err {errs['f32']:.3e} (tolerance "
        f"{DIST_F32_TOLERANCE:.0e})")
    if not errs["f32"] < DIST_F32_TOLERANCE:
        raise AssertionError(f"sharded qwen3-moe f32 prefill differs: "
                             f"{errs['f32']}")

    # (d) The ring and all-gather SpMM on ogb_products' edges.
    n_nodes, F = job["n_nodes"], DIST_SPMM_WIDTH
    arrays = {k: np.load(v, mmap_mode="r") for k, v in job["spmm"].items()}
    h = torch.randn((n_nodes, F), generator=torch.Generator(
        dev).manual_seed(2), device=dev)
    n_local = n_nodes // world
    rows = slice(rank * n_local, (rank + 1) * n_local)
    part = {k: torch.from_numpy(np.array(arrays[k][rank])).to(
        dev) for k in ("ring_snd", "ring_rcv", "ring_wgt", "gather_snd",
                       "gather_rcv", "gather_wgt")}
    hl = h[rows].contiguous()
    with torch.inference_mode():
        with comm.recording() as led_r:
            out_r = ring.ring_spmm(hl, part["ring_snd"], part["ring_rcv"],
                                   part["ring_wgt"], group=everyone)
        with comm.recording() as led_g:
            out_g = ring.allgather_spmm(hl, part["gather_snd"],
                                        part["gather_rcv"],
                                        part["gather_wgt"], group=everyone)
        sync()
        ref = gather_scatter_sum(
            h, torch.from_numpy(np.array(arrays["snd"])).to(dev).long(),
            torch.from_numpy(np.array(arrays["rcv"])).to(dev).long(),
            n_nodes,
            edge_weight=torch.from_numpy(np.array(arrays["wgt"])).to(dev)
        )[rows]
        err_r, err_g = _rel(out_r, ref), _rel(out_g, ref)
        del ref
        torch.cuda.empty_cache()
        ring_ms = _host_ms(lambda: ring.ring_spmm(
            hl, part["ring_snd"], part["ring_rcv"], part["ring_wgt"],
            group=everyone), DIST_SPMM_REPS, sync)
        ag_ms = _host_ms(lambda: ring.allgather_spmm(
            hl, part["gather_snd"], part["gather_rcv"], part["gather_wgt"],
            group=everyone), DIST_SPMM_REPS, sync)

        def compute_only():
            acc = torch.zeros(hl.shape, dtype=torch.float64, device=dev)
            for blk in range(world):
                ring._accumulate(acc, hl, part["ring_snd"][blk],
                                 part["ring_rcv"][blk], part["ring_wgt"][blk])

        def hops_only():
            block = hl
            for _ in range(world - 1):
                block = comm.start_hop(block, everyone).wait()

        compute_ms = _host_ms(compute_only, DIST_SPMM_REPS, sync)
        hops_ms = _host_ms(hops_only, DIST_SPMM_REPS, sync)
    want_r = comm_model.ring_spmm_traffic(n_nodes, F, world).total("ici")
    want_g = comm_model.spmm_feature_allgather(n_nodes, F, world).total(
        "ici")
    got_r, got_g = led_r.total_wire_bytes_per_chip, \
        led_g.total_wire_bytes_per_chip
    result["ledger"].update(ring=got_r, allgather=got_g)
    hidden = ((compute_ms + hops_ms - ring_ms) / hops_ms if world > 1
              else float("nan"))
    say(f"spmm ogb_products (N {n_nodes}, E {arrays['snd'].shape[0]}, F "
        f"{F}, f32) over {world} ranks: ring vs gather_scatter_sum max rel "
        f"err {err_r:.3e}, all-gather {err_g:.3e} (tolerance "
        f"{DIST_SPMM_TOLERANCE:.0e}); ledger wire bytes a rank: ring "
        f"{got_r:.0f} (ring_spmm_traffic {want_r:.0f}), all-gather "
        f"{got_g:.0f} (spmm_feature_allgather {want_g:.0f}); a layer: ring "
        f"{ring_ms:.3f} ms, all-gather {ag_ms:.3f} ms, the ring's compute "
        f"alone {compute_ms:.3f} ms, its {world - 1} hops alone "
        f"{hops_ms:.3f} ms, share of the hops hidden {hidden:.3f} (host "
        f"clock, median of {DIST_SPMM_REPS}); ring pad ratio "
        f"{job['pad_ratio']['ring']:.3f}, all-gather "
        f"{job['pad_ratio']['gather']:.3f}", every=world > 1)
    if not (err_r < DIST_SPMM_TOLERANCE and err_g < DIST_SPMM_TOLERANCE):
        raise AssertionError(f"spmm differs: ring {err_r}, all-gather "
                             f"{err_g}")
    if got_r != want_r or got_g != want_g:
        raise AssertionError(f"ledger {got_r}, {got_g} vs models {want_r}, "
                             f"{want_g}")
    del h, hl, part, out_r, out_g
    torch.cuda.empty_cache()

    # (e) The rest of the slice, small: a ring hop, GPipe and its gradient
    # with the DP gradient sync, context-parallel attention's query offset,
    # and the spec trees.
    from repro_torch.distributed.pipeline_par import gpipe_apply
    from repro_torch.distributed.sharding import fsdp_specs
    from repro_torch.models import attention as attn_lib
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randn((4, 8, 64), generator=g, device=dev)
    hop = comm.ring_hop(x + rank, everyone)
    hop_ok = bool(torch.equal(hop, x + (rank - 1) % world))
    ws = torch.randn((world, 64, 64), generator=g, device=dev) / 8
    w = ws[rank].clone().requires_grad_(True)
    xs = x.clone().requires_grad_(True)
    out = gpipe_apply(lambda p, a: torch.tanh(a @ p), w, xs, group=everyone)
    (out ** 2).sum().backward()
    comm.all_reduce_grads([xs.grad], everyone)
    w1, x1 = ws.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ref = x1
    for st in range(world):
        ref = torch.tanh(ref @ w1[st])
    (ref ** 2).sum().backward()
    gp_err = max(_rel(out, ref), _rel(w.grad, w1.grad[rank]),
                 _rel(xs.grad, x1.grad))
    q, k, v = (torch.randn((2, 256, 4, 64), generator=g, device=dev)
               for _ in range(3))
    full_attn = attn_lib.chunked_causal_attention(q, k, v, window=100,
                                                  q_chunk=64)
    part_attn = attn_lib.chunked_causal_attention(
        q[:, 128:], k, v, window=100, q_chunk=64, q_offset=128)
    cp_err = _rel(part_attn, full_attn[:, 128:])
    cfg = smollm_135m.make_config()
    specs = tr.param_pspecs(cfg, policy)
    meta = {"embed": torch.empty((cfg.vocab, cfg.d_model), device="meta")}
    fs = fsdp_specs(meta, {"embed": specs["embed"]}, policy)
    card_sync()
    say(f"ring hop (rank - 1's tensor): {hop_ok}; gpipe over {world} stages"
        f" (4 microbatches) and its gradient with the DP sync vs one "
        f"device: max rel err {gp_err:.3e}; chunked attention at q_offset "
        f"128 vs the full pass's rows: {cp_err:.3e}; smollm specs: embed "
        f"{specs['embed']}, wq {specs['blocks'][0]['wq']}, fsdp embed "
        f"{fs['embed']}, cache {tr.cache_pspecs(cfg, policy, dec)['k0']}")
    if not (hop_ok and gp_err < 1e-5 and cp_err < 1e-6):
        raise AssertionError(f"ring hop {hop_ok}, gpipe {gp_err}, q_offset "
                             f"{cp_err}")
    say(f"rank took {time.perf_counter() - t_rank:.1f} s", every=True)
    return result


def rank_device(rank: int) -> torch.device:
    """The card of phase 31's rank ``rank``."""
    return torch.device("cuda", rank)


def distributed_phase(dev, card: str, launches: dict,
                      ogb_edges: tuple) -> dict:
    """Phase 31: one NCCL rank a visible card (``repro_torch.launch.mesh.
    spawn``), each running :func:`distributed_rank`.  The kernels were
    built by phase 2 (the ranks load them); phase 30's memory is freed
    first.  The DLRM tables go uncapped where a card's shards fit in its
    free memory less :data:`DIST_TABLE_HEADROOM`.  The ogb_products
    partitions are built here once and handed to the ranks as ``.npy``
    files.  Adds rank 0's counted launches to ``launches`` and returns the
    ranks' results."""
    import tempfile

    from repro_torch.configs import GNN_SHAPES
    from repro_torch.distributed import ring
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import dlrm

    t_phase = time.perf_counter()
    card = card.replace("\n", "; ")  # one line for every card's report
    world = torch.cuda.device_count()
    torch.cuda.empty_cache()
    free = min(torch.cuda.mem_get_info(i)[0] for i in range(world))
    # The published tables a card would hold, row-sharded over all ranks.
    shard_bytes = sum(-(-v // world) * 128 * 4
                      for v in dlrm.CRITEO_1TB_VOCABS)
    cap = None if shard_bytes < free - DIST_TABLE_HEADROOM else DLRM_ROW_CAP
    print(f"# dist set-up: world size {world} (NCCL "
          f"{torch.cuda.nccl.version()}, one rank a card, mesh (1, {world}) "
          f"over (data, model)); {free / 1e9:.2f} GB free on the emptiest "
          f"card; DLRM tables "
          f"{'published' if cap is None else f'capped at {cap} rows'} "
          f"({shard_bytes / 1e9:.2f} GB a card uncapped, "
          f"{DIST_TABLE_HEADROOM / 1e9:.0f} GB kept free) | {card}")
    snd, rcv = ogb_edges
    V = GNN_SHAPES["ogb_products"].params["n_nodes"]
    n_nodes = -(-V // world) * world
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dist-") as tmp:
        t0 = time.perf_counter()
        wgt = np.random.default_rng(0).random(snd.shape[0]).astype(
            np.float32)
        rp = ring.partition_edges_ring(snd, rcv, wgt, n_nodes, world)
        gp = ring.partition_edges_gather(snd, rcv, wgt, n_nodes, world)
        arrays = {"snd": snd, "rcv": rcv, "wgt": wgt,
                  "ring_snd": rp.senders, "ring_rcv": rp.receivers,
                  "ring_wgt": rp.weights, "gather_snd": gp.senders,
                  "gather_rcv": gp.receivers, "gather_wgt": gp.weights}
        paths = {}
        for k, a in arrays.items():
            paths[k] = str(Path(tmp) / f"{k}.npy")
            np.save(paths[k], a)
        pad = {"ring": rp.pad_ratio, "gather": gp.pad_ratio}
        print(f"# dist ogb_products partitions: V {V} padded to {n_nodes} "
              f"(divisible by {world}), E {snd.shape[0]}, ring (dst shard, "
              f"src block) blocks of {rp.senders.shape[-1]} edges (pad ratio "
              f"{rp.pad_ratio:.3f}), all-gather dst shards of "
              f"{gp.senders.shape[-1]} (pad ratio {gp.pad_ratio:.3f}); built "
              f"and written in {time.perf_counter() - t0:.1f} s (host clock)")
        del rp, gp, arrays, wgt
        job = {"dlrm_cap": cap, "n_nodes": n_nodes, "spmm": paths,
               "pad_ratio": pad}
        t0 = time.perf_counter()
        results = spawn(distributed_rank, world, backend="nccl",
                        args=(job,))
        ranks_s = time.perf_counter() - t0
    for res in results:
        for line in res["lines"]:
            print(f"# dist {line} | {card}")
    for kname, count in results[0]["launches"].items():
        launches[kname] += count
    print(f"# dist phase launches (rank 0): "
          f"{json.dumps(results[0]['launches'], sort_keys=True)}; ledger "
          f"(rank 0) {json.dumps(results[0]['ledger'], sort_keys=True)}; "
          f"ranks {ranks_s:.1f} s; phase 31 took "
          f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    return {"world": world, "results": results}


#: Phase 32: training under a sharding policy (``launch.steps``), one NCCL
#: rank a visible card; on one card the policy steps run at world size 1
#: against the single-device steps on the same weights.  SmolLM-135M at
#: ``train_4k`` with B 8 as phase 28; gemma2-2b at ``train_4k`` at full
#: width and depth, its weights drawn a block at a time
#: (``shard_transformer_tree(None)``), stored in bf16 by the reference's
#: rule on one card (f32 on four).
#: gemma2-2b's B is bound by the card's memory: its bf16 state is not
#: donated (``launch.steps.lm_train_cell`` donates only f32 state), so a
#: step holds the old and the new parameters and moments at once, and B 2
#: peaks at 69.40 GB of the card's 80 GB (this phase on an H100 80GB HBM3
#: at 700 W); B 4 would add B 2's activations again.
#: reduced: batch (train_4k, 256 -> 8 for SmolLM-135M; 256 -> 2 for
#: gemma2-2b, the largest power of two whose step fits the card's memory).
POLICY_LM_BATCH, POLICY_GEMMA2_BATCH, POLICY_LM_STEPS = 8, 2, 2
#: The world-1 policy step against the single-device step on one card:
#: the first loss bit for bit; later losses and the parameters within the
#: repo's f32 tolerance (the card sums the embedding's and the attention's
#: gradients in no fixed order), bf16's 3e-2 for gemma2-2b's bf16 state.
POLICY_TOLERANCE, POLICY_BF16_TOLERANCE = 1e-5, 3e-2
#: DLRM-MLPerf at ``train_batch`` (B 65,536) under the vocab-parallel
#: policy, tables capped as phase 30 (DLRM_TRAIN_ROW_CAP) on one card; on
#: more, the largest power-of-two cap whose training state fits each
#: card's measured free memory less DIST_TABLE_HEADROOM.
POLICY_DLRM_STEPS = 3
#: Four cards: gemma2-2b at full width and 2 layers in f32 from one numpy
#: tree, and DLRM at 65,536-row tables, against one card: the repo's model
#: tolerance.
POLICY_CHECK_LAYERS, POLICY_CHECK_BATCH, POLICY_CHECK_SEQ = 2, 2, 1024
POLICY_CHECK_STEPS, POLICY_CHECK_TOLERANCE = 3, 1e-4
#: The gemma2-2b check's weight seeds.
POLICY_CHECK_SEEDS = (1, 2, 3)
POLICY_DLRM_CHECK_BATCH = 4096
#: ``minibatch_lg`` (configs/base.py): a synthetic power-law graph at
#: Reddit's size, built as a CSR from a seed; 1,024 seeds, fanout (15, 10).
#: GCN and GatedGCN are held card vs CPU on the full sample, MeshGraphNet
#: and EquiformerV2 on a 64-seed sample of the same CSR (the full sample
#: only timed for them).
MINIBATCH_GRAPH = {"n_nodes": 232_965, "n_edges": 114_615_892, "seed": 0,
                   "alpha": 1.6}
MINIBATCH_CHECK_SEEDS = 64
#: EquiformerV2 keeps (N, 49, 128) f32 node states and (E, 29, 128) edge
#: messages for the backward of each of its 12 layers, about 2.9 MB a
#: padded node and edge (8.9 GB at (3,072, 3,072) on the CPU): the full
#: sample's (169,984, 168,960) would take about 490 GB.  It takes its
#: timed step on the 64-seed sample and its card-vs-CPU check on a 4-seed
#: one (its CPU step at 16 seeds took 26 s).
#: reduced: EquiformerV2's minibatch_lg seeds (1,024 -> 64 timed, 4 held).
EQV2_TIMED_SEEDS, EQV2_CHECK_SEEDS = 64, 4


def power_law_csr(n_nodes: int, n_edges: int, seed: int, alpha: float):
    """A power-law graph generated straight into CSR form: destination
    degrees multinomial over rank weights ``r^-alpha`` (a seeded
    permutation of the vertices), each edge's sender drawn from the same
    weights; neighbors unordered within a row (the sampler draws uniformly
    within it).  ``col`` is int32."""
    from repro_torch.data.sampler import CSRGraph

    rng = np.random.default_rng(seed)
    w = np.arange(1, n_nodes + 1, dtype=np.float64) ** (-alpha)
    w /= w.sum()
    perm = rng.permutation(n_nodes)
    deg = np.zeros(n_nodes, np.int64)
    deg[perm] = rng.multinomial(n_edges, w)
    ptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=ptr[1:])
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    col = np.empty(n_edges, np.int32)
    step = 1 << 24
    for lo in range(0, n_edges, step):
        hi = min(lo + step, n_edges)
        rank = np.searchsorted(cdf, rng.random(hi - lo), side="right")
        np.minimum(rank, n_nodes - 1, out=rank)
        col[lo:hi] = perm[rank]
    return CSRGraph(ptr=ptr, col=col, n_nodes=n_nodes)


def _card_rel(got, want, masks=None) -> float:
    """The worst leaf of two trees of tensors: max abs error over its kept
    entries relative to the leaf's largest entry, on ``want``'s device
    (a leaf of ``got`` is moved there one at a time)."""
    from repro_torch.tree import tree_leaves

    g, w = tree_leaves(got), tree_leaves(want)
    m = [None] * len(w) if masks is None else tree_leaves(masks)
    if len(g) != len(w) or len(m) != len(w):
        raise AssertionError(f"{len(g)} leaves against {len(w)}")
    worst = 0.0
    for a, b, k in zip(g, w, m):
        diff = (a.to(b.device).float() - b.float()).abs()
        if k is not None:
            diff = diff[k]
        if diff.numel():
            worst = max(worst, float(diff.max()) / max(
                float(b.float().abs().max()), 1e-30))
    return worst


def _resolved(mu, dropped: list | None = None) -> object:
    """Masks of the entries whose first gradient (``mu`` after one step,
    0.1 times it) passes GRAD_ROUNDING_SHARE of its leaf's largest.  With
    ``dropped`` (a list), a leaf whose largest is under GRAD_ZERO_SHARE of
    the model's largest holds no entry, and its path and its largest as a
    share of the model's are appended to ``dropped``."""
    from repro_torch.tree import tree_map, tree_paths

    leaf_max = [float(t.float().abs().max()) for _, t in tree_paths(mu)]
    top = max(leaf_max)
    if dropped is not None:
        dropped += [(path, m / top) for (path, _), m in zip(tree_paths(mu),
                                                            leaf_max)
                    if 0.0 < m < GRAD_ZERO_SHARE * top]
    zero = {path for path, _ in dropped or ()}
    maxes = iter(zip(tree_paths(mu), leaf_max))

    def mask(t):
        (path, _), m = next(maxes)
        if path in zero:
            return torch.zeros_like(t, dtype=torch.bool)
        return t.float().abs() > GRAD_ROUNDING_SHARE * m
    return tree_map(mask, mu)


def _lm_batches(cfg, b: int, s: int, n: int, dev) -> list:
    from repro_torch.data import synthetic
    return [{k: torch.from_numpy(v).to(dev) for k, v in synthetic.lm_batch(
        0, i, batch=b, seq=s, vocab=cfg.vocab).items()} for i in range(n)]


def _policy_steps(cell, batches, sync) -> tuple:
    """The cell's steps over ``batches``: (params, opt state, losses, host
    ms a step, the ledger's wire bytes a rank by tag and kind)."""
    from repro_torch.distributed import comm

    params, state = cell.params, cell.opt_state
    losses, ms = [], []
    with comm.recording() as ledger:
        for batch in batches:
            sync()
            t0 = time.perf_counter()
            params, state, metrics = cell.step(params, state, batch)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(metrics["loss"]))
    return params, state, losses, ms, ledger.by_tag()


def _hold_to_single(cfg, optimizer, params, batches, sync, got,
                    losses) -> tuple:
    """The single-device step (``transformer.make_train_step`` without a
    policy) from ``params`` over ``batches``, against a policy run's
    ``losses`` and final parameters ``got`` (whole leaves): (the
    single-device losses, host ms a step, max rel err of each loss, max
    rel err of the parameters over the entries whose first gradient is
    resolved)."""
    from repro_torch.models import transformer as tr

    step = tr.make_train_step(cfg, optimizer)
    state = optimizer.init(params)
    want_losses, ms, masks = [], [], None
    for batch in batches:
        sync()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        want_losses.append(float(metrics["loss"]))
        if masks is None:
            masks = _resolved(state.mu)
    loss_errs = [abs(a - c) / abs(c) for a, c in zip(losses, want_losses)]
    return want_losses, ms, loss_errs, _card_rel(got, params, masks)


def policy_lm_cell(name: str, b: int, policy, dev, say, sync,
                   compare: bool) -> None:
    """One LM train cell at full width and depth under ``policy``; at
    world size 1 (``compare``) held to the single-device step on the same
    weights."""
    import dataclasses

    from repro_torch.configs import LM_SHAPES, get_arch
    from repro_torch.launch import steps
    from repro_torch.optim.optimizers import adamw
    from repro_torch.params import shard_transformer_tree
    from repro_torch.tree import is_spec, tree_leaves, tree_map

    arch = get_arch(name)
    shape = LM_SHAPES["train_4k"]
    shape = dataclasses.replace(shape, params={**shape.params, "batch": b})
    s = shape.params["seq"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cell = steps.lm_train_cell(arch, shape, policy, None, seed=0,
                               device=dev)
    sync()
    draw_s = time.perf_counter() - t0
    cfg, dtype = cell.cfg, cell.meta["dtype"]
    batches = _lm_batches(cfg, b, s, POLICY_LM_STEPS, dev)
    params, state, losses, ms, ledger = _policy_steps(cell, batches, sync)
    peak = torch.cuda.max_memory_allocated(dev)
    fsdp = sum(1 for spec in tree_leaves(cell.specs, is_spec)
               if policy.dp_spec in spec)
    say(f"{name} policy train: mesh {tuple(policy.axis_sizes.values())} "
        f"(data, model), {cfg.n_layers} layers d {cfg.d_model}, "
        f"{cfg.param_count()} parameters stored {str(dtype)[6:]} (the "
        f"storage rule: 12 B x parameters / devices "
        f"{12 * cfg.param_count() / policy.n_devices / 1e9:.2f} GB against "
        f"9 GB), {fsdp} FSDP leaves, compute {cfg.dtype}; blocks drawn in "
        f"{draw_s:.2f} s; B {b} x S {s} (train_4k's B "
        f"{LM_SHAPES['train_4k'].params['batch']} cut to {b}); losses "
        f"{losses}; step ms {[round(x, 1) for x in ms]} (host clock); peak "
        f"{peak / 1e9:.2f} GB; ledger a rank over the {len(ms)} steps "
        f"{json.dumps(ledger, sort_keys=True)}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite policy losses {losses}")
    if not compare:
        return
    # The policy's result waits on the host while the single-device step
    # runs from the same weights: the same seeded draw again (at world
    # size 1 a rank's blocks are the whole tree).
    opt = cell.meta["optimizer"]
    params = tree_map(lambda t: t.detach().to("cpu", copy=True), params)
    specs = cell.specs
    del state, cell
    torch.cuda.empty_cache()
    init = shard_transformer_tree(None, cfg, policy, specs=specs,
                                  device=dev, dtype=dtype, seed=0)
    single = adamw(3e-4, weight_decay=0.1,
                   state_dtype=(torch.bfloat16 if dtype == torch.bfloat16
                                else torch.float32),
                   donate=opt.donate)
    want_losses, want_ms, loss_errs, param_err = _hold_to_single(
        cfg, single, init, batches, sync, params, losses)
    tol = POLICY_BF16_TOLERANCE if dtype == torch.bfloat16 else \
        POLICY_TOLERANCE
    loss_err = max(loss_errs[1:])
    say(f"{name} world-1 policy step vs the single-device step (same "
        f"weights and batches): first loss {losses[0]!r} vs "
        f"{want_losses[0]!r} (bit-identical {losses[0] == want_losses[0]}), "
        f"later losses max rel err {loss_err:.3e}, parameters max rel err "
        f"{param_err:.3e} over the entries whose first gradient passes "
        f"{GRAD_ROUNDING_SHARE:.0e} of its leaf's largest (tolerance "
        f"{tol:.0e}); single-device step ms "
        f"{[round(x, 1) for x in want_ms]} (host clock)")
    if losses[0] != want_losses[0]:
        raise AssertionError(f"{name}: world-1 first loss {losses[0]!r} vs "
                             f"{want_losses[0]!r}")
    if not (loss_err < tol and param_err < tol):
        raise AssertionError(f"{name}: world-1 policy step vs one device: "
                             f"losses {loss_err}, parameters {param_err}")


def _whole_leaves(params, specs, policy) -> list:
    """A tree of this rank's blocks laid out by ``specs``, its leaves
    whole (all-gathered over each spec entry's axes)."""
    from repro_torch.distributed import comm
    from repro_torch.tree import is_spec, tree_leaves

    out = []
    with torch.no_grad():
        for t, spec in zip(tree_leaves(params), tree_leaves(specs, is_spec)):
            for d, entry in enumerate(spec):
                if entry is not None:
                    t = comm.all_gather(t.contiguous(), policy.group(entry),
                                        d)
            out.append(t)
    return out


def _leaf_err(got, want, mask=None) -> tuple:
    """(max abs error over ``mask`` relative to ``want``'s largest entry,
    the flat index of the worst entry) of one leaf, on ``want``'s
    device."""
    diff = (got.to(want.device).float() - want.float()).abs()
    if mask is not None:
        diff = torch.where(mask, diff, torch.zeros_like(diff))
    i = int(diff.argmax())
    return float(diff.view(-1)[i]) / max(float(want.float().abs().max()),
                                         1e-30), i


def policy_gemma2_check(policy, dev, say, sync, rank: int,
                        seed: int) -> None:
    """Four cards: gemma2-2b at full width and POLICY_CHECK_LAYERS layers in
    f32, one numpy tree (drawn from ``seed``) cut by every rank,
    POLICY_CHECK_STEPS policy steps against the single-device step on rank
    0's card.  At each step it prints the worst leaf of the parameters over
    the entries the first gradient resolves, its worst entry one card
    against four, and that entry's gradient at the step as a share of its
    leaf's largest.  It holds what DLRM's check holds: every loss and the
    first update (parameters over the entries the first gradient
    resolves, moments), and the last step's parameters over the entries
    every step's gradient resolves (AdamW's normalised update turns an
    entry that a step does not resolve into a step of up to lr either
    way), at POLICY_CHECK_TOLERANCE."""
    import dataclasses

    from repro_torch import params as P
    from repro_torch.configs import LM_SHAPES, get_arch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.optim.optimizers import adamw
    from repro_torch.tree import tree_leaves, tree_paths

    arch = get_arch("gemma2-2b")
    cfg = dataclasses.replace(arch.make_config(), n_layers=POLICY_CHECK_LAYERS,
                              dtype="float32")
    shape = dataclasses.replace(LM_SHAPES["train_4k"], params={
        "batch": POLICY_CHECK_BATCH, "seq": POLICY_CHECK_SEQ})
    tree = P.transformer_params(cfg, seed=seed)
    cell = steps.lm_train_cell(arch, shape, policy, tree, cfg=cfg,
                               device=dev)
    batches = _lm_batches(cfg, POLICY_CHECK_BATCH, POLICY_CHECK_SEQ,
                          POLICY_CHECK_STEPS, dev)
    params, state = cell.params, cell.opt_state
    losses, whole, first_moments = [], [], None
    for t, batch in enumerate(batches):
        sync()
        params, state, metrics = cell.step(params, state, batch)
        losses.append(float(metrics["loss"]))
        leaves = _whole_leaves(params, cell.specs, policy)
        if rank == 0:
            whole.append([x.to("cpu", copy=True) for x in leaves])
        if t == 0:
            moments = [_whole_leaves(m, cell.specs, policy)
                       for m in (state.mu, state.nu)]
            if rank == 0:
                first_moments = [[x.to("cpu", copy=True) for x in m]
                                 for m in moments]
            del moments
        del leaves
    del params, state, cell
    torch.cuda.empty_cache()
    ok = True
    if rank == 0:
        opt = adamw(3e-4, weight_decay=0.1, donate=True)
        step = tr.make_train_step(cfg, opt)
        p1 = P.tensor_tree(tree, device=dev)
        paths = ["/".join(map(str, path)) for path, _ in tree_paths(p1)]
        st = opt.init(p1)
        prev_mu, first_mask, every_mask, want_losses = None, None, None, []
        first_err = moment_err = 0.0
        for t, batch in enumerate(batches):
            p1, st, metrics = step(p1, st, batch)
            want_losses.append(float(metrics["loss"]))
            mus = tree_leaves(st.mu)
            grads = [(m - 0.9 * pm) / 0.1 if pm is not None else m / 0.1
                     for m, pm in zip(mus, prev_mu or [None] * len(mus))]
            masks = [g.abs() > GRAD_ROUNDING_SHARE * g.abs().max()
                     for g in grads]
            first_mask = first_mask or masks
            every_mask = (masks if every_mask is None else
                          [a & b for a, b in zip(every_mask, masks)])
            want = tree_leaves(p1)
            errs = [_leaf_err(g, w, k) for g, w, k in
                    zip(whole[t], want, first_mask)]
            j = max(range(len(errs)), key=lambda i: errs[i][0])
            err, at = errs[j]
            grad_share = float(grads[j].view(-1)[at].abs()) / max(
                float(grads[j].abs().max()), 1e-30)
            say(f"gemma2-2b {POLICY_CHECK_LAYERS} layers f32 seed {seed}, "
                f"step {t + 1}: loss {losses[t]!r} on four vs "
                f"{want_losses[t]!r} on one; parameters over the entries "
                f"the first gradient resolves: worst leaf {paths[j]} "
                f"{err:.3e}, its worst entry (flat {at}) "
                f"{float(want[j].view(-1)[at])!r} on one card vs "
                f"{float(whole[t][j].view(-1)[at])!r} on four, that entry's "
                f"gradient at this step {grad_share:.3e} of its leaf's "
                f"largest (resolved here: {grad_share > GRAD_ROUNDING_SHARE})")
            if t == 0:
                first_err = err
                moment_err = max(
                    _leaf_err(g, w)[0] for m_got, m_want in
                    zip(first_moments, (tree_leaves(st.mu),
                                        tree_leaves(st.nu)))
                    for g, w in zip(m_got, m_want))
            prev_mu = [m.clone() for m in mus]
            del grads, masks
        last_err = max(_leaf_err(g, w, k)[0] for g, w, k in
                       zip(whole[-1], tree_leaves(p1), every_mask))
        loss_err = max(abs(a - c) / abs(c) for a, c in zip(losses,
                                                           want_losses))
        say(f"gemma2-2b {POLICY_CHECK_LAYERS} layers f32 (full width, one "
            f"numpy tree, seed {seed}), {POLICY_CHECK_STEPS} steps at B "
            f"{POLICY_CHECK_BATCH} x S {POLICY_CHECK_SEQ}: policy losses "
            f"{losses} vs one card {want_losses}: max rel err "
            f"{loss_err:.3e}; the first update: parameters {first_err:.3e}, "
            f"moments {moment_err:.3e}; step {POLICY_CHECK_STEPS}'s "
            f"parameters over the entries every step resolves "
            f"{last_err:.3e} (tolerance {POLICY_CHECK_TOLERANCE:.0e})")
        ok = max(loss_err, first_err, moment_err,
                 last_err) < POLICY_CHECK_TOLERANCE
        del p1, st, prev_mu, first_mask, every_mask
        torch.cuda.empty_cache()
    _agree(ok, policy, dev, f"gemma2-2b policy vs one card, seed {seed}")


def _agree(ok: bool, policy, dev, what: str) -> None:
    """Raise on every rank when a check failed on any (rank 0 holds the
    one-card side): a rank that raised alone would leave the others
    waiting in their next collective until NCCL's timeout."""
    from repro_torch.distributed import comm

    failed = torch.tensor(0.0 if ok else 1.0, device=dev)
    if float(comm.all_reduce(failed, policy.group(policy.all_axes),
                             "max")):
        raise AssertionError(f"{what}: failed (rank 0 printed the numbers)")


def _dlrm_policy_cap(policy, dev) -> int:
    """The largest power-of-two row cap (or none: the published tables)
    whose training state (16 B a parameter) fits every card's measured
    free memory less DIST_TABLE_HEADROOM."""
    from repro_torch.distributed import comm
    from repro_torch.models import dlrm

    torch.cuda.empty_cache()
    free = torch.tensor(float(torch.cuda.mem_get_info(dev)[0]), device=dev)
    free = float(-comm.all_reduce(-free, policy.group(policy.all_axes),
                                  "max"))

    def need(cap) -> float:
        rows = 0
        for v in dlrm.CRITEO_1TB_VOCABS:
            v = min(v, cap) if cap else v
            rows += v // dlrm.table_shards(v, policy)
        return 16.0 * rows * 128
    if need(None) < free - DIST_TABLE_HEADROOM:
        return 0
    cap = 1 << 26
    while cap > 1 and need(cap) >= free - DIST_TABLE_HEADROOM:
        cap //= 2
    return cap


def _hold_dlrm_to_single(single, batches, first, losses) -> tuple:
    """Phase 30's single-device step (AdamW at the cell's 1e-3) on the
    :class:`DLRM` ``single`` over ``batches``, against a policy run's
    ``losses`` and its first step's parameters ``first`` (whole tables):
    every loss, and the first step's update, since the trajectories part
    after it (``index_add_``'s float atomics, and AdamW's normalised
    steps).  Returns (the single-device losses, max rel err of the losses,
    of the first step's parameters over the entries whose gradient is
    resolved)."""
    from repro_torch import params as P
    from repro_torch.models import dlrm
    from repro_torch.optim.optimizers import adamw, make_step

    opt = adamw(1e-3, donate=True)
    step_fn = make_step(P.tree_loss(single, dlrm.loss_fn), opt)
    tree = P.module_tree(single)
    st = (tree, opt.init(tree))
    want_losses, param_err = [], None
    for batch in batches:
        st, metrics = step_fn(st, batch)
        want_losses.append(float(metrics["loss"]))
        if param_err is None:
            param_err = _card_rel(first, st[0], _resolved(st[1].mu))
    loss_err = max(abs(a - c) / abs(c) for a, c in zip(losses, want_losses))
    return want_losses, loss_err, param_err


def policy_dlrm_cell(policy, dev, say, sync, rank: int, world: int,
                     result: dict) -> None:
    """DLRM-MLPerf at train_batch under the vocab-parallel policy: K6 on
    every table shard (exactly 26 launches a step, counted), against the
    plain bag bit for bit; at world size 1 against phase 30's single-device
    step on the same weights (a second draw with the same seeds), and the
    zero rows exactly zero after the steps."""
    from repro_torch import params as P
    from repro_torch.configs import RECSYS_SHAPES, get_arch
    from repro_torch.data import synthetic
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import dlrm

    arch = get_arch("dlrm-mlperf")
    if world == 1:
        cap = DLRM_TRAIN_ROW_CAP
    else:
        cap = _dlrm_policy_cap(policy, dev)
    cfg = arch.make_config(vocab_sizes=tuple(
        min(v, cap) if cap else v for v in dlrm.CRITEO_1TB_VOCABS))
    b = RECSYS_SHAPES["train_batch"].params["batch"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cell = steps.dlrm_train_cell(arch, "train_batch", policy, None, cfg=cfg,
                                 seed=0, device=dev)
    sync()
    draw_s = time.perf_counter() - t0
    model = dlrm.ShardedDLRM.from_tree(cfg, policy, cell.params)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                synthetic.criteo_batch(0, i, batch=b, n_dense=cfg.n_dense,
                                       vocab_sizes=cfg.vocab_sizes,
                                       multi_hot=cfg.multi_hot).items()}
               for i in range(POLICY_DLRM_STEPS)]
    exact = True
    for t, table in enumerate(model.tables):
        ids = dlrm.shard_ids(model, t, batches[0]["sparse"][:, t, :])
        exact &= bool(torch.equal(eb.embedding_bag(table, ids),
                                  eb.embedding_bag_plain(table, ids)))
    sync()
    say(f"dlrm policy K6 on this rank's 26 table shards (B {b}) vs plain: "
        f"bit-identical {exact}", every=True)
    if not exact:
        raise AssertionError(f"rank {rank}: K6 differs on its shards")
    from repro_torch.tree import tree_map
    ops.reset_launches()
    params, state, losses, ms, ledger = _policy_steps(cell, batches[:1],
                                                      sync)
    # The first step's result (world size 1: for the single-device check).
    first = (tree_map(lambda t: t.detach().to("cpu", copy=True), params)
             if world == 1 else None)
    cell.params, cell.opt_state = params, state
    params, state, more, more_ms, _ = _policy_steps(cell, batches[1:], sync)
    losses, ms = losses + more, ms + more_ms
    k6 = ops.LAUNCHES["embedding_bag"]
    result["launches"]["embedding_bag"] = k6
    peak = torch.cuda.max_memory_allocated(dev)
    rows = list(model.rows)
    held = sum(t.shape[0] for t in model.tables)
    pad = max([float(t[r:].abs().max()) for t, r in zip(params["tables"],
                                                         rows)
               if t.shape[0] > r] + [0.0])
    say(f"dlrm policy train: {'published tables' if not cap else f'tables capped at {cap} rows'} "
        f"({sum(cfg.vocab_sizes)} rows; on this card "
        f"{held * 128 * 4 / 1e9:.2f} GB of shards with their zero "
        f"rows, drawn in {draw_s:.2f} s), B {b}: losses {losses}; step ms "
        f"{[round(x, 2) for x in ms]} (host clock); K6 launches {k6} "
        f"({k6 / POLICY_DLRM_STEPS:.0f} a step); zero rows' largest entry "
        f"{pad!r}; peak {peak / 1e9:.2f} GB; ledger a rank a step "
        f"{json.dumps(ledger, sort_keys=True)}", every=True)
    if k6 != cfg.n_sparse * POLICY_DLRM_STEPS:
        raise AssertionError(f"{k6} K6 launches in {POLICY_DLRM_STEPS} "
                             "policy steps")
    if pad != 0.0:
        raise AssertionError(f"a zero row moved: {pad}")
    if world > 1:
        return
    # Phase 30's single-device step on the same weights: the same seeded
    # draw again (its tables as the module's), AdamW at the cell's 1e-3.
    # As phase 30 holds the card to the CPU: every step's loss, and the
    # first step's update (the trajectories part after it: float
    # atomics, and AdamW's normalised steps).
    del params, state, model, cell
    torch.cuda.empty_cache()
    again = P.shard_dlrm(None, cfg, policy, device=dev, seed=0)
    single = again.single_device_view()
    del again
    first["tables"] = [t[:r] for t, r in zip(first["tables"], rows)]
    want_losses, loss_err, param_err = _hold_dlrm_to_single(
        single, batches, first, losses)
    sync()
    say(f"dlrm world-1 policy step vs phase 30's single-device step (same "
        f"weights): losses {losses} vs {want_losses}, max rel err "
        f"{loss_err:.3e}; the first step's parameters max rel err "
        f"{param_err:.3e} over the entries whose gradient passes "
        f"{GRAD_ROUNDING_SHARE:.0e} of its leaf's largest (tolerance "
        f"{POLICY_TOLERANCE:.0e}: index_add_'s float atomics)")
    if not (loss_err < POLICY_TOLERANCE and param_err < POLICY_TOLERANCE):
        raise AssertionError(f"dlrm world-1 policy vs one device: losses "
                             f"{loss_err}, parameters {param_err}")


def policy_dlrm_check(policy, dev, say, sync, rank: int) -> None:
    """Four cards: DLRM at 65,536-row tables from one numpy tree,
    POLICY_CHECK_STEPS policy steps against one card (rank 0): every loss
    and the first step's update."""
    from repro_torch import params as P
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.distributed import comm
    from repro_torch.launch import steps
    from repro_torch.models import dlrm

    arch = get_arch("dlrm-mlperf")
    cfg = arch.make_config(vocab_sizes=tuple(
        min(v, DLRM_TRAIN_CHECK_CAP) for v in dlrm.CRITEO_1TB_VOCABS))
    tree = P.dlrm_params(cfg, seed=1)
    cell = steps.dlrm_train_cell(arch, "train_batch", policy, tree, cfg=cfg,
                                 device=dev)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                synthetic.criteo_batch(1, i, batch=POLICY_DLRM_CHECK_BATCH,
                                       n_dense=cfg.n_dense,
                                       vocab_sizes=cfg.vocab_sizes,
                                       multi_hot=cfg.multi_hot).items()}
               for i in range(POLICY_CHECK_STEPS)]
    # Every loss, and the first step's update: the trajectories part after
    # it (index_add_'s float atomics, and AdamW's normalised steps).
    params, state, losses, _, _ = _policy_steps(cell, batches[:1], sync)
    model = dlrm.ShardedDLRM.from_tree(cfg, policy, params)
    tables = []
    for t, (spec, r) in enumerate(zip(cell.specs["tables"], model.rows)):
        x = params["tables"][t][:r].contiguous()
        if spec[0] is not None:
            x = comm.all_gather(x, policy.group(spec[0]), 0)
        tables.append(x.clone())
    first = {"tables": tables,
             "bot": {k: [t.clone() for t in v] for k, v in
                     params["bot"].items()},
             "top": {k: [t.clone() for t in v] for k, v in
                     params["top"].items()}}
    cell.params, cell.opt_state = params, state
    _, _, more, _, _ = _policy_steps(cell, batches[1:], sync)
    losses += more
    ok = True
    if rank == 0:
        want_losses, loss_err, param_err = _hold_dlrm_to_single(
            P.load_dlrm(tree, cfg, device=dev), batches, first, losses)
        say(f"dlrm at {DLRM_TRAIN_CHECK_CAP}-row tables (one numpy tree), "
            f"{POLICY_CHECK_STEPS} steps at B {POLICY_DLRM_CHECK_BATCH}: "
            f"policy losses {losses} vs one card {want_losses}, max rel err "
            f"{loss_err:.3e}; the first step's parameters {param_err:.3e} "
            f"(entries whose gradient passes {GRAD_ROUNDING_SHARE:.0e} of "
            f"its leaf's largest; tolerance {POLICY_CHECK_TOLERANCE:.0e})")
        ok = (loss_err < POLICY_CHECK_TOLERANCE
              and param_err < POLICY_CHECK_TOLERANCE)
    _agree(ok, policy, dev, "dlrm policy vs one card")


#: Phase 32's GNN cells under a policy (``launch.steps.gnn_train_cell(
#: policy=)``): the state replicated on every rank, each rank training on
#: its shard of the batch, POLICY_GNN_STEPS steps (GCN at ogb_products
#: POLICY_GNN_OGB_STEPS), each held to the single-device cell from the same
#: weights on the same global batch (one card: the world-1 policy step; more:
#: on rank 0's card), per leaf with the GRAD_ZERO_SHARE rule: each step's
#: loss from the same state (the policy's forward at the single-device
#: trajectory's parameters) at TRAIN_TOLERANCE; the first moments (0.1
#: times the clipped gradient) entry by entry at TRAIN_TOLERANCE for GCN,
#: and each leaf's norm at GNN_NORM_TOLERANCE for all four; for the models
#: f32 resolves (not GNN_F32_UNRESOLVED) the first update's parameters over
#: the entries whose first moment passes GRAD_ROUNDING_SHARE of its leaf's
#: largest.  At ``full_graph_sm`` also the first step in f64 (weights and
#: graph widened), the policy's against the single device's: the first
#: moments entry by entry at GNN_F64_TOLERANCE, and the f32 first moments
#: of both against it under GNN_F32_GRAD_LIMIT.  The free trajectories'
#: losses are printed.  Every rank's ledger equals
#: ``launch.steps.gnn_policy_traffic``.  On one card: the four GNNs at
#: ``full_graph_sm`` and GCN at ``ogb_products`` whole.  On more, also
#: GatedGCN and MeshGraphNet at ``minibatch_lg``'s 1,024-seed sample and
#: EquiformerV2 at a 64-seed one (EQV2_TIMED_SEEDS: the full sample would
#: take about 490 GB).
#: reduced: EquiformerV2's minibatch_lg seeds under a policy (1,024 -> 64).
POLICY_GNN_STEPS, POLICY_GNN_OGB_STEPS = 3, 2
#: The f64 steps, policy against single device: the moments are stored in
#: f32 and the clipping factor is an f32 of the norm, so the two differ by
#: a few f32 roundings (2.8e-07 for GatedGCN at full_graph_sm on four gloo
#: ranks); a rank's share counted twice or an edge lost shows far above.
GNN_F64_TOLERANCE = 1e-5
#: Each leaf's first-moment norm, policy against single device in f32.  A
#: norm sums the entries' rounding away: MeshGraphNet's f32 leaf norms
#: miss the f64 step's by up to 5.1e-05 on the CPU (where its entries miss
#: by 6.1e-04), and EquiformerV2's world-1 and single-device steps on an
#: H100 part by 1.6e-04 in ``layers/attn_mlp/w/1``'s norm (2.6e-03 in its
#: entries), while a gradient off by a factor misses by that factor.
GNN_NORM_TOLERANCE = 1e-3
#: The f32 first moments against the f64 step, entry by entry: at the
#: published configs f32 does not resolve every entry (phase 29 read up to
#: 8.7e-03 against an f64 gradient for EquiformerV2, and on the CPU
#: GatedGCN's full_graph_sm moments miss it by 1.2e-03 with one or four
#: threads and 2.1e-05 with two), so this is a limit above those readings,
#: not a tolerance.
GNN_F32_GRAD_LIMIT = 5e-2


def _worst_leaf(got, want, masks) -> tuple:
    """(the largest of :func:`_card_rel`'s per-leaf errors, that leaf's
    path) of two trees of tensors."""
    from repro_torch.tree import tree_leaves, tree_paths

    return max((_card_rel(g, w, [k]), "/".join(map(str, path)))
               for g, (path, w), k in zip(tree_leaves(got), tree_paths(want),
                                          tree_leaves(masks)))


def _worst_norm(got, want, masks) -> tuple:
    """(the largest relative error of a leaf's norm, that leaf's path) of
    two trees of tensors, over the leaves whose mask holds any entry."""
    from repro_torch.tree import tree_leaves, tree_paths

    worst = (0.0, "")
    for g, (path, w), k in zip(tree_leaves(got), tree_paths(want),
                               tree_leaves(masks)):
        if bool(k.any()):
            a, b = float(g.double().norm()), float(w.double().norm())
            worst = max(worst, (abs(a - b) / max(b, 1e-300),
                                "/".join(map(str, path))))
    return worst


def _gnn_cpu_state(params, state) -> tuple:
    """Host copies of a replicated GNN state's parameters and moments (the
    step donates its buffers)."""
    from repro_torch.tree import tree_map

    copy = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    return (tree_map(copy, params), tree_map(copy, state.mu),
            tree_map(copy, state.nu))


def _gnn_f64_moments(name: str, shape: str, cfg, arrays: dict, tree, policy,
                     dev):
    """The first moments (host copies) after one step of the GNN cell in
    f64: ``tree``'s weights and ``arrays``' floating fields widened, and the
    tensors the models make f64 by default.  ``policy`` None: the
    single-device cell on the whole batch."""
    from repro_torch.launch import steps
    from repro_torch.models.gnn import GraphBatch
    from repro_torch.tree import tree_map

    def wide(a):
        if isinstance(a, dict):
            return {k: wide(v) for k, v in a.items()}
        if isinstance(a, np.ndarray) and a.dtype.kind == "f":
            return a.astype(np.float64)
        return a

    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        cell = steps.gnn_train_cell(
            name, shape, policy,
            tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float64)),
                     tree), cfg=cfg, device=dev)
        g = GraphBatch(**{k: wide(v) for k, v in arrays.items()})
        g = cell.meta["shard"](g) if policy is not None else g.to(dev)
        _, state, _ = cell.step(cell.params, cell.opt_state, g)
        return tree_map(lambda t: t.to("cpu", copy=True), state.mu)
    finally:
        torch.set_default_dtype(before)


def policy_gnn_case(name: str, shape: str, cfg, arrays: dict, policy, dev,
                    say, sync, rank: int, n_steps: int,
                    label: str = "") -> None:
    """One GNN train cell under ``policy`` on the global batch ``arrays``
    (numpy fields, alike on every rank): the rank's cut and ``n_steps``
    steps, timed; its ledger against ``launch.steps.gnn_policy_traffic``;
    then on rank 0's card the single-device cell from the same weights on
    the same batch, held as the note above POLICY_GNN_STEPS says, per
    leaf."""
    from repro_torch.distributed import comm
    from repro_torch.launch import steps
    from repro_torch.models.gnn import GraphBatch
    from repro_torch.params import gnn_params
    from repro_torch.tree import tree_leaves, tree_map

    tree = gnn_params(cfg, seed=0)
    param_bytes = sum(4 * np.size(a) for a in tree_leaves(tree))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cell = steps.gnn_train_cell(name, shape, policy, tree, cfg=cfg,
                                device=dev)
    sync()
    t0 = time.perf_counter()
    shard = cell.meta["shard"](GraphBatch(**arrays))
    sync()
    cut_s = time.perf_counter() - t0
    params, state = cell.params, cell.opt_state
    losses, ms, first, ledger = [], [], None, {}
    for i in range(n_steps):
        with comm.recording() as rec:
            sync()
            t0 = time.perf_counter()
            params, state, metrics = cell.step(params, state, shard)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(metrics["loss"]))
        if i == 0:
            first = _gnn_cpu_state(params, state)
            for tag, kinds in rec.by_tag().items():
                for kind, b in kinds.items():
                    ledger[(tag, kind)] = b
    peak = torch.cuda.max_memory_allocated(dev)
    n_loc, e_loc, n_total = shard.n_nodes, shard.n_edges, shard.n_total
    model = steps.gnn_policy_traffic(name, cfg, policy, n_total, param_bytes)
    keys = set(model) | {k for k in ledger if k[0] != "gnn_readout"}
    ledger_ok = all(ledger.get(k, 0.0) == model.get(k, 0.0) for k in keys)
    mesh = tuple(policy.axis_sizes.values())
    what = f"gnn {name} {shape}{label}"
    say(f"{what}: mesh {mesh}, {cfg.name} {cfg.n_layers} layers, "
        f"d_in {cfg.d_in}; N {GraphBatch(**arrays).n_nodes} padded to "
        f"{n_total}, {n_loc} nodes and {e_loc} edges a rank (E "
        f"{arrays['senders'].size}), cut in {cut_s:.2f} s; losses {losses}; "
        f"step ms {[round(x, 1) for x in ms]} (host clock); peak "
        f"{peak / 1e9:.2f} GB; ledger a rank, step 1: "
        f"{json.dumps({'/'.join(k): v for k, v in sorted(ledger.items())})}; "
        f"the models: "
        f"{json.dumps({'/'.join(k): v for k, v in sorted(model.items())})} "
        f"(equal: {ledger_ok})", every=rank == 0 or not ledger_ok)
    ok = ledger_ok and all(np.isfinite(losses))
    del cell, params, state
    torch.cuda.empty_cache()
    states = []
    if rank == 0:
        single = steps.gnn_train_cell(name, shape, None, tree, cfg=cfg,
                                      device=dev)
        g = GraphBatch(**arrays).to(dev)
        p1, st1 = single.params, single.opt_state
        want_losses, want = [], None
        for i in range(n_steps):
            states.append(tree_map(lambda t: t.to("cpu", copy=True), p1))
            p1, st1, metrics = single.step(p1, st1, g)
            want_losses.append(float(metrics["loss"]))
            if i == 0:
                want = _gnn_cpu_state(p1, st1)
        del single, p1, st1, g
        torch.cuda.empty_cache()
    # Each step's loss from the same state: the policy's forward on this
    # rank's shard at the single-device trajectory's parameters (rank 0's,
    # broadcast).
    import torch.distributed as dist

    from repro_torch.launch.train import GNN_MODELS
    from repro_torch.params import gnn_tree, tree_loss

    module, model_cls = GNN_MODELS[name]
    loss = tree_loss(model_cls(cfg, device=dev), module.loss_fn)
    everyone = policy.group(policy.all_axes)
    same = []
    for i in range(n_steps):
        p = gnn_tree(cfg, tree, device=dev)
        for j, t in enumerate(tree_leaves(p)):
            if rank == 0:
                t.copy_(tree_leaves(states[i])[j])
            dist.broadcast(t, src=0, group=everyone)
        with torch.no_grad():
            same.append(float(loss(p, shard)[1]["loss"]))
        del p
    del shard, states
    torch.cuda.empty_cache()
    # The first step in f64, on every rank under the policy and on rank 0's
    # card alone.
    exact = shape == "full_graph_sm"
    if exact:
        wide = _gnn_f64_moments(name, shape, cfg, arrays, tree, policy, dev)
        if rank == 0:
            wide_one = _gnn_f64_moments(name, shape, cfg, arrays, tree, None,
                                        dev)
        torch.cuda.empty_cache()
    if rank == 0:
        rel = lambda a, c: max(abs(x - y) / abs(y)  # noqa: E731
                               for x, y in zip(a, c))
        same_err, free_err = rel(same, want_losses), rel(losses, want_losses)
        dropped = []
        masks = _resolved(want[1], dropped)
        leaves = tree_map(lambda k: torch.full_like(k, bool(k.any())), masks)
        param_err, param_at = _worst_leaf(first[0], want[0], masks)
        moment_err, moment_at = max(_worst_leaf(first[1], want[1], leaves),
                                    _worst_leaf(first[2], want[2], leaves))
        norm_err, norm_at = _worst_norm(first[1], want[1], leaves)
        resolved = name not in GNN_F32_UNRESOLVED
        zero_s = ", ".join(f"{'/'.join(map(str, path))} ({share:.3e} of the "
                           "model's largest)" for path, share in dropped)
        held = [same_err] + ([param_err] if resolved else [])
        held += [moment_err] if name == "gcn-cora" else []
        say(f"{what} vs the single-device step (same weights and batch): "
            f"each step's loss from the same state {same} vs {want_losses}, "
            f"max rel err {same_err:.3e} (held); the first moments "
            f"{moment_err:.3e} ({moment_at}; "
            f"{'held' if name == 'gcn-cora' else 'printed'}), their norm a "
            f"leaf {norm_err:.3e} ({norm_at}; held at "
            f"{GNN_NORM_TOLERANCE:.0e}); the first update's parameters "
            f"{param_err:.3e} ({param_at}; entries whose first moment passes "
            f"{GRAD_ROUNDING_SHARE:.0e} of its leaf's largest; "
            f"{'held' if resolved else 'printed'}); tolerance "
            f"{TRAIN_TOLERANCE:.0e}.  The free trajectory's losses, max rel "
            f"err {free_err:.3e} (printed); leaves zero to rounding, held at "
            f"no entry: {zero_s or 'none'}")
        ok = ok and max(held) < TRAIN_TOLERANCE and \
            norm_err < GNN_NORM_TOLERANCE
        if exact:
            dropped64 = []
            keep64 = tree_map(lambda k: torch.full_like(k, bool(k.any())),
                              _resolved(wide_one, dropped64))
            f64_err, f64_at = _worst_leaf(wide, wide_one, keep64)
            pol_err, pol_at = _worst_leaf(first[1], wide_one, keep64)
            one_err, one_at = _worst_leaf(want[1], wide_one, keep64)
            say(f"{what} first step in f64: the policy's first moments vs "
                f"the single device's {f64_err:.3e} ({f64_at}; held at "
                f"{GNN_F64_TOLERANCE:.0e}); the f32 first moments against "
                f"them, the policy's {pol_err:.3e} ({pol_at}), the single "
                f"device's {one_err:.3e} ({one_at}) (held under "
                f"{GNN_F32_GRAD_LIMIT:.0e}); leaves zero to rounding: "
                + (", ".join("/".join(map(str, p)) for p, _ in dropped64)
                   or "none"))
            ok = ok and f64_err < GNN_F64_TOLERANCE and \
                max(pol_err, one_err) < GNN_F32_GRAD_LIMIT
    _agree(ok, policy, dev, f"{what} policy vs one card")


def policy_gnn_cells(policy, dev, say, sync, rank: int, world: int,
                     job: dict) -> None:
    """Phase 32's GNN cells (:data:`POLICY_GNN_STEPS`): the four GNNs at
    ``full_graph_sm`` and GCN at ``ogb_products`` whole (phase 22's edges,
    from the job's ``.npy`` files); on more than one card also GatedGCN
    and MeshGraphNet at ``minibatch_lg``'s 1,024-seed sample and
    EquiformerV2 at a 64-seed one.  Prints the memory reckoning that keeps
    the other three out of ``ogb_products``."""
    from repro_torch.configs import GNN_SHAPES, get_arch
    from repro_torch.launch import steps

    for name in ("gcn-cora", "gatedgcn", "meshgraphnet", "equiformer-v2"):
        cfg = steps.gnn_config(name, "full_graph_sm")
        policy_gnn_case(name, "full_graph_sm", cfg,
                        gnn_graph(name, "full_graph_sm", cfg), policy, dev,
                        say, sync, rank, POLICY_GNN_STEPS)
    arrays = ogb_gcn_graph((np.load(job["ogb"][0]), np.load(job["ogb"][1])))
    policy_gnn_case("gcn-cora", "ogb_products",
                    steps.gnn_config("gcn-cora", "ogb_products"), arrays,
                    policy, dev, say, sync, rank, POLICY_GNN_OGB_STEPS)
    del arrays
    E = GNN_SHAPES["ogb_products"].params["n_edges"]
    ggcn = get_arch("gatedgcn").make_config()
    mgn = get_arch("meshgraphnet").make_config()
    eqv = get_arch("equiformer-v2").make_config()
    say(f"gnn cut at ogb_products (E {E}, f32, no remat, on {world} "
        f"card(s)): gatedgcn's edge state E x {ggcn.d_hidden} "
        f"{4 * E * ggcn.d_hidden / 1e9:.1f} GB a tensor, "
        f"{4 * E * ggcn.d_hidden / world / 1e9:.1f} GB a rank, and its "
        f"{ggcn.n_layers} layers keep {ggcn.n_layers} for the backward "
        f"({ggcn.n_layers * 4 * E * ggcn.d_hidden / world / 1e9:.1f} GB a "
        f"rank); meshgraphnet's edge-MLP input E x {3 * mgn.d_hidden} "
        f"{4 * E * 3 * mgn.d_hidden / 1e9:.1f} GB; equiformer-v2's messages "
        f"E x {eqv.L2} x {eqv.d_hidden} "
        f"{4 * E * eqv.L2 * eqv.d_hidden / 1e12:.2f} TB; the card holds 80 "
        "GB")
    if world == 1:
        return
    p = GNN_SHAPES["minibatch_lg"].params
    mb = minibatch_samples((p["batch_nodes"], EQV2_TIMED_SEEDS))
    say(f"gnn minibatch_lg set-up: {mb['line']}")
    plan = {"gatedgcn": p["batch_nodes"], "meshgraphnet": p["batch_nodes"],
            "equiformer-v2": EQV2_TIMED_SEEDS}
    for name, n in plan.items():
        cfg = steps.gnn_config(name, "minibatch_lg")
        rng_l = np.random.default_rng(3)
        if name == "meshgraphnet":
            lab = rng_l.standard_normal((mb["V"], cfg.d_out)).astype(
                np.float32)
        elif name == "equiformer-v2":
            lab = rng_l.standard_normal((1, cfg.d_out)).astype(np.float32)
        else:
            lab = mb["labels"]
        batch = steps.subgraph_batch(name, cfg, mb["samples"][n],
                                     mb["feats"], lab,
                                     positions=mb["positions"])
        policy_gnn_case(name, "minibatch_lg", cfg, vars(batch), policy, dev,
                        say, sync, rank, POLICY_GNN_STEPS,
                        label=f" ({n} seeds)")


def policy_train_rank(rank: int, world: int, job: dict) -> dict:
    """Phase 32 on one NCCL rank (its card is ``cuda:rank``), on a (1, 1)
    mesh on one card and (2, world / 2) over (data, model) on more:
    SmolLM-135M and gemma2-2b through ``launch.steps.lm_train_cell``,
    DLRM-MLPerf through ``dlrm_train_cell`` and the GNNs through
    ``gnn_train_cell`` (:func:`policy_gnn_cells`); on more than one card
    also the 2-layer gemma2-2b and 65,536-row DLRM checks against one
    card.
    Prints its lines as they come; returns the counted K6 launches."""
    import torch.distributed as dist

    from repro_torch import backend
    from repro_torch.distributed.sharding import make_policy
    from repro_torch.launch.mesh import make_test_mesh

    backend.full_fp32()
    dev = rank_device(rank)
    shape = (1, 1) if world == 1 else (2, world // 2)
    policy = make_policy(make_test_mesh(shape, ("data", "model")))
    everyone = policy.group(policy.all_axes)
    result = {"launches": {}}

    def say(msg: str, every: bool = False) -> None:
        # Printed as it comes (a later failure keeps the earlier lines).
        if rank == 0 or every:
            line = f"rank {rank}: {msg}" if every else msg
            print(f"# policy {line} | {job['card']}", flush=True)

    def sync() -> None:
        torch.cuda.synchronize(dev)
        dist.barrier(group=everyone)

    t_rank = time.perf_counter()
    compare = world == 1
    policy_lm_cell("smollm-135m", POLICY_LM_BATCH, policy, dev, say, sync,
                   compare)
    policy_lm_cell("gemma2-2b", POLICY_GEMMA2_BATCH, policy, dev, say, sync,
                   compare)
    if world > 1:
        for seed in POLICY_CHECK_SEEDS:
            policy_gemma2_check(policy, dev, say, sync, rank, seed)
    t_lm = time.perf_counter()
    policy_dlrm_cell(policy, dev, say, sync, rank, world, result)
    if world > 1:
        policy_dlrm_check(policy, dev, say, sync, rank)
    t_dlrm = time.perf_counter()
    policy_gnn_cells(policy, dev, say, sync, rank, world, job)
    say(f"rank program {time.perf_counter() - t_rank:.1f} s (host clock): "
        f"LM cells {t_lm - t_rank:.1f} s, DLRM {t_dlrm - t_lm:.1f} s, GNN "
        f"cells {time.perf_counter() - t_dlrm:.1f} s")
    return result


def minibatch_samples(counts: tuple) -> dict:
    """``minibatch_lg``'s host set-up: the power-law CSR at Reddit's size
    (:data:`MINIBATCH_GRAPH`), seeded features, labels and positions, and
    for each seed count in ``counts`` a sample of the first that many of
    one seed draw with fanout (15, 10), padded to
    ``steps.sampled_subgraph_sizes``.  The same on every host and rank;
    ``line`` says what it built and in what host time."""
    from repro_torch.configs import GNN_SHAPES
    from repro_torch.data.sampler import sample_subgraph
    from repro_torch.launch import steps

    t0 = time.perf_counter()
    p = GNN_SHAPES["minibatch_lg"].params
    g = MINIBATCH_GRAPH
    csr = power_law_csr(g["n_nodes"], g["n_edges"], g["seed"], g["alpha"])
    rng = np.random.default_rng(g["seed"])
    V, d_feat = g["n_nodes"], p["d_feat"]
    feats = rng.standard_normal((V, d_feat), dtype=np.float32)
    labels = rng.integers(0, steps.GNN_N_CLASSES["minibatch_lg"], V)
    positions = rng.standard_normal((V, 3))
    graph_s = time.perf_counter() - t0
    fanout = tuple(p["fanout"])
    seeds = rng.choice(V, p["batch_nodes"], replace=False)
    samples, sample_ms = {}, {}
    for n in counts:
        n_pad, e_pad = steps.sampled_subgraph_sizes(n, fanout)
        t0 = time.perf_counter()
        samples[n] = sample_subgraph(csr, seeds[:n], fanout,
                                     rng=np.random.default_rng(n),
                                     n_pad=n_pad, e_pad=e_pad)
        sample_ms[n] = 1e3 * (time.perf_counter() - t0)
    line = (f"power-law CSR V {V} E {g['n_edges']} (alpha {g['alpha']}, col "
            f"{csr.col.nbytes / 1e6:.0f} MB int32), {d_feat} features and "
            f"{steps.GNN_N_CLASSES['minibatch_lg']} classes, {graph_s:.1f} s "
            f"(host); fanout {fanout}: "
            + "; ".join(f"{n} seeds {sub.n_real_nodes} nodes "
                        f"{sub.n_real_edges} edges padded to "
                        f"{steps.sampled_subgraph_sizes(n, fanout)}, sampled "
                        f"in {sample_ms[n]:.1f} ms" for n, sub in
                        samples.items())
            + " (host clock)")
    return {"V": V, "feats": feats, "labels": labels,
            "positions": positions, "samples": samples, "line": line}


def minibatch_phase(dev, card: str) -> None:
    """Phase 32's GNN cell: ``minibatch_lg`` at world size 1.  The graph is
    generated straight into CSR form on the host, 1,024 seeds are sampled
    with fanout (15, 10) into the padded sizes of
    ``steps.sampled_subgraph_sizes``, and each GNN at its published config
    for the shape takes one timed step through ``steps.gnn_train_cell`` on
    the card, then one step held against the CPU: GCN on the full sample,
    GatedGCN and MeshGraphNet on a 64-seed sample of the same CSR (GatedGCN
    on the full sample until the script's depth was cut for phase 33),
    EquiformerV2 timed on the 64-seed sample and held on a 4-seed one
    (:data:`EQV2_TIMED_SEEDS`)."""
    from repro_torch.configs import GNN_SHAPES
    from repro_torch.launch import steps
    from repro_torch.params import gnn_params
    from repro_torch.tree import tree_map

    p = GNN_SHAPES["minibatch_lg"].params
    mb = minibatch_samples((p["batch_nodes"], MINIBATCH_CHECK_SEEDS,
                            EQV2_CHECK_SEEDS))
    print(f"# minibatch_lg set-up: {mb['line']} | {card}")
    samples, feats, labels, positions, V = (
        mb["samples"], mb["feats"], mb["labels"], mb["positions"], mb["V"])
    plan = {"gcn-cora": (p["batch_nodes"], p["batch_nodes"]),
            "gatedgcn": (p["batch_nodes"], MINIBATCH_CHECK_SEEDS),
            "meshgraphnet": (p["batch_nodes"], MINIBATCH_CHECK_SEEDS),
            "equiformer-v2": (EQV2_TIMED_SEEDS, EQV2_CHECK_SEEDS)}
    for arch, (timed_n, held_n) in plan.items():
        cfg = steps.gnn_config(arch, "minibatch_lg")
        rng_l = np.random.default_rng(3)
        if arch == "meshgraphnet":
            lab = rng_l.standard_normal((V, cfg.d_out)).astype(np.float32)
        elif arch == "equiformer-v2":
            lab = rng_l.standard_normal((1, cfg.d_out)).astype(np.float32)
        else:
            lab = labels
        tree = gnn_params(cfg, seed=0)
        t0 = time.perf_counter()
        batches = {n: steps.subgraph_batch(arch, cfg, samples[n], feats, lab,
                                           positions=positions)
                   for n in {timed_n, held_n}}
        batch_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        cell = steps.gnn_train_cell(arch, "minibatch_lg", None, tree,
                                    cfg=cfg, device=dev)
        gd = batches[timed_n].to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, metrics = cell.step(cell.params, cell.opt_state, gd)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev)
        timed_loss = float(metrics["loss"])
        del cell, gd
        cell = steps.gnn_train_cell(arch, "minibatch_lg", None, tree,
                                    cfg=cfg, device=dev)
        params, _, metrics = cell.step(cell.params, cell.opt_state,
                                       batches[held_n].to(dev))
        loss = float(metrics["loss"])
        cpu = steps.gnn_train_cell(arch, "minibatch_lg", None, tree, cfg=cfg,
                                   device="cpu")
        c_params, c_state, c_metrics = cpu.step(
            cpu.params, cpu.opt_state, batches[held_n].to("cpu"))
        c_loss = float(c_metrics["loss"])
        loss_err = abs(loss - c_loss) / max(abs(c_loss), 1e-30)
        dropped = []
        param_err = _card_rel(tree_map(lambda t: t.cpu(), params), c_params,
                              _resolved(c_state.mu, dropped))
        zero_s = ", ".join(f"{'/'.join(map(str, path))} ({share:.3e} of the "
                           "model's largest)" for path, share in dropped)
        print(f"# minibatch_lg {arch}: {cfg.name} (d_in {cfg.d_in}), batches "
              f"laid out in {batch_s:.2f} s (host); one step on the "
              f"{timed_n}-seed sample {step_ms:.1f} ms (host clock, first "
              f"call), loss {timed_loss!r}, peak {peak / 1e9:.2f} GB; card "
              f"vs CPU on the {held_n}-seed sample: loss {loss!r} vs "
              f"{c_loss!r} (rel err {loss_err:.3e}), parameters max rel err "
              f"{param_err:.3e} (the entries whose gradient passes "
              f"{GRAD_ROUNDING_SHARE:.0e} of its leaf's largest; tolerance "
              f"{GNN_TOLERANCE:.0e}; leaves zero to rounding, under "
              f"{GRAD_ZERO_SHARE:.2e} of the model's largest gradient, held "
              f"at no entry: {zero_s or 'none'}) | {card}")
        if not np.isfinite(timed_loss):
            raise AssertionError(f"minibatch_lg {arch}: loss {timed_loss}")
        if not (loss_err < GNN_TOLERANCE and param_err < GNN_TOLERANCE):
            raise AssertionError(f"minibatch_lg {arch}: card vs CPU loss "
                                 f"{loss_err}, parameters {param_err}")
        del cell, params, cpu, c_params, c_state


def policy_training_phase(dev, card: str, launches: dict,
                          ogb_edges: tuple) -> None:
    """Phase 32: training under a sharding policy, one NCCL rank a visible
    card (:func:`policy_train_rank`; phase 22's ``ogb_edges`` handed to the
    ranks as ``.npy`` files), then the ``minibatch_lg`` GNN cell
    (:func:`minibatch_phase`) on one card.  Adds rank 0's counted K6
    launches to ``launches``."""
    import tempfile

    from repro_torch.launch.mesh import spawn

    t_phase = time.perf_counter()
    card = card.replace("\n", "; ")
    world = torch.cuda.device_count()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-policy-") as tmp:
        paths = [str(Path(tmp) / f"ogb_{k}.npy") for k in ("snd", "rcv")]
        for path, a in zip(paths, ogb_edges):
            np.save(path, a)
        t0 = time.perf_counter()
        sys.stdout.flush()
        results = spawn(policy_train_rank, world, backend="nccl",
                        args=({"card": card, "ogb": paths},))
        ranks_s = time.perf_counter() - t0
    for kname, count in results[0]["launches"].items():
        launches[kname] += count
    print(f"# policy phase launches (rank 0): "
          f"{json.dumps(results[0]['launches'], sort_keys=True)}; ranks "
          f"{ranks_s:.1f} s (host clock)")
    t0 = time.perf_counter()
    if world == 1:
        minibatch_phase(dev, card)
    print(f"# phase 32 took {time.perf_counter() - t_phase:.1f} s (host "
          f"clock): the ranks {ranks_s:.1f} s (the cells' split in the "
          f"ranks' lines), minibatch_lg {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 33: the dry run and the H100 machine model against the card
# ---------------------------------------------------------------------------

#: granite-3-2b's prefill_32k on one card, with room for GRANITE_STEPS
#: decode steps: B 32 cut to 13, the largest batch whose dry-run peak stays
#: under GRANITE_PEAK_LIMIT (68.76 GB at B 13, 73.66 GB at B 14:
#: ``python -m repro_torch.launch.dryrun --mesh card --arch granite-3-2b
#: --shape prefill_32k --batch 14 --max-seq 32772``).
#: reduced: batch (prefill_32k: 32 -> 13)
GRANITE_BATCH, GRANITE_STEPS, GRANITE_PEAK_LIMIT = 13, 4, 70e9
GRANITE_CHECK_LAYERS, GRANITE_CHECK_SEQ = 4, 256
#: The other two cells held on the card: smollm-135m's train_4k at B 8 (as
#: phase 28) and dlrm-mlperf's serve_bulk with every table capped at
#: 1,000,000 rows.
#: reduced: batch (train_4k: 256 -> 8); vocab_sizes (serve_bulk: every
#: table capped at 1,000,000 rows)
HELD_LM_BATCH, HELD_DLRM_ROW_CAP, HELD_REPS = 8, 1_000_000, 3
#: A measured step under this share of its roofline bound means a count
#: is wrong.
ROOFLINE_FLOOR = 0.95
#: The dry run's peak against ``max_memory_allocated``, and the card's
#: memory against the machine model's.
PEAK_TOLERANCE, CARD_MEMORY_TOLERANCE = 0.15, 0.10


def dryrun_cli(args: list, out: Path):
    """``python -m repro_torch.launch.dryrun`` in a process of its own (the
    fake process group is process-global), writing under ``out``."""
    import os
    import subprocess

    env = dict(os.environ)
    src = str(Path(__file__).resolve().parent / "src")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *map(str, args),
         "--force", "--out", str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def dryrun_record(proc, out: Path, mesh: str, arch: str,
                  shape: str) -> tuple[dict, str]:
    """The record a :func:`dryrun_cli` process wrote, and its cell line;
    raises unless it exited 0."""
    text, _ = proc.communicate(timeout=900)
    path = out / mesh / f"{arch}__{shape}.json"
    if proc.returncode != 0 or not path.exists():
        raise AssertionError(f"dry run {arch} x {shape} on {mesh}: exit "
                             f"{proc.returncode}: {text[-3000:]}")
    line = next(ln for ln in text.splitlines() if f"{arch} x {shape}" in ln)
    return json.loads(path.read_text()), line


#: Phase 33's dry runs: key -> (mesh, arch, shape, the CLI's cuts).  The
#: first three are the cells held on the card.
DRY_CELLS = {
    "granite": ("card", "granite-3-2b", "prefill_32k",
                ["--batch", GRANITE_BATCH, "--max-seq",
                 32768 + GRANITE_STEPS]),
    "smollm": ("card", "smollm-135m", "train_4k", ["--batch", HELD_LM_BATCH]),
    "dlrm": ("card", "dlrm-mlperf", "serve_bulk",
             ["--row-cap", HELD_DLRM_ROW_CAP]),
    "production": ("single", "granite-3-2b", "prefill_32k", []),
}


def start_dry_runs() -> tuple[Path, dict]:
    """DRY_CELLS' dry runs, each in a process of its own, started together
    beside the kernels' build: they have ended, and their CUDA contexts
    with them, before anything is timed or granite fills the card."""
    import tempfile

    out = Path(tempfile.mkdtemp(prefix="chip-smoke-dryrun-"))
    return out, {k: dryrun_cli(["--mesh", m, "--arch", a, "--shape", sh,
                                *x], out / k)
                 for k, (m, a, sh, x) in DRY_CELLS.items()}


def finish_dry_runs(out: Path, procs: dict, t0: float) -> dict:
    """The records of :func:`start_dry_runs`' processes, each waited for,
    its cell line printed; the output directory removed."""
    import shutil

    recs = {}
    try:
        for key, (m, a, sh, _) in DRY_CELLS.items():
            recs[key], line = dryrun_record(procs[key], out / key, m, a, sh)
            print(f"# dryrun {key} (ended within {time.perf_counter() - t0:.1f}"
                  f" s of the build's start): {line}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out, ignore_errors=True)
    return recs


def held_cell(label: str, plan, dev, on_first=None,
              keep_last: bool = False) -> dict:
    """One world-1 cell run for real: the step ``plan.step`` builds with
    seeded values, called HELD_REPS times, each timed on the host clock
    (ending in a synchronise), the first under ``FlopCounterMode``, with
    the peak memory above what was allocated before the arguments.
    :func:`hold_to_dry_run` holds what it returns to the cell's trace."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fn, args = plan.step(dev, draw=True, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counter = FlopCounterMode(display=False)
    torch.cuda.reset_peak_memory_stats()
    dts, per_call = [], []
    for i in range(HELD_REPS):
        before = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            with counter:
                out = fn(*args)
        else:
            out = fn(*args)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        per_call.append({k: ops.LAUNCHES[k] - before[k] for k in before})
        if i == 0 and on_first is not None:
            on_first(out, per_call[0])
        if i < HELD_REPS - 1 or not keep_last:
            del out
    k5 = torch.ops.repro_torch.flash_attention
    return {"label": label, "model_flops": plan.model_flops,
            "flops": float(counter.get_total_flops()),
            "k5_flops": float(counter.get_flop_counts().get(
                "Global", {}).get(k5, 0)),
            "peak": torch.cuda.max_memory_allocated() - base, "dts": dts,
            "step_s": statistics.median(dts), "setup_s": setup_s,
            "calls": per_call, "out": out if keep_last else None,
            "args": args if keep_last else None}


def hold_to_dry_run(got: dict, rec: dict, card: str) -> None:
    """A :func:`held_cell` run against its dry run's record: the FLOPs
    equal (K5's share too), the peak within PEAK_TOLERANCE and the median
    step at least ROOFLINE_FLOOR of the roofline's bound."""
    label, flops, k5_flops, peak, step = (got[k] for k in (
        "label", "flops", "k5_flops", "peak", "step_s"))
    roof = rec["roofline"]
    bound = roof["step_time_s"]
    ideal = got["model_flops"] / (roof["chips"] * H100_SXM.peak_flops(
        roof["peak_dtype"]))
    dry_peak = rec["memory"]["peak_bytes"]
    peak_err = abs(dry_peak - peak) / peak
    print(f"# dryrun {label}: FLOPs fake trace {rec['cost']['flops']:.6e} vs "
          f"the real step {flops:.6e} (equal {flops == rec['cost']['flops']};"
          f" K5 {rec['cost']['k5_flops']:.6e} vs {k5_flops:.6e}); peak "
          f"{dry_peak / 1e9:.3f} GB dry vs {peak / 1e9:.3f} GB "
          f"max_memory_allocated ({100 * peak_err:.1f}% apart, tolerance "
          f"{100 * PEAK_TOLERANCE:.0f}%); step median "
          f"{step * 1e3:.2f} ms of {HELD_REPS} (host clock, the first "
          "counted, "
          + " ".join(f"{d * 1e3:.2f}" for d in got["dts"])
          + f") vs the roofline's overlapped bound {bound * 1e3:.2f} ms "
          f"({roof['dominant']}-bound: compute {roof['compute_s'] * 1e3:.2f}"
          f" ms at the {roof['peak_dtype']} peak, memory "
          f"{roof['memory_s'] * 1e3:.2f} ms of {rec['cost']['op_bytes']:.4e}"
          f" operand bytes, collective {roof['collective_s'] * 1e3:.2f} ms;"
          f" step / bound {step / bound:.3f}, floor {ROOFLINE_FLOOR}); "
          f"roofline fraction {roof['roofline_fraction']:.4f} at the bound,"
          f" {ideal / step:.4f} measured; set-up {got['setup_s']:.2f} s; "
          "launches a call "
          f"{json.dumps({k: v for k, v in got['calls'][0].items() if v})}"
          f" | {card}")
    if flops != rec["cost"]["flops"]:
        raise AssertionError(f"{label}: the real step counts {flops} FLOPs, "
                             f"the fake trace {rec['cost']['flops']}")
    if k5_flops != rec["cost"]["k5_flops"]:
        raise AssertionError(f"{label}: K5's FLOPs {k5_flops} vs "
                             f"{rec['cost']['k5_flops']}")
    if not peak_err <= PEAK_TOLERANCE:
        raise AssertionError(f"{label}: dry peak {dry_peak} vs {peak}")
    if not step >= ROOFLINE_FLOOR * bound:
        raise AssertionError(f"{label}: the step ({step} s) beats its "
                             f"roofline bound ({bound} s): a count is wrong")


def dryrun_phase(dev, card: str, launches: dict, recs: dict) -> None:
    """Phase 33: the machine model against the card, three world-1 cells
    (granite-3-2b's prefill_32k served at full width and depth, the first
    time on the card; smollm-135m's train_4k; dlrm-mlperf's serve_bulk)
    run for real and held to their dry runs (``recs``, made beside the
    build by :func:`start_dry_runs`), and one production cell through the
    CLI.  Adds the held cells' K5 and K6 launches to ``launches``."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import backend, params
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import _free_port, make_test_mesh
    from repro_torch.distributed.sharding import make_policy
    from repro_torch.models import transformer as tr

    t_phase = time.perf_counter()
    k5, k6 = "flash_attention", "embedding_bag"
    # 33a. The machine model against the card.
    props = torch.cuda.get_device_properties(0)
    mem_err = abs(props.total_memory - H100_SXM.hbm_bytes) / H100_SXM.hbm_bytes
    print(f"# dryrun machine: {props.name}, total_memory "
          f"{props.total_memory} B, {props.multi_processor_count} SMs | "
          f"{card}; the model {H100_SXM.name}: {H100_SXM.sm_count} SMs, "
          f"{H100_SXM.hbm_bytes} B of HBM ({100 * mem_err:.1f}% apart, "
          f"tolerance {100 * CARD_MEMORY_TOLERANCE:.0f}%), bf16 "
          f"{H100_SXM.peak_flops_bf16:.3g} / tf32 "
          f"{H100_SXM.peak_flops_tf32:.3g} / fp32 "
          f"{H100_SXM.peak_flops_fp32:.3g} FLOP/s, HBM "
          f"{H100_SXM.hbm_bandwidth:.3g} B/s, NVLink "
          f"{H100_SXM.nvlink_bandwidth:.3g} B/s")
    if props.multi_processor_count != H100_SXM.sm_count:
        raise AssertionError(f"{props.multi_processor_count} SMs, the model "
                             f"says {H100_SXM.sm_count}")
    if not mem_err <= CARD_MEMORY_TOLERANCE:
        raise AssertionError(f"{props.total_memory} B of device memory, the "
                             f"model says {H100_SXM.hbm_bytes}")

    # 33b. The world-1 cells for real (one NCCL rank on this card), no
    # trace running beside them.
    cfg = get_arch("granite-3-2b").make_config()
    s = 32768
    max_seq = s + GRANITE_STEPS
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        policy = make_policy(make_test_mesh((1, 1), ("data", "model")))
        runs = {}
        runs["smollm"] = held_cell(
            f"smollm-135m train_4k (world 1, B {HELD_LM_BATCH} x 4096)",
            steps.plan("smollm-135m", "train_4k", policy,
                       batch=HELD_LM_BATCH), dev)
        runs["dlrm"] = held_cell(
            f"dlrm-mlperf serve_bulk (world 1, tables capped at "
            f"{HELD_DLRM_ROW_CAP} rows, B 262144)",
            steps.plan("dlrm-mlperf", "serve_bulk", policy,
                       row_cap=HELD_DLRM_ROW_CAP), dev)
        per_call = [c[k6] for c in runs["dlrm"]["calls"]]
        launches[k6] += sum(per_call)
        if any(n != 26 for n in per_call):
            raise AssertionError(f"K6 launched {per_call} times a DLRM "
                                 "forward (expected 26)")
        t_small = time.perf_counter()

        # granite-3-2b's prefill_32k, served: K5 on every layer, layer 0's
        # q, k, v copied to the host in the first (counted) call for the
        # check, so that the card holds only the cell.
        backend.full_fp32()
        plan = steps.plan("granite-3-2b", "prefill_32k", policy,
                          batch=GRANITE_BATCH, max_seq=max_seq)
        captured = {}
        counted = ops.flash_attention

        def capture(q, k, v, **kw):
            if not captured:
                captured.update(q=q.cpu(), k=k.cpu(), v=v.cpu())
            return counted(q, k, v, **kw)

        def first_call(out_, first):
            ops.flash_attention = counted

        ops.flash_attention = capture
        try:
            got = held_cell(
                f"granite-3-2b prefill_32k (world 1, {cfg.n_layers} layers d "
                f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads x "
                f"{cfg.d_head}, B {GRANITE_BATCH} x {s}, bf16)", plan, dev,
                on_first=first_call, keep_last=True)
        finally:
            ops.flash_attention = counted
        per_call = [c[k5] for c in got["calls"]]
        launches[k5] += sum(per_call)
        if any(n != cfg.n_layers for n in per_call) or not got["k5_flops"]:
            raise AssertionError(f"K5 launched {per_call} times a granite "
                                 f"prefill (expected {cfg.n_layers}), K5 "
                                 f"FLOPs {got['k5_flops']}")
        logits, cache = got.pop("out")
        model = got.pop("args")[0]
        runs["granite"] = got
        peak = torch.cuda.max_memory_allocated()
        if logits.shape != (GRANITE_BATCH, cfg.vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"granite logits {tuple(logits.shape)}")
        serve = tr.make_serve_step(cfg, max_seq, policy=policy,
                                   decode=tr.DecodePolicy(
                                       batch_axes=tuple(policy.dp_axes)))
        token = logits.argmax(-1, keepdim=True)
        step_s = []
        for i in range(GRANITE_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step_logits, cache = serve(model, cache, token, s + i)
            token = step_logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
        if not bool(torch.isfinite(step_logits).all()) or not bool(
                ((token >= 0) & (token < cfg.vocab)).all()):
            raise AssertionError("granite decode logits or tokens")
        print(f"# dryrun granite-3-2b served: {cfg.param_count()} parameters"
              f" (bf16, drawn on the card), B {GRANITE_BATCH} x {s} prompt "
              f"tokens (prefill_32k's B {32} cut to the largest under "
              f"{GRANITE_PEAK_LIMIT / 1e9:.0f} GB), prefill "
              f"{got['step_s'] * 1e3:.1f} ms = "
              f"{GRANITE_BATCH * s / got['step_s']:.0f} tokens/s; "
              f"{GRANITE_STEPS} decode steps p50 "
              f"{percentile(step_s, 50) * 1e3:.3f} ms, p99 "
              f"{percentile(step_s, 99) * 1e3:.3f} ms ({GRANITE_BATCH} "
              f"tokens a step); K5 {per_call} launches a prefill; peak "
              f"device memory {peak / 1e9:.2f} GB | {card}")
        if peak > GRANITE_PEAK_LIMIT:
            raise AssertionError(f"granite peak {peak} B")
        del logits, cache, step_logits, token, got, model
        torch.cuda.empty_cache()
        t_served = time.perf_counter()
        # K5 against its plain version on layer 0's served q, k, v, one
        # batch entry (and its plain version one kv head's query group) at
        # a time.
        n_k5 = ops.LAUNCHES[k5]
        err = worst_abs = 0.0
        for bi in range(GRANITE_BATCH):
            kout, expect = k5_sliced_check(
                *(captured[n][bi:bi + 1].to(dev) for n in "qkv"), None, None)
            err = max(err, rel_err(kout, expect))
            worst_abs = max(worst_abs, abs_err(kout, expect))
            del kout, expect
        ops.LAUNCHES[k5] = n_k5  # comparisons, not the path
        print(f"# dryrun granite K5 on layer 0's served q, k, v "
              f"{tuple(captured['q'].shape)} vs plain (one batch entry at a "
              f"time): max rel err {err:.3e} (tolerance "
              f"{ATTN_TOLERANCE['bf16']:.0e}), max abs err {worst_abs:.3e}")
        if not err < ATTN_TOLERANCE["bf16"]:
            raise AssertionError(f"granite K5 vs plain: {err}")
        del captured
        torch.cuda.empty_cache()
        # f32 logits at 4 layers, S 256: the card (K5's f32 kernel) vs the
        # CPU (the plain version).
        cfg32 = dataclasses.replace(cfg, n_layers=GRANITE_CHECK_LAYERS,
                                    dtype="float32")
        model32 = params.draw_transformer(cfg32, seed=0, device=dev)
        rng = np.random.default_rng(0)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                              (1, GRANITE_CHECK_SEQ)))
        n_k5 = ops.LAUNCHES[k5]
        lg_card = tr.make_prefill_step(cfg32)(model32, tokens.to(dev))[0]
        ops.LAUNCHES[k5] = n_k5
        lg_card = lg_card.cpu()
        model32.cpu()
        lg_cpu = tr.make_prefill_step(cfg32)(model32, tokens)[0]
        err = rel_err(lg_card, lg_cpu)
        print(f"# dryrun granite f32 {GRANITE_CHECK_LAYERS} layers d "
              f"{cfg.d_model} vocab {cfg.vocab}, B 1 S {GRANITE_CHECK_SEQ}: "
              f"card (K5) vs CPU (plain) logits max rel err {err:.3e} "
              f"(tolerance {SERVE_TOLERANCE:.0e})")
        if not err < SERVE_TOLERANCE:
            raise AssertionError(f"granite f32 card vs CPU: {err}")
        del model32
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    t_checks = time.perf_counter()

    # 33c. Each run held to its dry run, and one production cell through
    # the CLI on this install.
    for key, got in runs.items():
        hold_to_dry_run(got, recs[key], card)
    rec = recs["production"]
    row = rec["roofline"]
    print(f"# dryrun production granite-3-2b prefill_32k on (16, 16): "
          f"state {rec['memory']['state_bytes']} B, peak "
          f"{rec['memory']['peak_bytes']} B, ledger by tag "
          f"{json.dumps(rec['collectives']['by_tag'])}; roofline "
          f"{json.dumps(row)}")
    print(f"# phase 33 took {time.perf_counter() - t_phase:.1f} s (host "
          f"clock): smollm and dlrm {t_small - t_phase:.1f} s, granite "
          f"served {t_served - t_small:.1f} s, its K5 and f32 checks "
          f"{t_checks - t_served:.1f} s, the rest holding the runs to their "
          "dry runs")


def _leaves(tree) -> list:
    """The arrays of a nested dict / list of arrays."""
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _leaves(v)]
    return [tree]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    # The disk cache stays off (phase 19 turns it on for itself): a warm
    # cache would read phase 8's graph and schedules from disk.
    import os
    os.environ["REPRO_TORCH_TRACE_CACHE"] = "0"
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import backend, data, params
    from repro_torch.core import conformance
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import edge_aggregate as ea
    from repro_torch.kernels import edge_aggregate_unfused as eu

    dev = backend.resolve_device("cuda")
    t_start = time.perf_counter()

    # 1. device
    card = backend.card_report()
    print(f"# device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # 2. build, with phase 33's dry runs beside it
    t0 = time.perf_counter()
    dry_out, dry_procs = start_dry_runs()
    try:
        out_dir = build.build_all()
    except BaseException:
        for proc in dry_procs.values():
            proc.kill()
        raise
    print(f"# build: {time.perf_counter() - t0:.3f} s into {out_dir}")
    dry_recs = finish_dry_runs(dry_out, dry_procs, t0)
    entries, spills, regs = 0, [], []
    for line in build.build_log().splitlines():
        if "Compiling entry function" in line:
            entries += 1
            entry = line.split("'")[1]
        elif "spill stores" in line and not line.strip().startswith("0 bytes"):
            spills.append(f"{entry}: {line.strip()}")
        elif "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split()[0]))
    print(f"# ptxas: {entries} kernels, registers {min(regs)}-{max(regs)}, "
          f"{len(spills)} with spills")
    for line in spills:
        print(f"#   spill {line}")
    log = build.build_log()
    rows = (k5_ptxas(log) + aggregate_ptxas(log) + combine_ptxas(log)
            + k4_ptxas(log))
    for line in rows:
        print(f"# ptxas {line}")
    spilling = [line for line in rows if " 0 bytes spill stores" not in line]
    if spilling:
        raise AssertionError(f"kernel instances spill: {spilling}")

    # Inputs of the main path: the seeded Cora-sized graph, padded.
    (cora1, cora2) = conformance.cora_operating_points()
    graph = data.cora_graph(seed=0)
    a = torch.as_tensor(graph.dense_adjacency(cora1.K), device=dev)
    x = torch.as_tensor(data.cora_features(seed=0, n_pad=cora1.K), device=dev)
    w1, w2 = params.gcn_combine_weights(params.gcn_params(data.CORA_WIDTHS,
                                                          seed=0), device=dev)
    h1 = torch.relu(ea.fused_aggregate_combine_plain(a, x, w1))
    cora_inputs = {"cora_layer1": (cora1, a, x, w1),
                   "cora_layer2": (cora2, a, h1, w2)}

    # 3. kernels vs plain versions
    gen = torch.Generator().manual_seed(0)
    cases = []
    for n, f, t, bn, bk in TEST_SHAPES:
        ta = (torch.rand(n, n, generator=gen) < 0.02) * torch.rand(
            n, n, generator=gen)
        cases.append((f"shape{n}x{f}x{t}", bn, bk,
                      ta.to(dev), torch.randn(n, f, generator=gen).to(dev),
                      torch.randn(f, t, generator=gen).to(dev)))
    for n, f, t, bn, bk in CLUSTER_SHAPES:
        ta = (torch.rand(n, n, generator=gen) < 0.02) * torch.rand(
            n, n, generator=gen)
        cases.append((f"cluster{n}x{f}x{t}", bn, bk,
                      ta.to(dev), torch.randn(n, f, generator=gen).to(dev),
                      torch.randn(f, t, generator=gen).to(dev)))
    for name, (pt, ca, cx, cw) in cora_inputs.items():
        cases.append((name, pt.Bn, pt.Bk, ca, cx, cw))
    max_abs = {k: 0.0 for k in KERNELS}
    for label, bn, bk, ca, cx, cw in cases:
        for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            va, vx, vw = (v.to(dtype).contiguous() for v in (ca, cx, cw))
            y_plain = eu.aggregate_pass_plain(va, vx)
            checks = {
                "edge_aggregate": (
                    ea.fused_aggregate_combine(va, vx, vw, block_n=bn,
                                               block_k=bk),
                    ea.fused_aggregate_combine_plain(va, vx, vw)),
                "edge_aggregate_unfused.aggregate": (
                    eu.aggregate_pass(va, vx, block_n=bn, block_k=bk),
                    y_plain),
                "edge_aggregate_unfused.combine": (
                    eu.combine_pass(y_plain, vw, block_n=bn),
                    eu.combine_pass_plain(y_plain, vw)),
            }
            torch.cuda.synchronize()
            for kname, (got, expect) in checks.items():
                err = rel_err(got, expect)
                print(f"# check {kname} {label} {key}: max rel err {err:.3e} "
                      f"(tolerance {TOLERANCE[key]:.0e}), max abs err "
                      f"{abs_err(got, expect):.3e}")
                if not err < TOLERANCE[key]:
                    raise AssertionError(f"{kname} disagrees with its plain "
                                         f"version at {label} {key}: {err}")
                if key == "f32" and label.startswith("cora"):
                    max_abs[kname] = max(max_abs[kname], abs_err(got, expect))

    # 4. main path: GCN-Cora forward, fused and unfused, and conformance.
    ops.reset_launches()
    fused = ops.gnn_aggregate_combine(
        a, torch.relu(ops.gnn_aggregate_combine(a, x, w1, block_n=cora1.Bn,
                                                block_k=cora1.Bk)),
        w2, block_n=cora2.Bn, block_k=cora2.Bk)
    agg1 = ops.gnn_aggregate(a, x, block_n=cora1.Bn, block_k=cora1.Bk)
    h1u = torch.relu(ops.gnn_combine(agg1, w1, block_n=cora1.Bn))
    unfused = ops.gnn_combine(
        ops.gnn_aggregate(a, h1u, block_n=cora2.Bn, block_k=cora2.Bk),
        w2, block_n=cora2.Bn)
    records = conformance.run_conformance(device=dev)
    numerics, worst = max(((conformance.verify_numerics(pt, device=dev), pt)
                           for pt in conformance.operating_points()),
                          key=lambda e: e[0])
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in LAYER_KERNELS}
    print(f"# GNN layer path launches: {json.dumps(launches, sort_keys=True)}")
    for kname, count in launches.items():
        if count < 1:
            raise AssertionError(f"{kname} never launched on the GNN layer "
                                 "path")

    expect = ea.fused_aggregate_combine_plain(a, h1, w2)
    for label, got in (("fused", fused), ("unfused", unfused)):
        if got.shape != (cora1.K, data.CORA_WIDTHS[-1]):
            raise AssertionError(f"{label} logits have shape {got.shape}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label} logits are not finite")
        if bool(got[data.CORA_V:].any()):
            raise AssertionError(f"{label} padding rows are not zero")
        err = rel_err(got, expect)
        print(f"# GCN-Cora forward {label}: logits {tuple(got.shape)}, max "
              f"rel err vs plain {err:.3e} (tolerance {TOLERANCE['f32']:.0e})")
        if not err < TOLERANCE["f32"]:
            raise AssertionError(f"{label} forward disagrees: {err}")
    summary = conformance.summarize_records(records)
    print(f"# conformance: {summary['n_ok']}/{summary['n_records']} records "
          f"within tolerance over {len(conformance.operating_points())} "
          f"points; numerics max rel err {numerics:.3e} at K={worst.K} "
          f"N={worst.N} T={worst.T} Bn={worst.Bn} Bk={worst.Bk} (tolerance "
          f"{conformance.NUMERICS_REL_TOL:.0e})")
    if not summary["all_ok"]:
        raise AssertionError("conformance failures: " + "; ".join(
            str(r) for r in records if not r.ok))
    if not numerics < conformance.NUMERICS_REL_TOL:
        raise AssertionError(f"conformance numerics {numerics}")

    # 5. times at each Cora layer, f32 (and bf16 K1, K2 at layer 1).
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
              for k in KERNELS}
    layer_ms = {"fused": 0.0, "unfused": 0.0, "spill_ms": 0.0}
    for label, (pt, ca, cx, cw) in cora_inputs.items():
        K, F, T = pt.K, pt.N, pt.T
        y = eu.aggregate_pass_plain(ca, cx)
        nnz = int(torch.count_nonzero(ca))
        # Each input read once and each output written once; operations are
        # what this data needs: the nonzeros of A, the dense combine.
        work = {
            "edge_aggregate": (4 * (K * K + K * F + F * T + K * T),
                               2 * nnz * F + 2 * K * F * T),
            "edge_aggregate_unfused.aggregate": (4 * (K * K + 2 * K * F),
                                                 2 * nnz * F),
            "edge_aggregate_unfused.combine": (4 * (K * F + F * T + K * T),
                                               2 * K * F * T),
        }
        runs = {
            "edge_aggregate": (
                lambda: ea.fused_aggregate_combine(ca, cx, cw, block_n=pt.Bn,
                                                   block_k=pt.Bk),
                lambda: ea.fused_aggregate_combine_plain(ca, cx, cw),
                lambda: torch.linalg.multi_dot([ca, cx, cw])),
            "edge_aggregate_unfused.aggregate": (
                lambda: eu.aggregate_pass(ca, cx, block_n=pt.Bn,
                                          block_k=pt.Bk),
                lambda: eu.aggregate_pass_plain(ca, cx),
                lambda: torch.matmul(ca, cx)),
            "edge_aggregate_unfused.combine": (
                lambda: eu.combine_pass(y, cw, block_n=pt.Bn),
                lambda: eu.combine_pass_plain(y, cw),
                lambda: torch.matmul(y, cw)),
        }
        for kname, (kernel, plain, library) in runs.items():
            nbytes, nops = work[kname]
            bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
            ops_ms = 1e3 * nops / PEAK_F32_OPS_PER_S
            row = {"ms": time_ms(torch, kernel),
                   "plain_ms": time_ms(torch, plain),
                   "library_ms": time_ms(torch, library),
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bytes_ms": bytes_ms, "ops_ms": ops_ms}
            for k, v in row.items():
                totals[kname][k] += v
            extra = ""
            if kname != "edge_aggregate_unfused.combine":
                extra = ", block-dense bound " + dense_bound(
                    conformance, ea, eu, kname, pt, "f32")
            if kname == "edge_aggregate":
                same = time_ms(torch, lambda: torch.matmul(
                    torch.matmul(ca, cx), cw))
                extra += f", library (A @ X) @ W {same:.4f} ms"
            if kname == "edge_aggregate_unfused.combine":
                extra += (f", {100 * row['bound_ms'] / row['ms']:.1f}% of "
                          "its bound")
            extra += ", " + cluster_fit(build, ea, eu, kname, pt)
            print(f"# time {kname} {label} (K={K} N={F} T={T} Bn={pt.Bn} "
                  f"Bk={pt.Bk}, f32, nnz(A)={nnz}): kernel {row['ms']:.4f} ms"
                  f", plain {row['plain_ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
                  f"ms ({nbytes} B, {nops} op){extra} | {card}")
            if kname == "edge_aggregate":
                layer_ms["fused"] += row["ms"]
            else:
                layer_ms["unfused"] += row["ms"]
        # The spill the unfused pair adds: writeinterphase + readinterphase.
        layer_ms["spill_ms"] += 1e3 * 2 * K * F * 4 / PEAK_BYTES_PER_S
        if label == "cora_layer1":
            va, vx, vw = (v.to(torch.bfloat16).contiguous()
                          for v in (ca, cx, cw))
            for kname, kernel in (
                    ("edge_aggregate", lambda: ea.fused_aggregate_combine(
                        va, vx, vw, block_n=pt.Bn, block_k=pt.Bk)),
                    ("edge_aggregate_unfused.aggregate",
                     lambda: eu.aggregate_pass(va, vx, block_n=pt.Bn,
                                               block_k=pt.Bk))):
                print(f"# time {kname} {label} bf16: kernel "
                      f"{time_ms(torch, kernel):.4f} ms, block-dense bound "
                      f"{dense_bound(conformance, ea, eu, kname, pt, 'bf16')}"
                      f" | {card}")
    k3 = totals["edge_aggregate_unfused.combine"]
    print(f"# time edge_aggregate_unfused.combine, both Cora layers, f32: "
          f"kernel {k3['ms']:.4f} ms, library (matmul) {k3['library_ms']:.4f}"
          f" ms (kernel / library {k3['ms'] / k3['library_ms']:.2f}x), bound "
          f"{k3['bound_ms']:.4f} ms ({100 * k3['bound_ms'] / k3['ms']:.1f}%) "
          f"| {card}")
    print(f"# fused minus unfused, both Cora layers, f32: K2 + K3 - K1 = "
          f"{layer_ms['unfused'] - layer_ms['fused']:.4f} ms against a "
          f"modelled spill of {layer_ms['spill_ms']:.4f} ms "
          f"(writeinterphase + readinterphase at {PEAK_BYTES_PER_S:.3g} B/s)"
          f" | {card}")

    trace_phases(dev, card, launches, max_abs, totals)
    serving_phases(dev, card, launches, max_abs, totals)
    dlrm_phases(dev, card, launches, max_abs, totals)
    figure_phases(dev, card, launches)
    analysis_phase(dev, card)
    typed_phases(dev, card, launches)
    tuned = tune_phase(dev, card)
    served = serve_phase(dev, card, tuned["oracle"])
    for kname in launches:
        launches[kname] += tuned["launches"][kname] + served[kname]
    gemma2_phases(dev, card, launches)
    ogb_edges = bridge_phase(dev, card, launches)
    sharded_phase(dev, card, launches)
    gnn_phase(dev, card, ogb_edges)
    torch.cuda.empty_cache()
    moe_phases(dev, card, launches)
    substrate_phase(dev, card)
    lm_training_phase(dev, card)
    gnn_training_phase(dev, card)
    dlrm_training_phase(dev, card, launches)
    distributed_phase(dev, card, launches, ogb_edges)
    policy_training_phase(dev, card, launches, ogb_edges)
    del ogb_edges
    dryrun_phase(dev, card, launches, dry_recs)

    kernels = []
    for kname, meta in KERNELS.items():
        tot = totals[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[kname],
            "max_abs_err": max_abs[kname], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                         else "operations"),
            "library_ms": tot["library_ms"],
        })
    print(f"# wall time {time.perf_counter() - t_start:.1f} s; K1-K3 times "
          "are sums over the two GCN-Cora layers, f32; K4's over the 16 "
          "capacities of the 10^7-edge sweep (its launches include phase "
          "17's typed path, phases 18-19's tunes and serve windows, "
          "phase 22's trace bridges and phase 23's sharded path); K5's "
          "one layer of the SmolLM-135M prefill, bf16 (its launches: the "
          "SmolLM prefill's, the gemma2-2b prefill's, the qwen3-moe "
          "prefill's, the arctic prefill's, phase 31's sharded SmolLM "
          "prefill's and phase 33's granite-3-2b prefills'); K6's the 26 "
          "tables of one serve_bulk forward of DLRM-MLPerf, f32 (its "
          "launches: the DLRM serving path's, phase 30's training steps', "
          "phase 31's sharded forwards', phase 32's policy training steps' "
          "and phase 33's held serve_bulk forwards')")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
