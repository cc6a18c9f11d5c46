"""Models of the port: the decoder-only transformer that serves SmolLM-135M,
gemma2-2b, qwen3-moe-30b-a3b and arctic-480b, with attention through kernel
K5 and MoE layers (``models.moe``) whose routing, capacity dispatch and
expert products are plain PyTorch, as the reference's are XLA; DLRM, with
every embedding bag through kernel K6 (``kernels.ops``); and the GNN models
(``models.gnn``), whose message passing is plain PyTorch, as the
reference's reaches no Pallas kernel."""
