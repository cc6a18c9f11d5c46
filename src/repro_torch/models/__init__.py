"""Models of the port: the dense decoder-only transformer that serves
SmolLM-135M and gemma2-2b, with attention through kernel K5; DLRM, with
every embedding bag through kernel K6 (``kernels.ops``); and the GNN
models (``models.gnn``), whose message passing is plain PyTorch, as the
reference's reaches no Pallas kernel."""
