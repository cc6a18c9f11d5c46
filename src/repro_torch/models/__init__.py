"""Models of the port: the dense decoder-only transformer that serves
SmolLM-135M, with attention through kernel K5 (``kernels.ops``)."""
