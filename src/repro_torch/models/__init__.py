"""Models of the port: the dense decoder-only transformer that serves
SmolLM-135M, with attention through kernel K5, and DLRM, with every
embedding bag through kernel K6 (``kernels.ops``)."""
