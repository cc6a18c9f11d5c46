"""Hand-written CUDA kernels of the port, their geometry and plain versions.

Importing this package builds nothing: the CUDA sources under
``repro_torch/csrc`` are compiled by :mod:`.build` on the first launch.
"""
