"""Dense products' (cuBLAS and CUTLASS GEMM and batched GEMM kernels)
share of the device's busy time."""


def read(run):
    t = run.get("trace")
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * t["kinds"]["dense"] / t["busy_s"]
