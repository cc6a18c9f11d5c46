"""The share of the device's busy time in kernels launched under the
program's ``remat.recompute`` span: checkpointed layers' forwards run
again in the backward (:mod:`gpubench.spans`)."""


def read(run):
    s = run.get("spans")
    if s is None or s["busy_s"] <= 0 or "remat.recompute" not in s[
            "device_s"]:
        return None
    return 100.0 * sum(s["device_s"]["remat.recompute"].values()) / s[
        "busy_s"]
