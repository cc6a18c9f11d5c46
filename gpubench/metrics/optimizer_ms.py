"""Device milliseconds a step of kernels launched under the program's
``step.update`` span: the optimizer's update and its application
(:mod:`gpubench.spans`)."""


def read(run):
    s = run.get("spans")
    if s is None or not s["steps"] or "step.update" not in s["device_s"]:
        return None
    return 1e3 * sum(s["device_s"]["step.update"].values()) / s["steps"]
