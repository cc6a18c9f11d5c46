"""The share of the program's ``step`` spans in which no device event
runs (:mod:`gpubench.spans`): the device's idle time inside the steps,
without the harness's time between them."""


def read(run):
    s = run.get("spans")
    if s is None or s["step_s"] <= 0:
        return None
    return 100.0 * s["step_idle_s"] / s["step_s"]
