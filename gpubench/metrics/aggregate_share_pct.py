"""Gathers' and scatters' share of the device's busy time."""


def read(run):
    t = run.get("trace")
    if t is None or t["busy_s"] <= 0 or t["kinds"]["aggregate"] <= 0:
        return None
    return 100.0 * t["kinds"]["aggregate"] / t["busy_s"]
