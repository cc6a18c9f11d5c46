"""The least time of the traced window's gathers and scatters (the
reference's byte formula on each step's real nodes and edges, at the
card's HBM rate) as a share of their device time."""

from gpubench import peaks


def read(run):
    t = run.get("trace")
    if t is None or t["kinds"]["aggregate"] <= 0:
        return None
    least = run["aggregate_bytes_per_step"] * run["steps"] / (
        peaks.HBM_BYTES_PER_S * run["chips"])
    return 100.0 * least / t["kinds"]["aggregate"]
