"""Gathers' and scatters' share of the device's busy time by the program's
own spans: kernel time whose block is message passing (``mp.*``), in any
phase (:mod:`gpubench.spans`)."""


def read(run):
    s = run.get("spans")
    if s is None or s["busy_s"] <= 0:
        return None
    mp = sum(sec for blocks in s["device_s"].values()
             for block, sec in blocks.items() if block.startswith("mp."))
    return 100.0 * mp / s["busy_s"] if mp > 0 else None
