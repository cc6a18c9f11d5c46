"""Nodes in the loss over the window's steps, per second of the window
(host clock, from the first step's launch to the last step's end)."""


def read(run):
    return run["steps"] * run["nodes_per_step"] / run["window_s"]
