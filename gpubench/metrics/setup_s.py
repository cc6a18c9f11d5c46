"""Seconds from the process's start to the first step of the window
(host clock): imports, inputs, weights, the program's set-up and the
three checked steps, which warm every shape the window runs."""


def read(run):
    return run["setup_s"]
