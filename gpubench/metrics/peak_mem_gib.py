"""``torch.cuda.max_memory_allocated`` over set-up and window, GiB."""


def read(run):
    if run.get("peak_bytes") is None:
        return None
    return run["peak_bytes"] / 2 ** 30
