"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the window
(reset after set-up), in GiB."""


def read(run):
    if run.window_peak <= 0:
        return None
    return run.window_peak / 2 ** 30
