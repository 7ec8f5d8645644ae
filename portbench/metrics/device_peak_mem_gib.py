"""Peak device memory the process allocated up to the window's close
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30
