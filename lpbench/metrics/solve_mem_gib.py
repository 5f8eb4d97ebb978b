"""Card memory a call needs above its inputs: the allocator's peak over
the window less what was allocated when the window opened, in GiB."""


def read(run):
    return run.mem_window_bytes / 2 ** 30 if run.mem_window_bytes > 0 \
        else None
