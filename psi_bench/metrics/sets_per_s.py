"""sets_per_s: client sets answered in the window over the window's
seconds, to the end of its last exchange; host clock."""


def read(run):
    return run.sets_done / run.window_s if run.sets_done and run.window_s > 0 else None
