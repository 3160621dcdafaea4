"""setup_s: seconds from the process's start (imports, CUDA, the sets, both
parties' set-up, the server's build, the pool's encryptions, the warm-up)
to the window's start; host clock."""


def read(run):
    return run.setup_s
