"""offline_s: seconds of the server's ``run_offline_phase`` (the host cuckoo
insert of its set and the packed table on the device, ending in a
synchronise), timed alone by the harness's host clock."""


def read(run):
    return run.offline_s or None
