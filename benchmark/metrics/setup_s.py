"""setup_s: seconds from the process's start to the window's first step
(the slowest rank's), host clock."""


def read(run):
    return run.setup_s
