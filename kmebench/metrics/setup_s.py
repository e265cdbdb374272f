"""setup_s: from this process's start to the window's start (imports,
the program's kernels loaded or built, the server up, the preamble and
the warm prefix answered)."""


def read(run):
    return run.setup_s
