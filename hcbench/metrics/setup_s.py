"""setup_s: from the process's start to the window's (the program's build
and compilation, the data, the engine, the warm-up)."""


def read(run):
    return run["setup_s"]
