"""``setup_s``: seconds from the process's start to the window's opening
(imports, the node's start with its kernels' build or load and warm-up,
the peers' start, the bind pass and the closed loop's warm-up); host clock."""


def read(ctx):
    return ctx["setup_s"]
