"""The k-NN searches of a training step's neighbour index alone
(``csrc/knn.cu`` through ``ops/kernels/knn.py::knn``, layer ``k.knn``, at
the batch's 24 frames): their least time on their inputs over their
device time in the traced steps.  The work counts 8 operations a
query-candidate pair and the coordinates and indices once
(``perfbench/work_ffb6d.py::knn_work``).  A program without the search
reads nothing."""


def read(ctx):
    return ctx.roofline_pct(["k.knn"])
