"""The NCCL kernels' share of the traced steps' device time (an NCCL
kernel's time holds its wait for the slowest rank)."""


def read(ctx):
    dev = ctx.trace.device
    total = sum(d["end"] - d["start"] for d in dev)
    nccl = sum(d["end"] - d["start"] for d in dev
               if "nccl" in d["name"].lower())
    if total <= 0 or ctx.world < 2:
        return None
    return 100.0 * nccl / total
