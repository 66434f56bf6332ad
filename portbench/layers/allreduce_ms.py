"""Device milliseconds a traced step of the NCCL all-reduce kernels (their
names hold ``nccl`` and ``AllReduce``), their wait for the peers included:
such a kernel runs from when its card reaches it until every peer's share
has passed through it."""


def read(t):
    ks = t.device_events(("kernel",), lambda n: "nccl" in n.lower() and "allreduce" in n.lower())
    if not ks or not t.n_units:
        return None
    return sum(d["dur"] for d in ks) * 1e-3 / t.n_units
