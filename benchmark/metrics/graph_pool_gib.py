"""Layer: protocol/prover.py commit, lcomb and fri (host enqueue).  The
device memory that the pool of the Stark's recorded CUDA graphs holds after
the window (`Stark.graph_pool_bytes()`: the pool's segments in
torch.cuda.memory_snapshot()), in GiB: the working memory of a replayed
prove, which stays in the pool between requests and so is not in a
request's own allocations (`peak_device_gib`).  None where the program keeps
no such pool."""


def read(run):
    held = getattr(getattr(run, "stark", None), "graph_pool_bytes", None)
    value = held() if held is not None else None
    return value / 2 ** 30 if value is not None else None
