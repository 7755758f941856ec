"""The most device memory one request of the window took above what was
allocated when it began (torch.cuda.max_memory_allocated() after the
request less memory_allocated() before it, the peak reset at its start):
the card a proof of this size needs, whatever the earlier requests left
behind."""


def read(run):
    return max(run.request_peaks) / 2 ** 30 if run.request_peaks else None
