"""Device milliseconds a traced hop in kernels other than the port's own
CUDA kernels (the VQT, the peaks and the ring push): the analysis core, the
output stages and the glue between them, in PyTorch's kernels. Copies and
fills are left out."""

OWN = ("vqt_kernel", "peaks_kernel", "ring_push_kernel")


def read(record):
    if record.trace is None or not record.counters.get("traced_hops"):
        return None
    spans = [e[3] - e[2] for e in record.trace.kernels() if not any(k in e[1] for k in OWN)]
    if not spans:
        return None
    return 1e3 * sum(spans) / record.counters["traced_hops"]
