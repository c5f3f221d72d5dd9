"""Device milliseconds a traced hop of device-to-device copies: the
outputs cloned out of the graph's memory a call and the state written back
into its buffers."""


def read(record):
    if record.trace is None or not record.counters.get("traced_hops"):
        return None
    spans = [e[3] - e[2] for e in record.trace.events if e[1].startswith("Memcpy DtoD")]
    if not spans:
        return None
    return 1e3 * sum(spans) / record.counters["traced_hops"]
