"""Median host time of one StreamServer.step on the loop's thread (consume,
stage, enqueue of the hop's launches), from the benchmark's wrapper around
the method, outside the profiled part of the window."""

import numpy as np


def read(record):
    spans = record.spans.get("dispatch")
    return float(np.median(spans) * 1e3) if spans else None
