"""Median host time of one producer's push_batch of one hop of audio to its
range of streams (the native host AGC and ring write), outside the profiled
part of the window."""

import numpy as np


def read(record):
    spans = record.spans.get("push")
    return float(np.median(spans) * 1e3) if spans else None
