"""The card's idle time inside the engine's VIBE bootstrap and window scan
(the spans `engine.boot` and `engine.scan`), over the slice, in %."""

from bench_h100.spans import idle_share

SPANS = ("tepose:engine.boot", "tepose:engine.scan")


def read(trace, info):
    return idle_share(trace, SPANS)
