"""The card's idle time inside the engine's host copies (the spans
`engine.pack`, `engine.upload` and `engine.unpack`), over the slice, in %."""

from bench_h100.spans import idle_share

SPANS = ("tepose:engine.pack", "tepose:engine.upload", "tepose:engine.unpack")


def read(trace, info):
    return idle_share(trace, SPANS)
