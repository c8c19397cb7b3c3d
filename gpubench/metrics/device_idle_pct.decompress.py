"""The reader device_idle_pct.compress, over the decode cell's traced
stretch of whole decompress calls; the layer moves the call's latency."""

import os

import harness

_BASE = harness.reader_of(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "device_idle_pct.compress")
LAYER, UNIT, SOURCE, SPANS = _BASE.LAYER, _BASE.UNIT, _BASE.SOURCE, _BASE.SPANS
MOVES = "call_p90_ms"
read = _BASE.read
