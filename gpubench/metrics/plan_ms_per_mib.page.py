"""The reader plan_ms_per_mib, in the 1 MiB cell: there the window's
rate is a per-layer metric (encode_mbps.page), and the layer moves the
call's latency."""

import os

import harness

_BASE = harness.reader_of(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "plan_ms_per_mib")
LAYER, UNIT, SOURCE, SPANS = _BASE.LAYER, _BASE.UNIT, _BASE.SOURCE, _BASE.SPANS
MOVES = "call_p90_ms"
read = _BASE.read
