"""The decode cell's rate: decoded bytes of the traced stretch's calls over
the stretch's wall by the host's clock, without the profiler (the reading
of encode_mbps.page). The window's rate of 16 MiB decodes spread by more
than a bound of 0.25 allows (PERF.md), so it is read here, and the cell's
latency is what it moves."""

import os

import harness

_BASE = harness.reader_of(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "encode_mbps.page")
LAYER, UNIT, SOURCE, SPANS = _BASE.LAYER, _BASE.UNIT, _BASE.SOURCE, _BASE.SPANS
MOVES = "call_p90_ms"
read = _BASE.read
