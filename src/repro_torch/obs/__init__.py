"""repro_torch.obs — observability for the secure serving stack
(DESIGN.md §13), the counterpart of `repro.obs`.

Three independent pieces, composable or standalone:

  * `TraceRecorder` (trace.py): structured per-request span trees,
    deterministic under `VirtualClock`, exported as Chrome-trace JSON
    or a structured event log.
  * `MetricsRegistry` (metrics.py): counters/gauges/histograms with
    Prometheus text exposition.
  * `KernelProfiler` / `profile_kernels` (profiler.py): opt-in
    timing of the kernel entry points, with CUDA events on the card and
    the host clock for CPU tensors.

`Observability` bundles all three with one clock, which is what a
service threads through the runtime.  Everything
is disabled-by-default at the call sites: a collection with no tracer
and no metrics attached records nothing and pays (nearly) nothing.
"""

from __future__ import annotations

import json
import threading

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_LATENCY_BUCKETS)
from .profiler import (KernelProfiler, active_profiler, instrument,
                       profile_kernels)
from .trace import (NULL_RECORDER, NullRecorder, Span, TraceRecorder,
                    child_complete, child_span, current)

__all__ = [
    "Observability", "start_metrics_server",
    "TraceRecorder", "NullRecorder", "NULL_RECORDER", "Span",
    "child_span", "child_complete", "current",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_LATENCY_BUCKETS",
    "KernelProfiler", "profile_kernels", "instrument", "active_profiler",
]


class Observability:
    """One recorder + one registry + one profiler sharing one clock.

    clock: the runtime `Clock` the schedulers run on (None = wall
    time).  Using the same instance keeps span timestamps, telemetry
    windows, and test virtual time on a single timeline.
    """

    def __init__(self, clock=None, trace_capacity: int = 8192):
        self.clock = clock
        self.recorder = TraceRecorder(clock=clock,
                                      capacity=trace_capacity)
        self.metrics = MetricsRegistry()
        self.profiler = KernelProfiler()

    # convenience passthroughs -------------------------------------

    def metrics_text(self) -> str:
        return self.metrics.prometheus_text()

    def chrome_trace(self) -> dict:
        return self.recorder.to_chrome_trace()

    def export_chrome_trace(self, path) -> str:
        """Write Perfetto-loadable JSON; returns the path written."""
        payload = json.dumps(self.chrome_trace(), indent=1)
        with open(path, "w") as fh:
            fh.write(payload + "\n")
        return str(path)

    def events(self) -> list[dict]:
        return self.recorder.to_events()


def start_metrics_server(source, port: int, host: str = ""):
    """Serve `source.metrics_text()` (an `Observability`, a
    `MetricsRegistry`-like object, or anything with that method) at
    http://host:port/metrics on a daemon thread.  Returns the
    `HTTPServer`; call `.shutdown()` to stop.  Port 0 picks a free
    port (read it back from `server.server_address[1]`)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):                           # noqa: N802
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = source.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                  # silence stderr
            pass

    server = ThreadingHTTPServer((host, int(port)), _Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="obs-metrics", daemon=True)
    thread.start()
    server._obs_thread = thread
    return server
