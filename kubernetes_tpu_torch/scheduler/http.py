"""Health + metrics endpoints for the scheduler process: a copy of
kubernetes_tpu/scheduler/http.py over this package's Registry.

Reference: the scheduler binary serves healthz/readyz/livez and an
authenticated /metrics (app/server.go:169-209,
newHealthEndpointsAndMetricsHandler).  /metrics speaks the Prometheus
text exposition format over the in-process Registry so standard scrapers
ingest it.

One difference from the reference package: /readyz answers 200 only when
the informers have synced AND, where a leader elector is wired, this
replica leads — a standby answers 503 ("not leading"), so a load
balancer or probe in front of replicated schedulers sees exactly one
ready replica.  The reference answers 200 on a synced standby too.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import Counter, Gauge, Histogram, Registry


def render_prometheus(registry: Registry) -> str:
    """Text exposition of every metric in the registry."""
    lines = []
    typed = set()  # one TYPE line per metric family (expfmt requirement)
    for name, metric in sorted(registry.snapshot().items()):
        if isinstance(metric, Histogram):
            # HistogramVec children carry labels in their name
            # (`base{extension_point="..."}`): fold them into each series
            # so the exposition stays valid Prometheus text format.
            base, extra = name, ""
            if "{" in name:
                base, extra = name.split("{", 1)
                extra = extra.rstrip("}") + ","
            if base not in typed:
                typed.add(base)
                lines.append(f"# TYPE {base} histogram")
            acc = 0
            for bound, c in zip(metric.buckets, metric.counts):
                acc += c
                lines.append(f'{base}_bucket{{{extra}le="{bound}"}} {acc}')
            lines.append(f'{base}_bucket{{{extra}le="+Inf"}} {metric.n}')
            suffix = "{" + extra.rstrip(",") + "}" if extra else ""
            lines.append(f"{base}_sum{suffix} {metric.total}")
            lines.append(f"{base}_count{suffix} {metric.n}")
        elif isinstance(metric, (Counter, Gauge)):
            kind = "counter" if isinstance(metric, Counter) else "gauge"
            lines.append(f"# TYPE {name} {kind}")
            with metric._lock:
                items = dict(metric._v)
            if not items:
                lines.append(f"{name} 0")
            for labels, v in sorted(items.items()):
                if labels:
                    lbl = ",".join(
                        f'label{i}="{x}"' for i, x in enumerate(labels)
                    )
                    lines.append(f"{name}{{{lbl}}} {v}")
                else:
                    lines.append(f"{name} {v}")
    return "\n".join(lines) + "\n"


class HealthServer:
    """healthz/readyz/livez + /metrics for one Scheduler."""

    def __init__(self, scheduler, host: str = "127.0.0.1", port: int = 0):
        sched = scheduler

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, body: str, code: int = 200,
                       ctype: str = "text/plain") -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:
                if self.path in ("/healthz", "/livez"):
                    self._reply("ok")
                elif self.path == "/readyz":
                    ready = sched.informers.wait_for_sync(0.01)
                    leader = (
                        sched.leader_elector.is_leader()
                        if sched.leader_elector
                        else True
                    )
                    if not ready:
                        self._reply("informers not synced", 503)
                    elif not leader:
                        self._reply("not leading", 503)
                    else:
                        self._reply(f"ok\nleader: {leader}")
                elif self.path == "/metrics":
                    self._reply(render_prometheus(sched.metrics))
                elif self.path == "/debug/threads":
                    # the pprof goroutine-dump analogue: every thread's
                    # stack, the first tool out of the bag for a hung
                    # scheduler (component-base wires /debug/pprof the
                    # same way)
                    import sys as _sys
                    import traceback

                    names = {
                        t.ident: t.name for t in threading.enumerate()
                    }
                    lines = []
                    for tid, frame in _sys._current_frames().items():
                        lines.append(
                            f"Thread {names.get(tid, '?')} ({tid}):"
                        )
                        lines.extend(
                            ln.rstrip()
                            for ln in traceback.format_stack(frame)
                        )
                        lines.append("")
                    self._reply("\n".join(lines))
                elif self.path.startswith("/debug/profile"):
                    # sampling profile over a short window (pprof's
                    # /debug/pprof/profile?seconds=N): stacks of EVERY
                    # thread sampled at ~100 Hz and aggregated by frame —
                    # a tracing profiler would only see this handler's
                    # thread
                    import sys as _sys
                    import time as _t
                    from collections import Counter
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    seconds = min(float(q.get("seconds", ["2"])[0]), 30.0)
                    me = threading.get_ident()
                    counts: Counter = Counter()
                    samples = 0
                    deadline = _t.monotonic() + seconds
                    while _t.monotonic() < deadline:
                        for tid, frame in _sys._current_frames().items():
                            if tid == me:
                                continue
                            f = frame
                            while f is not None:
                                co = f.f_code
                                counts[
                                    f"{co.co_filename.rsplit('/', 1)[-1]}"
                                    f":{co.co_name}"
                                ] += 1
                                f = f.f_back
                        samples += 1
                        _t.sleep(0.01)
                    lines = [f"samples: {samples} over {seconds}s"]
                    for frame_id, n in counts.most_common(40):
                        lines.append(f"{n / max(samples, 1):7.2%}  {frame_id}")
                    self._reply("\n".join(lines) + "\n")
                else:
                    self._reply("not found", 404)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "HealthServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="scheduler-health", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
