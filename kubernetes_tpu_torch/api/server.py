"""The API server: the store's REST + watch surface.

Reference shape (reduced): the generic apiserver's REST endpoints +
watch streams (staging/src/k8s.io/apiserver endpoints/handlers,
watch.go) over the storage layer.  One process-boundary protocol so
out-of-process clients — the CLI, remote controllers, a kube shim — use
the same store the in-process components do:

  GET    /api/v1/{kind}                      list (+ ?namespace= and
                                             ?labelSelector= / ?fieldSelector=)
  GET    /api/v1/{kind}/{ns}/{name}          get
  POST   /api/v1/{kind}                      create (wire-coded body)
  PUT    /api/v1/{kind}/{ns}/{name}          update (optimistic rv;
                                             ?force=1 overrides)
  PUT    /api/v1/{kind}/{ns}/{name}/status   status subresource: only
                                             .status from the body lands
  PATCH  /api/v1/{kind}/{ns}/{name}[/status] RFC 7386 JSON merge patch
  DELETE /api/v1/{kind}/{ns}/{name}          delete
  GET    /api/v1/watch/{kind}?from_rv=N      newline-delimited JSON
                                             event stream (chunked)

Objects travel as api.wire documents (type-tagged dataclass JSON) —
the codec the reference's journal uses.  Errors map to the reference's
status codes: 401/403 authn/authz, 404 NotFound, 409 AlreadyExists/
Conflict, 410 Expired.  Authentication/authorization are optional
constructor hooks (api.auth): bearer tokens -> subjects, allow-list
rules per (subject, verb, kind) — the DefaultBuildHandlerChain slice
(apiserver/pkg/server/config.go:983-1028).

A copy of the reference package's api/server.py without
`APIServerReplicaSet`, which serves one sharded store from several
replicas and waits for the store's shards.
"""

from __future__ import annotations

import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from . import auth as authmod
from . import store as st
from . import wire
from ..testing import faults


def parse_label_selector(expr: str):
    """`a=b,c!=d,e` -> predicate over an object's labels (the
    labels.Parse equality subset + bare-key Exists)."""
    clauses = []
    for raw in expr.split(","):
        raw = raw.strip()
        if not raw:
            continue
        if "!=" in raw:
            k, v = raw.split("!=", 1)
            clauses.append(("!=", k.strip(), v.strip()))
        elif "==" in raw:
            k, v = raw.split("==", 1)
            clauses.append(("=", k.strip(), v.strip()))
        elif "=" in raw:
            k, v = raw.split("=", 1)
            clauses.append(("=", k.strip(), v.strip()))
        else:
            clauses.append(("exists", raw, ""))

    def pred(obj) -> bool:
        labels = obj.meta.labels
        for op, k, v in clauses:
            if op == "=" and labels.get(k) != v:
                return False
            if op == "!=" and labels.get(k) == v:
                return False
            if op == "exists" and k not in labels:
                return False
        return True

    return pred


# fieldSelector paths the reference supports for pods (plus the metadata
# pair every kind has) — dotted wire-field paths resolved on the object
_FIELD_GETTERS = {
    "metadata.name": lambda o: o.meta.name,
    "metadata.namespace": lambda o: o.meta.namespace,
    "spec.nodeName": lambda o: getattr(o.spec, "node_name", ""),
    "status.phase": lambda o: getattr(o.status, "phase", ""),
}


def parse_field_selector(expr: str):
    clauses = []
    for raw in expr.split(","):
        raw = raw.strip()
        if not raw:
            continue
        if "!=" in raw:
            k, v = raw.split("!=", 1)
            op = "!="
        else:
            k, v = raw.split("=", 1)
            op = "="
        getter = _FIELD_GETTERS.get(k.strip())
        if getter is None:
            raise ValueError(f"unsupported fieldSelector {k.strip()!r}")
        clauses.append((op, getter, v.strip()))

    def pred(obj) -> bool:
        for op, getter, v in clauses:
            try:
                actual = str(getter(obj))
            except AttributeError:
                return False
            if op == "=" and actual != v:
                return False
            if op == "!=" and actual == v:
                return False
        return True

    return pred


def merge_patch(base, patch):
    """RFC 7386 JSON merge patch over wire documents: dicts merge
    recursively, null deletes, everything else replaces (the reference's
    application/merge-patch+json handler)."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(base, dict):
        base = {}
    out = dict(base)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = merge_patch(out.get(k), v)
    return out


class _ServingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer + serving-plane accounting: watch-frame
    writes that tripped the per-watcher deadline, the handler threads
    currently inside a request (the chaos suite asserts none stays
    pinned by a dead client), and the open connections — so a replica
    kill can sever live streams the way a process death would."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._stats_lock = threading.Lock()
        self.watch_write_stalls_total = 0
        self._active_handlers = 0
        self._conns: set = set()

    def _note_stall(self) -> None:
        with self._stats_lock:
            self.watch_write_stalls_total += 1

    def _handler_enter(self) -> None:
        with self._stats_lock:
            self._active_handlers += 1

    def _handler_exit(self) -> None:
        with self._stats_lock:
            self._active_handlers -= 1

    def active_handlers(self) -> int:
        """Handler threads currently inside a request (watch streams
        included).  0 at quiesce = no thread pinned by a dead client."""
        with self._stats_lock:
            return self._active_handlers

    # connection tracking: process_request runs on the accept loop,
    # shutdown_request on the worker thread's way out
    def process_request(self, request, client_address):
        with self._stats_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._stats_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self) -> None:
        """Sever every live connection (replica kill): in-flight handler
        threads see their socket die mid-write and tear down through the
        normal stream-teardown path."""
        with self._stats_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass


class _Handler(BaseHTTPRequestHandler):
    store: st.Store  # bound by APIServer
    authn = None     # Optional[auth.TokenAuthenticator]
    authz = None     # Optional[auth.RuleAuthorizer | auth.RBACAuthorizer]
    apf = None       # Optional[flowcontrol.APFGate]
    # a watch frame write blocked past this deadline (stalled TCP
    # consumer: the client stopped reading and the kernel send buffer
    # filled) expires the watch instead of pinning the handler thread
    watch_write_deadline = 10.0
    # test knob: shrink the kernel send buffer so a stalled client's
    # backpressure surfaces after KBs of buffered frames, not MBs
    watch_sndbuf: Optional[int] = None
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    # -- helpers -----------------------------------------------------------

    def _authorize(self, verb: str, kind: str, namespace: str = "") -> bool:
        """authn -> flow-control -> authz gate; replies 401/429/403 and
        returns False on rejection.  healthz stays open (the reference
        exempts health endpoints before the chain).  The APF seat, once
        acquired, is released by the do_* wrapper's finally — except for
        watches, which release it as soon as the stream is established
        (_watch) so long-lived streams can't pin seats."""
        faults.fire("server.request", verb=verb, kind=kind)
        subject = authmod.ANONYMOUS
        if self.authn is not None:
            subject = self.authn.authenticate(
                self.headers.get("Authorization")
            )
            if subject is None:
                self._reply({"error": "unauthorized",
                             "reason": "Unauthorized"}, 401)
                return False
        if self.apf is not None and self._apf_seat is None:
            seat = self.apf.acquire(subject, verb)
            if seat is None:
                # shed: Retry-After widens with the gate's adaptive
                # pressure so rejected clients back off harder the
                # deeper the overload (static gates report 1s)
                retry = max(
                    1, int(getattr(self.apf, "retry_after_s", lambda: 1.0)())
                )
                data = json.dumps(
                    {"error": "too many requests", "reason": "TooManyRequests"}
                ).encode()
                self.send_response(429)
                self.send_header("Retry-After", str(retry))
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return False
            self._apf_seat = seat
        if self.authz is not None and not self.authz.allowed(
            subject, verb, kind, namespace
        ):
            self._reply(
                {"error": f"{subject.name} cannot {verb} {kind}"
                 + (f" in {namespace!r}" if namespace else ""),
                 "reason": "Forbidden"},
                403,
            )
            return False
        return True

    # every request handler runs inside this wrapper so an acquired APF
    # seat is always released, whatever path the verb takes
    def handle_one_request(self):  # noqa: N802 (stdlib name)
        self._apf_seat = None
        srv = self.server
        track = isinstance(srv, _ServingHTTPServer)
        if track:
            srv._handler_enter()
        try:
            super().handle_one_request()
        finally:
            if self._apf_seat is not None:
                self._apf_seat.release()
                self._apf_seat = None
            if track:
                srv._handler_exit()

    def _reply(self, obj, code: int = 200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, exc: Exception) -> None:
        code = (
            404 if isinstance(exc, st.NotFound)
            else 409 if isinstance(exc, (st.AlreadyExists, st.Conflict))
            else 410 if isinstance(exc, st.Expired)
            else 400
        )
        self._reply({"error": str(exc), "reason": type(exc).__name__}, code)

    def _parts(self):
        parsed = urlparse(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        return parts, parse_qs(parsed.query)

    # -- verbs -------------------------------------------------------------

    def do_GET(self) -> None:
        parts, q = self._parts()
        try:
            if len(parts) >= 3 and parts[:2] == ["api", "v1"]:
                if parts[2] == "watch" and len(parts) == 4:
                    if not self._authorize("watch", parts[3]):
                        return
                    return self._watch(parts[3], q)
                if len(parts) == 3:
                    namespace = q.get("namespace", [None])[0]
                    if not self._authorize("list", parts[2], namespace or ""):
                        return
                    preds = []
                    if q.get("labelSelector"):
                        preds.append(
                            parse_label_selector(q["labelSelector"][0])
                        )
                    if q.get("fieldSelector"):
                        preds.append(
                            parse_field_selector(q["fieldSelector"][0])
                        )
                    selector = (
                        (lambda o: all(p(o) for p in preds)) if preds
                        else None
                    )
                    items, rv = self.store.list(
                        parts[2], namespace=namespace, selector=selector
                    )
                    return self._reply(
                        {
                            "items": [wire.to_wire(o) for o in items],
                            "resourceVersion": rv,
                        }
                    )
                if len(parts) == 5:
                    ns = "" if parts[3] == "-" else parts[3]
                    if not self._authorize("get", parts[2], ns):
                        return
                    obj = self.store.get(parts[2], parts[4], ns)
                    return self._reply(wire.to_wire(obj))
            if parts == ["api", "v1"]:
                # discovery (the APIResourceList kubectl uses to map
                # names) rides the full chain like any read — only
                # healthz/readyz are exempt
                if not self._authorize("get", "APIResourceList"):
                    return
                from . import kubeyaml

                kinds = sorted(
                    set(self.store.kinds()) | set(kubeyaml.CONVERTERS)
                )
                return self._reply({
                    "kind": "APIResourceList",
                    "groupVersion": "v1",
                    "resources": [
                        {
                            "kind": k,
                            "verbs": ["get", "list", "watch", "create",
                                      "update", "patch", "delete"],
                        }
                        for k in kinds
                    ],
                })
            if parts == ["healthz"] or parts == ["readyz"]:
                return self._reply({"ok": True})
            if parts == ["metrics"]:
                # metrics go through the full chain like any resource
                # (the reference grants system:monitoring via authz —
                # only healthz/readyz are exempt)
                if not self._authorize("get", "metrics"):
                    return
                body = self.apf.metrics() if self.apf is not None else ""
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            self._reply({"error": f"unknown path {self.path}"}, 404)
        except Exception as e:
            self._error(e)

    def do_POST(self) -> None:
        parts, _ = self._parts()
        try:
            if len(parts) == 3 and parts[:2] == ["api", "v1"]:
                obj = wire.from_wire(self._body())
                ns = getattr(obj.meta, "namespace", "") or ""
                if not self._authorize("create", parts[2], ns):
                    return
                created = self.store.create(obj)
                return self._reply(wire.to_wire(created), 201)
            self._reply({"error": f"unknown path {self.path}"}, 404)
        except Exception as e:
            self._error(e)

    def do_PUT(self) -> None:
        parts, q = self._parts()
        try:
            if (
                len(parts) == 6
                and parts[:2] == ["api", "v1"]
                and parts[5] == "status"
            ):
                # status subresource: only .status from the body lands —
                # spec edits through this path are dropped (the
                # StatusStrategy PrepareForUpdate contract,
                # registry/core/pod/strategy.go podStatusStrategy)
                ns = "" if parts[3] == "-" else parts[3]
                if not self._authorize("update", parts[2], ns):
                    return
                incoming = wire.from_wire(self._body())
                current = self.store.get(parts[2], parts[4], ns)
                current.status = incoming.status
                updated = self.store.update(current)
                return self._reply(wire.to_wire(updated))
            if len(parts) == 5 and parts[:2] == ["api", "v1"]:
                ns = "" if parts[3] == "-" else parts[3]
                if not self._authorize("update", parts[2], ns):
                    return
                obj = wire.from_wire(self._body())
                force = q.get("force", ["0"])[0] == "1"
                updated = self.store.update(obj, force=force)
                return self._reply(wire.to_wire(updated))
            self._reply({"error": f"unknown path {self.path}"}, 404)
        except Exception as e:
            self._error(e)

    def do_PATCH(self) -> None:
        """RFC 7386 merge patch on the object's wire document (or its
        status subresource) — endpoints/handlers/patch.go reduced to the
        merge-patch content type."""
        parts, _ = self._parts()
        try:
            is_status = (
                len(parts) == 6
                and parts[:2] == ["api", "v1"]
                and parts[5] == "status"
            )
            if (len(parts) == 5 or is_status) and parts[:2] == ["api", "v1"]:
                ns = "" if parts[3] == "-" else parts[3]
                if not self._authorize("patch", parts[2], ns):
                    return
                patch = self._body()
                if not isinstance(patch, dict):
                    return self._reply(
                        {"error": "merge patch body must be a JSON object",
                         "reason": "BadRequest"},
                        400,
                    )
                current = self.store.get(parts[2], parts[4], ns)
                doc = wire.to_wire(current)
                if is_status:
                    patch = {"status": patch.get("status", patch)}
                merged = merge_patch(doc, patch)
                obj = wire.from_wire(merged)
                # the patch applies to what was READ: keep its rv so a
                # concurrent writer surfaces as 409, not silent clobber
                obj.meta.resource_version = current.meta.resource_version
                updated = self.store.update(obj)
                return self._reply(wire.to_wire(updated))
            self._reply({"error": f"unknown path {self.path}"}, 404)
        except Exception as e:
            self._error(e)

    def do_DELETE(self) -> None:
        parts, _ = self._parts()
        try:
            if len(parts) == 5 and parts[:2] == ["api", "v1"]:
                ns = "" if parts[3] == "-" else parts[3]
                if not self._authorize("delete", parts[2], ns):
                    return
                self.store.delete(parts[2], parts[4], ns)
                return self._reply({"deleted": True})
            self._reply({"error": f"unknown path {self.path}"}, 404)
        except Exception as e:
            self._error(e)

    def _body(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def _watch(self, kind: str, q) -> None:
        """Newline-delimited JSON watch stream (endpoints/handlers/
        watch.go's chunked frames).  Ends when the client disconnects or
        the store terminates the watch."""
        # The APF seat gates watch INITIALIZATION only (the reference's
        # apf_filter.go forgetWatch): a seat held for the stream's whole
        # lifetime would let N long-lived watches from one priority level
        # permanently exhaust its N seats and 429 every later request in
        # that class.  Release it here; handle_one_request's finally sees
        # None and won't double-release.
        if self._apf_seat is not None:
            self._apf_seat.release()
            self._apf_seat = None
        from_rv = q.get("from_rv", [None])[0]
        w = self.store.watch(kind, int(from_rv) if from_rv else None)
        if self.watch_sndbuf:
            self.connection.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDBUF, int(self.watch_sndbuf)
            )
        # the per-watcher write deadline: a send that cannot make
        # progress for this long (client stopped reading, kernel send
        # buffer full) raises socket.timeout instead of parking the
        # thread forever — the 1s bookmark keepalive guarantees a
        # stalled stream reaches a blocked write within ~1 frame
        self.connection.settimeout(self.watch_write_deadline)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def frame(payload: bytes) -> None:
            action = faults.fire(
                "server.watch.write", kind=kind, size=len(payload)
            )
            if isinstance(action, faults.TornWrite):
                # a PREFIX of the chunk, then die mid-frame: the client
                # sees a truncated chunk on a dropped connection
                part = payload[: max(1, int(len(payload) * action.frac))]
                self.wfile.write(f"{len(payload):x}\r\n".encode())
                self.wfile.write(part)
                self.wfile.flush()
                raise OSError("injected mid-frame disconnect")
            self.wfile.write(f"{len(payload):x}\r\n".encode())
            self.wfile.write(payload + b"\r\n")
            self.wfile.flush()

        try:
            while True:
                ev = w.get(timeout=1.0)
                if w.stopped:
                    break
                if ev is None:
                    # idle keepalive (the watch-bookmark pattern): the
                    # write is how a dead client surfaces — without it an
                    # idle watch leaks its thread + store registration
                    frame(
                        (json.dumps({"type": "BOOKMARK",
                                     "rv": self.store.resource_version})
                         + "\n").encode()
                    )
                    continue
                doc = {
                    "type": ev.type,
                    "kind": ev.kind,
                    "rv": ev.rv,
                    "object": wire.to_wire(ev.obj),
                }
                frame((json.dumps(doc) + "\n").encode())
        except socket.timeout:
            # stalled TCP consumer: the write deadline tripped.  Expire
            # the watch (bookmark rv recorded, consumer relists on
            # reconnect — counted in watch_expired_total) and free the
            # handler thread; a dead client must never pin it.
            srv = self.server
            if isinstance(srv, _ServingHTTPServer):
                srv._note_stall()
            with w._mu:
                w._expire_locked()
            self.store._retire_expired_watch(w, kind)
            self.close_connection = True
            # drop the socket NOW: the buffered writer must not block
            # another deadline's worth flushing into a full send buffer
            # (the finally's terminal chunk + stdlib close both write)
            try:
                self.connection.close()
            except OSError:
                pass
        except Exception:
            # after headers are sent there is no sane error response —
            # any write/socket failure (BrokenPipe, ConnectionAborted,
            # arbitrary OSError) just tears the stream down; letting it
            # escape would make do_GET write a fresh status line into the
            # middle of a chunked body
            pass
        finally:
            w.stop()
            try:
                self.wfile.write(b"0\r\n\r\n")
            except Exception:
                pass


class APIServer:
    """Threaded HTTP server exposing one Store.

    authn/authz: optional api.auth.TokenAuthenticator /
    api.auth.RuleAuthorizer — None keeps the surface open (the
    --anonymous-auth development posture)."""

    def __init__(
        self,
        store: st.Store,
        host: str = "127.0.0.1",
        port: int = 0,
        authn=None,
        authz=None,
        apf=None,  # flowcontrol.APFGate, or an APF config dict/YAML/path
        watch_write_deadline: float = 10.0,
        watch_sndbuf: Optional[int] = None,
    ):
        if apf is not None and not hasattr(apf, "acquire"):
            # config-shaped apf (dict / YAML string / file path): the
            # per-level seat knobs are deployment configuration, not
            # code — build the gate here (flowcontrol.APFGate.from_config)
            from . import flowcontrol

            apf = flowcontrol.APFGate.from_config(apf)
        self.apf = apf
        handler = type(
            "BoundHandler", (_Handler,),
            {
                "store": store, "authn": authn, "authz": authz, "apf": apf,
                "watch_write_deadline": watch_write_deadline,
                "watch_sndbuf": watch_sndbuf,
            },
        )
        self.httpd = _ServingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def watch_write_stalls_total(self) -> int:
        return self.httpd.watch_write_stalls_total

    def start(self) -> "APIServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="apiserver", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

