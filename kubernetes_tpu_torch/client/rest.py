"""REST client for the API server — the rest.Request analogue
(client-go rest/request.go reduced to the verbs our server speaks).
Returns api.types objects via the wire codec; raises the store's own
exception types on the mapped status codes.

A copy of the reference package's client/rest.py, whole.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, List, Optional, Tuple

from ..api import store as st
from ..api import wire


def _ns_seg(namespace: str) -> str:
    """URL segment for a namespace; cluster-scoped objects (Node) use
    namespace "" which would collapse out of the path — '-' is the
    reserved sentinel the server maps back."""
    return namespace if namespace else "-"


class RestClient:
    def __init__(
        self,
        base_url: str,
        timeout: float = 10.0,
        token: Optional[str] = None,
    ):
        self.base = base_url.rstrip("/")
        self.timeout = timeout
        self.token = token

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    @staticmethod
    def _map_http_error(e: urllib.error.HTTPError):
        try:
            doc = json.load(e)
        except Exception:
            doc = {"error": str(e), "reason": ""}
        exc = {
            "NotFound": st.NotFound,
            "AlreadyExists": st.AlreadyExists,
            "Conflict": st.Conflict,
            "Expired": st.Expired,
        }.get(doc.get("reason"), RuntimeError)
        if exc is RuntimeError and e.code == 410:
            exc = st.Expired
        raise exc(doc.get("error", str(e))) from None

    def _call(self, method: str, path: str, body: Any = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers=self._headers(),
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.load(r)
        except urllib.error.HTTPError as e:
            self._map_http_error(e)

    # -- typed verbs -------------------------------------------------------

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[str] = None,
        field_selector: Optional[str] = None,
    ) -> Tuple[List[Any], int]:
        from urllib.parse import urlencode

        params = {}
        if namespace is not None:
            params["namespace"] = namespace
        if label_selector:
            params["labelSelector"] = label_selector
        if field_selector:
            params["fieldSelector"] = field_selector
        path = f"/api/v1/{kind}"
        if params:
            path += "?" + urlencode(params)
        doc = self._call("GET", path)
        return [wire.from_wire(d) for d in doc["items"]], doc["resourceVersion"]

    def get(self, kind: str, name: str, namespace: str = "default"):
        return wire.from_wire(
            self._call("GET", f"/api/v1/{kind}/{_ns_seg(namespace)}/{name}")
        )

    def create(self, obj: Any):
        kind = obj.KIND
        return wire.from_wire(
            self._call("POST", f"/api/v1/{kind}", wire.to_wire(obj))
        )

    def update(self, obj: Any, force: bool = False):
        kind = obj.KIND
        path = f"/api/v1/{kind}/{_ns_seg(obj.meta.namespace)}/{obj.meta.name}"
        if force:
            path += "?force=1"
        return wire.from_wire(self._call("PUT", path, wire.to_wire(obj)))

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        self._call("DELETE", f"/api/v1/{kind}/{_ns_seg(namespace)}/{name}")

    def patch(
        self,
        kind: str,
        name: str,
        patch: Any,
        namespace: str = "default",
        subresource: Optional[str] = None,
    ):
        """RFC 7386 merge patch; subresource="status" patches only
        .status (the PATCH pods/{name}/status controllers use)."""
        path = f"/api/v1/{kind}/{_ns_seg(namespace)}/{name}"
        if subresource:
            path += f"/{subresource}"
        return wire.from_wire(self._call("PATCH", path, patch))

    def update_status(self, obj: Any):
        """PUT the status subresource: only .status from obj lands."""
        kind = obj.KIND
        path = (
            f"/api/v1/{kind}/{_ns_seg(obj.meta.namespace)}"
            f"/{obj.meta.name}/status"
        )
        return wire.from_wire(self._call("PUT", path, wire.to_wire(obj)))

    def watch(self, kind: str, from_rv: Optional[int] = None):
        """Generator of (type, obj, rv) from the chunked watch stream.

        Error contract: a stale from_rv raises st.Expired up front (the
        410 relist signal), and a stream the SERVER ends (overflowed
        watcher terminated, server restart) raises st.Expired at the end
        — a silent return would freeze a remote reflector on stale state;
        relist-and-rewatch is always the correct reaction.  The read
        timeout is safe because the server emits 1s BOOKMARK keepalives."""
        path = f"/api/v1/watch/{kind}"
        if from_rv is not None:
            path += f"?from_rv={from_rv}"
        req = urllib.request.Request(self.base + path, headers=self._headers())
        try:
            stream = urllib.request.urlopen(
                req, timeout=max(self.timeout, 5.0)
            )
        except urllib.error.HTTPError as e:
            self._map_http_error(e)
        with stream as r:
            for line in r:
                line = line.strip()
                if not line:
                    continue
                doc = json.loads(line)
                if doc["type"] == "BOOKMARK":
                    continue  # idle keepalive frames (watch bookmarks)
                yield doc["type"], wire.from_wire(doc["object"]), doc["rv"]
        raise st.Expired(f"watch stream for {kind} ended; relist and rewatch")
