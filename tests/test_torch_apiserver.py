"""The API server and its REST client in the port against the reference
package's.

kubernetes_tpu_torch/api/server.py (`APIServer`: CRUD, the status
subresource, merge patch, list selectors, watch with bookmarks and 410,
discovery, authn/authz), api/wire.py and client/rest.py (`RestClient`,
its error mapping to the store's NotFound, AlreadyExists, Conflict and
Expired) against kubernetes_tpu/'s, on the same requests:
tests/test_apiserver_cli.py's cases that need no CLI (the CRUD round
trip, the error mapping, the watch stream, cluster-scoped objects, idle
bookmarks, 410 on a stale rv) and tests/test_api_hardening.py's (merge
patch, patch and put on status, the patch conflict, list selectors, the
parsers, authn/authz, `==` selectors), each run on both packages.  Each
case records status codes (or the client's error class and message),
the decoded objects as wire documents (without the uid and the creation
time a run draws) and resourceVersions, and the two transcripts are
equal.  One more test holds the port's api/types.py to the reference's:
every class, with the same field names, defaults and KIND.

Every wait is a bounded poll of at most 2 s on an event the case caused.
"""

import dataclasses
import inspect
import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from kubernetes_tpu.api import auth as jauth
from kubernetes_tpu.api import server as jserver
from kubernetes_tpu.api import store as jst
from kubernetes_tpu.api import types as japi
from kubernetes_tpu.api import wire as jwire
from kubernetes_tpu.client.rest import RestClient as JRestClient
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.api import auth as tauth
from kubernetes_tpu_torch.api import server as tserver
from kubernetes_tpu_torch.api import store as tst
from kubernetes_tpu_torch.api import types as tapi
from kubernetes_tpu_torch.api import wire as twire
from kubernetes_tpu_torch.client.rest import RestClient as TRestClient
from kubernetes_tpu_torch.testing import wrappers as tw

PORT = SimpleNamespace(name="port", st=tst, api=tapi, wire=twire, auth=tauth, server=tserver,
                       RestClient=TRestClient, w=tw, store_kw={})
REF = SimpleNamespace(name="reference", st=jst, api=japi, wire=jwire, auth=jauth,
                      server=jserver, RestClient=JRestClient, w=jw, store_kw={"shards": 1})
WAIT_S = 2.0


def _on_both(case):
    return case(PORT), case(REF)


def _poll(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return bool(cond())


def _drawn_out(doc):
    """A wire document without what a run draws: every ObjectMeta's uid
    and creation time, nested ones (a template's) included."""
    if isinstance(doc, dict):
        return {k: _drawn_out(v) for k, v in doc.items()
                if not (doc.get("__t") == "ObjectMeta" and k in ("uid", "creation_timestamp"))}
    if isinstance(doc, list):
        return [_drawn_out(v) for v in doc]
    return doc


def _doc(pkg, obj):
    return _drawn_out(pkg.wire.to_wire(obj))


def _try(pkg, fn):
    """("ok", the result's document) or (error class, message)."""
    try:
        out = fn()
    except Exception as exc:  # noqa: BLE001 — the transcript records it
        return type(exc).__name__, str(exc)
    return "ok", _doc(pkg, out) if hasattr(out, "meta") else out


def _serve(pkg, case, store=None, **kw):
    """case(store, server, client) against an APIServer over a fresh
    store (or `store`); stops the server and closes the store."""
    store = store if store is not None else pkg.st.Store(**pkg.store_kw)
    srv = pkg.server.APIServer(store, **kw).start()
    try:
        return case(store, srv, pkg.RestClient(srv.url))
    finally:
        srv.stop()
        store.close()


def _http(url, method="GET", body=None, token=None):
    """(status, decoded body) of one raw request."""
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"null")


# -- tests/test_apiserver_cli.py (the cases without the CLI) ----------------------


def _crud(pkg):
    def case(store, srv, client):
        pod = pkg.w.make_pod("p").req(cpu_milli=500, mem=pkg.w.GI).label("app", "x").obj()
        created = client.create(pod)
        got = client.get("Pod", "p")
        out = [_doc(pkg, created), got == created]
        got.spec.node_name = "n0"
        updated = client.update(got)
        items, rv = client.list("Pod")
        out += [_doc(pkg, updated), [_doc(pkg, o) for o in items], rv]
        client.delete("Pod", "p")
        out.append(_try(pkg, lambda: client.get("Pod", "p")))
        out.append(_http(f"{srv.url}/api/v1/Pod/default/p"))
        out.append(_http(f"{srv.url}/healthz"))
        out.append(_http(f"{srv.url}/nowhere"))
        return out

    return _serve(pkg, case)


def _error_mapping(pkg):
    def case(store, srv, client):
        out = [_try(pkg, lambda: client.get("Pod", "missing"))]
        pod = pkg.w.make_pod("dup").obj()
        client.create(pod)
        out.append(_try(pkg, lambda: client.create(pod)))
        stale = client.get("Pod", "dup")
        client.update(stale)  # bumps rv
        out.append(_try(pkg, lambda: client.update(stale)))
        out.append(_try(pkg, lambda: client.update(stale, force=True)))
        out.append(_http(f"{srv.url}/api/v1/Pod", "POST", {"__t": "Nope"}))
        return out

    return _serve(pkg, case)


def _watch_stream(pkg):
    def case(store, srv, client):
        _, rv = client.list("Pod")
        got = []

        def consume():
            for typ, obj, ev_rv in client.watch("Pod", from_rv=rv):
                got.append((typ, obj.meta.name, ev_rv))
                if len(got) >= 2:
                    break

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        assert _poll(lambda: store._watchers.get("Pod"))
        store.create(pkg.w.make_pod("w1").obj())
        # the ADDED crosses the wire before the delete: an unconsumed
        # ADDED+DELETED pair annihilates in the watcher's coalescing buffer
        assert _poll(lambda: len(got) >= 1)
        store.delete("Pod", "w1")
        t.join(timeout=WAIT_S)
        return got

    return _serve(pkg, case)


def _cluster_scoped(pkg):
    def case(store, srv, client):
        node = pkg.w.make_node("n0").capacity(cpu_milli=4000, mem=8 * pkg.w.GI).obj()
        out = [_doc(pkg, client.create(node))]
        got = client.get("Node", "n0", namespace="")
        got.meta.labels["x"] = "y"
        out.append(_doc(pkg, client.update(got)))
        out.append(client.get("Node", "n0", namespace="").meta.labels)
        out.append(_http(f"{srv.url}/api/v1/Node/-/n0")[0])
        client.delete("Node", "n0", namespace="")
        out.append(_try(pkg, lambda: client.get("Node", "n0", namespace="")))
        return out

    return _serve(pkg, case)


def _bookmarks(pkg):
    def case(store, srv, client):
        req = urllib.request.Request(srv.url + "/api/v1/watch/Lease")
        with urllib.request.urlopen(req, timeout=5) as r:
            doc = json.loads(r.readline())
        return [doc["type"], doc["rv"] == store.resource_version]

    return _serve(pkg, case)


def _stale_rv(pkg):
    def case(store, srv, client):
        for i in range(50):
            store.create(pkg.w.make_pod(f"x{i}").obj())
        out = [_http(f"{srv.url}/api/v1/watch/Pod?from_rv=1")]

        def first():
            for _ in client.watch("Pod", from_rv=1):
                break

        out.append(_try(pkg, first))
        return out

    return _serve(pkg, case, store=pkg.st.Store(buffer_size=8, **pkg.store_kw))


def _discovery(pkg):
    def case(store, srv, client):
        store.create(pkg.w.make_pod("p").obj())
        store.create(pkg.api.ConfigMap(meta=pkg.api.ObjectMeta(name="c")))
        return [_http(f"{srv.url}/api/v1"), _http(f"{srv.url}/readyz"),
                _http(f"{srv.url}/metrics")[0]]

    return _serve(pkg, case)


SERVER_CASES = {
    "rest_crud_roundtrip": _crud,
    "rest_error_mapping": _error_mapping,
    "rest_watch_stream": _watch_stream,
    "cluster_scoped_objects_addressable": _cluster_scoped,
    "idle_watch_gets_bookmarks": _bookmarks,
    "watch_raises_expired_on_stale_rv": _stale_rv,
    "discovery_and_health": _discovery,
}


@pytest.mark.parametrize("case", sorted(SERVER_CASES))
def test_apiserver_matches_reference(case):
    """tests/test_apiserver_cli.py's cases without the CLI, on both
    packages: create/get/update/list/delete over REST, the status codes
    and the client's error classes (404 NotFound, 409 AlreadyExists and
    Conflict, 400), the watch stream's ADDED and DELETED, a cluster-scoped
    object through the '-' namespace, the idle watch's BOOKMARK, 410 on a
    from_rv the event ring no longer holds, and discovery (the store's
    kinds and kubeyaml's converters), healthz, readyz and /metrics."""
    got, want = _on_both(SERVER_CASES[case])
    assert got == want


def test_apiserver_transcripts_hold_the_reference_contract():
    crud = _crud(PORT)
    assert crud[1] and crud[4] == 2 and crud[5][0] == "NotFound"
    assert [c for c, _ in crud[6:]] == [404, 200, 404]
    errors = _error_mapping(PORT)
    assert [e[0] for e in errors[:3]] == ["NotFound", "AlreadyExists", "Conflict"]
    assert errors[3][0] == "ok" and errors[4][0] == 400
    assert [(t, n) for t, n, _ in _watch_stream(PORT)] == [("ADDED", "w1"), ("DELETED", "w1")]
    assert _bookmarks(PORT) == ["BOOKMARK", True]
    stale = _stale_rv(PORT)
    assert stale[0][0] == 410 and stale[1][0] == "Expired"
    kinds = {r["kind"] for r in _discovery(PORT)[0][1]["resources"]}
    assert {"Pod", "ConfigMap", "Deployment", "Node"} <= kinds


# -- tests/test_api_hardening.py ---------------------------------------------------


def _merge_patch(pkg):
    base = {"a": {"b": 1, "c": 2}, "d": [1, 2], "e": "x"}
    patch = {"a": {"b": 9, "c": None}, "d": [3]}
    return [pkg.server.merge_patch(base, patch), pkg.server.merge_patch(base, [1]),
            pkg.server.merge_patch("s", {"k": None, "j": 1}), base]


def _patch_labels(pkg):
    def case(store, srv, client):
        store.create(pkg.w.make_pod("p").labels(app="web").obj())
        got = client.patch("Pod", "p", {"meta": {"labels": {"tier": "front"}}})
        return [_doc(pkg, got), store.get("Pod", "p").meta.labels,
                _http(f"{srv.url}/api/v1/Pod/default/p", "PATCH", [1])]

    return _serve(pkg, case)


def _patch_status(pkg):
    def case(store, srv, client):
        store.create(pkg.w.make_pod("p").req(cpu_milli=100).obj())
        client.patch("Pod", "p", {"status": {"phase": "Running"},
                                  "spec": {"node_name": "sneaky"}}, subresource="status")
        got = store.get("Pod", "p")
        return [got.status.phase, got.spec.node_name, got.meta.resource_version]

    return _serve(pkg, case)


def _put_status(pkg):
    def case(store, srv, client):
        store.create(pkg.w.make_pod("p").obj())
        obj = client.get("Pod", "p")
        obj.status.phase = "Failed"
        obj.spec.node_name = "sneaky"
        got = client.update_status(obj)
        return [_doc(pkg, got), store.get("Pod", "p").spec.node_name]

    return _serve(pkg, case)


def _patch_conflict(pkg):
    def case(store, srv, client):
        store.create(pkg.w.make_pod("p").obj())
        obj = client.get("Pod", "p")
        obj2 = client.get("Pod", "p")
        obj.meta.labels["a"] = "1"
        out = [client.update(obj).meta.resource_version]
        obj2.meta.labels["b"] = "2"
        out.append(_try(pkg, lambda: client.update(obj2)))
        return out

    return _serve(pkg, case)


def _list_selectors(pkg):
    def case(store, srv, client):
        store.create(pkg.w.make_pod("w1").labels(app="web").obj())
        store.create(pkg.w.make_pod("w2").labels(app="web", tier="cache").obj())
        store.create(pkg.w.make_pod("d1").labels(app="db").obj())
        p = pkg.w.make_pod("bound").labels(app="web").obj()
        p.spec.node_name = "n7"
        store.create(p)
        out = []
        for kw in ({"label_selector": "app=web"}, {"label_selector": "app=web,tier!=cache"},
                   {"label_selector": "tier"}, {"field_selector": "spec.nodeName=n7"},
                   {"label_selector": "app=web", "field_selector": "spec.nodeName="},
                   {"label_selector": "app==web"}, {"namespace": "other"}):
            items, rv = client.list("Pod", **kw)
            out.append((sorted(o.meta.name for o in items), rv))
        out.append(_try(pkg, lambda: client.list("Pod", field_selector="spec.bogus=1")))
        return out

    return _serve(pkg, case)


def _parsers(pkg):
    pod = pkg.w.make_pod("x").labels(app="web").obj()
    s = pkg.server
    return [s.parse_label_selector("app=web")(pod), s.parse_label_selector("app!=web")(pod),
            s.parse_label_selector("app==web")(pod), s.parse_label_selector("app")(pod),
            s.parse_label_selector("zone")(pod), s.parse_field_selector("metadata.name=x")(pod),
            s.parse_field_selector("status.phase!=Running")(pod),
            _try(pkg, lambda: s.parse_field_selector("spec.bogus=1"))]


def _authn_authz(pkg):
    auth = pkg.auth
    authn = auth.TokenAuthenticator({
        "admin-token": auth.Subject("admin", ("system:masters",)),
        "viewer-token": auth.Subject("viewer", ("readers",)),
    })
    authz = auth.RuleAuthorizer([auth.Rule(subjects=("system:masters",)),
                                 auth.Rule(subjects=("readers",), verbs=auth.READ_VERBS)])

    def case(store, srv, client):
        admin = pkg.RestClient(srv.url, token="admin-token")
        viewer = pkg.RestClient(srv.url, token="viewer-token")
        anon = pkg.RestClient(srv.url)
        bad = pkg.RestClient(srv.url, token="wrong")
        admin.create(pkg.w.make_pod("p").obj())
        out = [viewer.get("Pod", "p").meta.name, len(viewer.list("Pod")[0])]
        out += [_try(pkg, lambda: viewer.delete("Pod", "p")),
                _try(pkg, lambda: viewer.create(pkg.w.make_pod("q").obj())),
                _try(pkg, lambda: viewer.patch("Pod", "p", {"meta": {"labels": {"a": "b"}}})),
                _try(pkg, lambda: anon.get("Pod", "p")), _try(pkg, lambda: bad.list("Pod")),
                _http(f"{srv.url}/api/v1/Pod", token="viewer-token")[0],
                _http(f"{srv.url}/api/v1/Pod/default/p", "DELETE", token="viewer-token"),
                _http(f"{srv.url}/healthz")]
        out.append(store.get("Pod", "p").meta.labels)
        return out

    return _serve(pkg, case, authn=authn, authz=authz)


HARDENING_CASES = {
    "merge_patch_semantics": _merge_patch,
    "patch_updates_labels": _patch_labels,
    "patch_status_subresource_ignores_spec": _patch_status,
    "put_status_subresource_ignores_spec": _put_status,
    "patch_conflict_on_concurrent_write": _patch_conflict,
    "list_selectors_over_rest": _list_selectors,
    "selector_parsers_direct": _parsers,
    "authn_authz_enforced": _authn_authz,
}


@pytest.mark.parametrize("case", sorted(HARDENING_CASES))
def test_api_hardening_matches_reference(case):
    """tests/test_api_hardening.py's cases without the CLI, on both
    packages: RFC 7386 merge patch, PATCH of labels and of the status
    subresource (spec edits dropped), PUT on status, a stale PUT's 409,
    label and field selectors over REST (`==` among them), the parsers,
    and the authn/authz chain (401, 403, reads for viewers)."""
    got, want = _on_both(HARDENING_CASES[case])
    assert got == want


def test_hardening_transcripts_hold_the_reference_contract():
    assert _merge_patch(PORT)[0] == {"a": {"b": 9}, "d": [3], "e": "x"}
    assert _patch_status(PORT)[:2] == ["Running", ""]
    assert _put_status(PORT)[1] == ""
    sel = _list_selectors(PORT)
    assert [names for names, _ in sel[:6]] == [["bound", "w1", "w2"], ["bound", "w1"], ["w2"],
                                               ["bound"], ["w1", "w2"], ["bound", "w1", "w2"]]
    out = _authn_authz(PORT)
    assert out[:2] == ["p", 1] and all(r[0] == "RuntimeError" for r in out[2:7])
    assert out[7] == 200 and out[8][0] == 403 and out[9][0] == 200 and out[10] == {}


# -- api/types.py: every reference class ---------------------------------------------


def _classes(module):
    return {name: cls for name, cls in inspect.getmembers(module, inspect.isclass)
            if cls.__module__ == module.__name__}


def _default_of(f):
    """The field's default; for a drawn one (ObjectMeta.uid's
    _new_uid), the drawing function's name."""
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        if getattr(f.default_factory, "__name__", "") == "_new_uid":
            return "drawn by _new_uid"
        return f.default_factory()
    return dataclasses.MISSING


def test_types_define_every_reference_class():
    """The port's api/types.py defines every class the reference's does,
    with the same field names in order, equal defaults (as wire
    documents, so nested dataclasses compare by value) and the same
    KIND; CLUSTER_SCOPED_KINDS is the reference's set.  The wire codec
    decodes a document by class name against this module, so a missing
    class would make an HTTP create of that kind fail."""
    ref, port = _classes(japi), _classes(tapi)
    assert set(ref) <= set(port), sorted(set(ref) - set(port))
    for name, rcls in ref.items():
        pcls = port[name]
        assert dataclasses.is_dataclass(rcls) == dataclasses.is_dataclass(pcls), name
        assert getattr(rcls, "KIND", None) == getattr(pcls, "KIND", None), name
        if not dataclasses.is_dataclass(rcls):
            continue
        rf, pf = dataclasses.fields(rcls), dataclasses.fields(pcls)
        assert [f.name for f in rf] == [f.name for f in pf], name
        for a, b in zip(rf, pf):
            da, db = _default_of(a), _default_of(b)
            assert _drawn_out(jwire.to_wire(da)) == _drawn_out(twire.to_wire(db)) or (
                da is dataclasses.MISSING and db is dataclasses.MISSING), (name, a.name)
    assert tapi.CLUSTER_SCOPED_KINDS == japi.CLUSTER_SCOPED_KINDS
    assert len(ref) >= 104


@pytest.fixture(scope="module")
def kind_servers():
    """One APIServer a package, shared by the kinds' round trips (each
    kind's object is its own key)."""
    servers = {}
    for pkg in (PORT, REF):
        store = pkg.st.Store(**pkg.store_kw)
        servers[pkg.name] = (store, pkg.server.APIServer(store).start())
    yield servers
    for store, srv in servers.values():
        srv.stop()
        store.close()


@pytest.mark.parametrize("name", sorted(n for n, c in _classes(japi).items()
                                        if getattr(c, "KIND", None)))
def test_every_kind_round_trips_over_http(name, kind_servers):
    """A default object of every kind with a KIND, created over REST on
    both packages' servers, comes back equal to the reference's (status
    201, the same document), and a second create answers 409."""

    def case(pkg):
        obj = getattr(pkg.api, name)()
        obj.meta.name = "x"
        if name not in pkg.api.CLUSTER_SCOPED_KINDS:
            obj.meta.namespace = "default"
        _, srv = kind_servers[pkg.name]
        body = pkg.wire.to_wire(obj)
        status, doc = _http(f"{srv.url}/api/v1/{name}", "POST", body)
        doc.get("meta", {}).pop("resource_version", None)  # the shared store's count
        return [status, _drawn_out(doc), _http(f"{srv.url}/api/v1/{name}", "POST", body)[0]]

    got, want = _on_both(case)
    assert got == want
    assert got[0] == 201 and got[2] == 409
