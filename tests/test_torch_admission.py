"""The API front's admission, CRDs, webhooks, policies, RBAC and APF in
the port against the reference package's.

kubernetes_tpu_torch/api/admission.py, crd.py, webhooks.py, auth.py and
flowcontrol.py, and the store's admission hook (`Store(admission=...)`,
mutate-then-validate on create, update and every object of a wave), on
the same writes as kubernetes_tpu/api/'s: tests/test_admission.py's
seven cases, tests/test_crd.py's four (its journal-replay case without
the journal, which the port's store does not keep: the wire round trip
alone), tests/test_webhooks_policies.py's five and tests/test_apf_rbac.py's
RBAC and APF cases (none of them needs the CLI), each run on both
packages.  Each case records what the write admitted (the object as a
wire document, without the uid and the creation time a run draws) or the
error it raised (class and message), and the two transcripts are equal.

Every wait is a bounded poll of at most 2 s on an event the case caused;
the webhook configuration cache's TTL is never waited out (a case that
changes the configuration starts a fresh store, whose cache is empty).
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from kubernetes_tpu.api import admission as jadm
from kubernetes_tpu.api import auth as jauth
from kubernetes_tpu.api import crd as jcrd
from kubernetes_tpu.api import flowcontrol as jflow
from kubernetes_tpu.api import store as jst
from kubernetes_tpu.api import types as japi
from kubernetes_tpu.api import webhooks as jwh
from kubernetes_tpu.api import wire as jwire
from kubernetes_tpu.api.server import APIServer as JAPIServer
from kubernetes_tpu.client.informers import InformerFactory as JInformerFactory
from kubernetes_tpu.client.rest import RestClient as JRestClient
from kubernetes_tpu.scheduler import coscheduling as jcos
from kubernetes_tpu.scheduler import waitingpods as jwp
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.api import admission as tadm
from kubernetes_tpu_torch.api import auth as tauth
from kubernetes_tpu_torch.api import crd as tcrd
from kubernetes_tpu_torch.api import flowcontrol as tflow
from kubernetes_tpu_torch.api import store as tst
from kubernetes_tpu_torch.api import types as tapi
from kubernetes_tpu_torch.api import webhooks as twh
from kubernetes_tpu_torch.api import wire as twire
from kubernetes_tpu_torch.api.server import APIServer as TAPIServer
from kubernetes_tpu_torch.client.informers import InformerFactory as TInformerFactory
from kubernetes_tpu_torch.client.rest import RestClient as TRestClient
from kubernetes_tpu_torch.scheduler import coscheduling as tcos
from kubernetes_tpu_torch.scheduler import waitingpods as twp
from kubernetes_tpu_torch.testing import wrappers as tw

PORT = SimpleNamespace(name="port", st=tst, api=tapi, adm=tadm, crd=tcrd, wh=twh, wire=twire,
                       auth=tauth, flow=tflow, APIServer=TAPIServer, RestClient=TRestClient,
                       InformerFactory=TInformerFactory, cos=tcos, wp=twp, w=tw,
                       store_kw={})
REF = SimpleNamespace(name="reference", st=jst, api=japi, adm=jadm, crd=jcrd, wh=jwh,
                      wire=jwire, auth=jauth, flow=jflow, APIServer=JAPIServer,
                      RestClient=JRestClient, InformerFactory=JInformerFactory, cos=jcos,
                      wp=jwp, w=jw, store_kw={"shards": 1})
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


def _store(pkg, admission=True, chain=None):
    if chain is None and admission:
        chain = pkg.adm.default_chain()
    return pkg.st.Store(admission=chain, **pkg.store_kw)


def _doc(pkg, obj):
    """The object as a wire document, without what a run draws."""
    doc = pkg.wire.to_wire(obj)
    for k in ("uid", "creation_timestamp"):
        doc["meta"].pop(k, None)
    return doc


def _try(pkg, fn):
    """("ok", the result's document) or (error class, message)."""
    try:
        out = fn()
    except Exception as exc:  # noqa: BLE001 — the transcript records it
        return type(exc).__name__, str(exc)
    return "ok", _doc(pkg, out) if hasattr(out, "meta") else out


# -- tests/test_admission.py -----------------------------------------------------


def _defaulting(pkg):
    store = _store(pkg)
    pod = pkg.api.Pod(meta=pkg.api.ObjectMeta(name="bare"))
    pod.spec.containers = []
    created = store.create(pod)
    return [len(created.spec.containers), _doc(pkg, created), len(pod.spec.containers)]


def _negative_requests(pkg):
    store = _store(pkg)
    return [_try(pkg, lambda: store.create(pkg.w.make_pod("bad").req(cpu_milli=-5).obj()))]


def _bad_names(pkg):
    store = _store(pkg)
    return [_try(pkg, lambda: store.create(pkg.w.make_pod("has space").obj())),
            _try(pkg, lambda: store.create(pkg.w.make_pod("").obj())),
            _try(pkg, lambda: store.create(pkg.w.make_pod("a/b").obj()))]


def _spread_and_gang(pkg):
    store = _store(pkg)
    pod = pkg.w.make_pod("p").obj()
    pod.spec.topology_spread_constraints.append(pkg.api.TopologySpreadConstraint(max_skew=0))
    pod2 = pkg.w.make_pod("q").obj()
    pod2.spec.scheduling_group_size = 3  # size without group
    pod3 = pkg.w.make_pod("r").obj()
    pod3.spec.preemption_policy = "Sometimes"
    return [_try(pkg, lambda: store.create(pod)), _try(pkg, lambda: store.create(pod2)),
            _try(pkg, lambda: store.create(pod3))]


def _node_taint(pkg):
    store = _store(pkg)
    node = pkg.w.make_node("n").obj()
    node.spec.taints.append(pkg.api.Taint("k", "v", "Sometimes"))
    return [_try(pkg, lambda: store.create(node))]


def _update_admitted(pkg):
    store = _store(pkg)
    store.create(pkg.w.make_pod("p").req(cpu_milli=100).obj())
    fresh = store.get("Pod", "p")
    fresh.spec.containers[0].requests[pkg.api.CPU] = -1
    out = [_try(pkg, lambda: store.update(fresh))]
    # a wave runs each mutated copy through the chain: the bad one is
    # refused alone, the rest commit
    store.create(pkg.w.make_pod("q").req(cpu_milli=100).obj())

    def bad(pod):
        pod.spec.containers[0].requests[pkg.api.CPU] = -1

    def good(pod):
        pod.meta.labels["waved"] = "yes"

    applied, errors = store.update_wave("Pod", [("p", "default", bad), ("q", "default", good)])
    out.append((applied, {k: (type(e).__name__, str(e)) for k, e in errors.items()}))
    out.append([_doc(pkg, store.get("Pod", n)) for n in ("p", "q")])
    return out


def _custom_plugin(pkg):
    chain = pkg.adm.default_chain()
    AdmissionError = pkg.adm.AdmissionError

    def quota(obj, op):
        if getattr(obj, "KIND", "") == "Pod" and obj.resource_requests().get(pkg.api.CPU, 0) > 1000:
            raise AdmissionError("quota")

    chain.register_validator(quota)
    store = _store(pkg, chain=chain)
    return [_try(pkg, lambda: store.create(pkg.w.make_pod("small").req(cpu_milli=500).obj())),
            _try(pkg, lambda: store.create(pkg.w.make_pod("big").req(cpu_milli=8000).obj()))]


def _quota_and_service_account(pkg):
    """The default chain's quota validator and ServiceAccount defaulter
    (controllers/resourcequota.py, serviceaccount.py), and kinds()."""
    api = pkg.api
    store = _store(pkg)
    store.create(api.ResourceQuota(meta=api.ObjectMeta(name="cap", namespace="q"),
                                   spec=api.ResourceQuotaSpec(hard={"pods": 2, api.CPU: 250})))
    out = [_try(pkg, lambda: store.create(pkg.w.make_pod(f"p{i}", namespace="q")
                                          .req(cpu_milli=100).obj())) for i in range(4)]
    out.append(store.get("Pod", "p0", "q").spec.service_account)
    out.append(sorted(store.kinds()))
    return out


ADMISSION_CASES = {
    "defaulting_fills_containers": _defaulting,
    "rejects_negative_requests": _negative_requests,
    "rejects_bad_names": _bad_names,
    "rejects_invalid_spread_and_gang": _spread_and_gang,
    "rejects_invalid_node_taint": _node_taint,
    "update_also_admitted": _update_admitted,
    "custom_webhook_style_plugin": _custom_plugin,
    "quota_and_service_account": _quota_and_service_account,
}


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_matches_reference(case):
    """tests/test_admission.py's cases (and the default chain's quota and
    ServiceAccount plugins) on both packages: defaulting fills a
    container; negative requests, bad names, a bad spread or gang, a bad
    taint and a bad update are refused with the reference's messages; an
    update_wave refuses a bad object alone."""
    got, want = _on_both(ADMISSION_CASES[case])
    assert got == want


def test_admission_transcripts_hold_the_reference_contract():
    assert _defaulting(PORT)[0] == 1
    assert _negative_requests(PORT) == [("AdmissionError", "negative request cpu=-5")]
    rejected, wave, docs = _update_admitted(PORT)
    assert rejected[0] == "AdmissionError" and wave[0] == ["default/q"]
    assert list(wave[1]) == ["default/p"] and docs[1]["meta"]["labels"]["waved"] == "yes"
    quota = _quota_and_service_account(PORT)
    assert [r[0] for r in quota[:4]] == ["ok", "ok", "AdmissionError", "AdmissionError"]
    assert quota[4] == "default"


# -- tests/test_crd.py ----------------------------------------------------------------


def _widget_crd(pkg):
    crd = pkg.crd
    return crd.CustomResourceDefinition(
        meta=pkg.api.ObjectMeta(name="widgets.example.com", namespace=""),
        spec=crd.CustomResourceDefinitionSpec(
            group="example.com",
            names=crd.CRDNames(kind="Widget", plural="widgets"),
            schema={
                "properties": {
                    "size": {"type": "integer", "minimum": 1, "maximum": 64},
                    "color": {"type": "string", "enum": ["red", "blue"]},
                    "tags": {"type": "array", "items": {"type": "string"}},
                },
                "required": ["size"],
            },
        ),
    )


def _widget(pkg, name, spec, kind="Widget"):
    return pkg.crd.DynamicObject(kind, meta=pkg.api.ObjectMeta(name=name), spec=spec)


def _crd_crud(pkg):
    store = _store(pkg)
    store.create(_widget_crd(pkg))
    out = [_try(pkg, lambda: store.create(_widget(pkg, "w1", {"size": 4, "color": "red",
                                                                "tags": ["a"]})))]
    got = store.get("Widget", "w1")
    out.append((got.spec, got.KIND))
    for name, spec, kind in (("w2", {}, "Widget"), ("w3", {"size": 0}, "Widget"),
                             ("w4", {"size": 1, "color": "green"}, "Widget"),
                             ("w5", {"size": "big"}, "Widget"), ("w6", {"size": 65}, "Widget"),
                             ("w7", {"size": 2, "tags": [3]}, "Widget"), ("g1", {}, "Gadget")):
        out.append(_try(pkg, lambda: store.create(_widget(pkg, name, spec, kind))))
    # a CRD with an unknown schema type is itself refused
    bad = _widget_crd(pkg)
    bad.meta.name = "bad.example.com"
    bad.spec.names.kind = "Bad"
    bad.spec.schema = {"properties": {"x": {"type": "complex"}}}
    out.append(_try(pkg, lambda: store.create(bad)))
    return out


def _crd_wire_round_trip(pkg):
    store = _store(pkg, admission=False)
    store.create(_widget_crd(pkg))
    store.create(_widget(pkg, "w1", {"size": 2}))
    doc = pkg.wire.to_wire(store.get("Widget", "w1"))
    back = pkg.wire.from_wire(doc)
    crd_doc = pkg.wire.to_wire(store.get("CustomResourceDefinition", "widgets.example.com", ""))
    crd_back = pkg.wire.from_wire(crd_doc)
    return [back == store.get("Widget", "w1"), _doc(pkg, back), crd_back.spec.names.kind,
            _doc(pkg, crd_back)]


def _crd_over_rest(pkg):
    store = _store(pkg)
    store.create(_widget_crd(pkg))
    srv = pkg.APIServer(store).start()
    factory = pkg.InformerFactory(store)
    inf = factory.informer("Widget")
    seen = []
    inf.add_handler(lambda typ, obj, old: seen.append((typ, obj.meta.name)))
    inf.start()
    try:
        cli = pkg.RestClient(srv.url)
        cli.create(_widget(pkg, "w1", {"size": 8}))
        got = cli.get("Widget", "w1")
        out = [type(got).__name__, got.spec, got.KIND]
        assert _poll(lambda: ("ADDED", "w1") in seen)
        out.append(_try(pkg, lambda: cli.create(_widget(pkg, "w2", {"size": 0}))))
        cli.delete("Widget", "w1")
        assert _poll(lambda: ("DELETED", "w1") in seen)
        out.append(seen)
        return out
    finally:
        factory.stop()
        srv.stop()
        store.close()


def _podgroup_sizes(pkg):
    store = _store(pkg)
    pkg.crd.install_podgroup_crd(store)
    pkg.crd.install_podgroup_crd(store)  # a second install is a no-op
    store.create(pkg.crd.pod_group("g1", min_member=2, timeout_s=7.5))
    waiting = pkg.wp.WaitingPodsMap()
    directory = pkg.crd.PodGroupDirectory(store)
    cos = pkg.cos.CoschedulingPermit(waiting, directory=directory)

    def member(name):
        return pkg.api.Pod(meta=pkg.api.ObjectMeta(name=name),
                           spec=pkg.api.PodSpec(scheduling_group="g1"))

    first = cos.permit(member("a"), "n0")
    wp = pkg.wp.WaitingPod(member("a"), "n0", first[1])
    waiting.add(wp)
    second = cos.permit(member("b"), "n0")
    return [first, second, wp.wait(), directory.size_for("default", "missing"),
            directory.timeout_for("default", "g1"), cos.group_of(member("c")),
            _try(pkg, lambda: store.create(pkg.crd.pod_group("bad", min_member=0))),
            _try(pkg, lambda: store.create(pkg.crd.pod_group("neg", 2, timeout_s=-1)))]


CRD_CASES = {
    "dynamic_kind_crud_and_schema_validation": _crd_crud,
    "wire_round_trip": _crd_wire_round_trip,
    "dynamic_kind_over_rest_and_informers": _crd_over_rest,
    "podgroup_drives_gang_sizes": _podgroup_sizes,
}


@pytest.mark.parametrize("case", sorted(CRD_CASES))
def test_crd_matches_reference(case):
    """tests/test_crd.py's cases on both packages: a dynamic kind's CRUD
    and its structural schema (required, minimum, maximum, enum, types,
    unregistered kinds), the wire round trip of an instance and its CRD,
    the kind over REST and through an informer, and the PodGroup driving
    CoschedulingPermit's sizes and timeouts."""
    got, want = _on_both(CRD_CASES[case])
    assert got == want


def test_crd_transcripts_hold_the_reference_contract():
    crud = _crd_crud(PORT)
    assert crud[0][0] == "ok" and crud[1] == ({"size": 4, "color": "red", "tags": ["a"]}, "Widget")
    assert all(r[0] == "AdmissionError" for r in crud[2:])
    assert _crd_wire_round_trip(PORT)[0]
    pg = _podgroup_sizes(PORT)
    assert pg[:3] == [("wait", 7.5), ("allow", 0.0), "allow"] and pg[6][0] == "AdmissionError"


# -- tests/test_webhooks_policies.py ------------------------------------------------


class _Hook:
    """In-process webhook endpoint returning a scripted response."""

    def __init__(self, respond):
        hooks = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                review = json.loads(self.rfile.read(n))
                hooks.reviews.append(review)
                body = json.dumps(respond(review)).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.reviews = []
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=WAIT_S)


def _strip_review(review):
    review = json.loads(json.dumps(review))
    for k in ("uid", "creation_timestamp"):
        review["object"]["meta"].pop(k, None)
    return review


def _mutating(pkg):
    api = pkg.api
    hook = _Hook(lambda review: {"allowed": True,
                                 "patch": {"meta": {"labels": {"injected": "yes"}}}})
    try:
        store = _store(pkg)
        store.create(api.MutatingWebhookConfiguration(
            meta=api.ObjectMeta(name="labeler", namespace=""),
            webhooks=[api.Webhook(name="labeler.example.com", url=hook.url,
                                  rules=[api.WebhookRule(kinds=["Pod"])])]))
        created = store.create(pkg.w.make_pod("p").obj())
        store.create(api.Namespace(meta=api.ObjectMeta(name="ns", namespace="")))
        return [_doc(pkg, created), [_strip_review(r) for r in hook.reviews]]
    finally:
        hook.stop()


def _validating(pkg):
    api = pkg.api
    hook = _Hook(lambda review: {"allowed": False,
                                 "status": {"message": "pods named bad are bad"}}
                 if review["object"]["meta"]["name"] == "bad" else {"allowed": True})
    try:
        store = _store(pkg)
        store.create(api.ValidatingWebhookConfiguration(
            meta=api.ObjectMeta(name="gate", namespace=""),
            webhooks=[api.Webhook(name="gate.example.com", url=hook.url,
                                  rules=[api.WebhookRule(kinds=["Pod"],
                                                         operations=["CREATE"])])]))
        return [_try(pkg, lambda: store.create(pkg.w.make_pod("good").obj()))[0],
                _try(pkg, lambda: store.create(pkg.w.make_pod("bad").obj())),
                len(hook.reviews)]
    finally:
        hook.stop()


def _failure_policy(pkg):
    api = pkg.api

    def config(name, policy):
        return api.ValidatingWebhookConfiguration(
            meta=api.ObjectMeta(name=name, namespace=""),
            webhooks=[api.Webhook(name="down", url="http://127.0.0.1:1/nope",
                                  rules=[api.WebhookRule(kinds=["Pod"])],
                                  failure_policy=policy, timeout_seconds=0.2)])

    # unreachable endpoint, failurePolicy=Ignore: writes pass
    ignore = _store(pkg)
    ignore.create(config("down-ignore", "Ignore"))
    out = [_try(pkg, lambda: ignore.create(pkg.w.make_pod("p1").obj()))[0]]
    # failurePolicy=Fail: writes reject (a fresh store: its configuration
    # cache is empty, so the Fail hook is read on the first write)
    fail = _store(pkg)
    fail.create(config("down-fail", "Fail"))
    out.append(_try(pkg, lambda: fail.create(pkg.w.make_pod("p2").obj())))
    return out


def _policies(pkg):
    api = pkg.api
    store = _store(pkg)
    store.create(api.ValidatingAdmissionPolicy(
        meta=api.ObjectMeta(name="naming", namespace=""),
        spec=api.ValidatingAdmissionPolicySpec(
            match=api.WebhookRule(kinds=["Pod"]),
            validations=[
                api.PolicyValidation(
                    expression="object.meta.name.startsWith('web-') || "
                               "object.meta.name.startsWith('sys-')",
                    message="pod names must start with web- or sys-"),
                api.PolicyValidation(
                    expression="object.spec.priority <= 100 && object.spec.priority >= 0",
                    message="priority out of range"),
            ])))
    over = pkg.w.make_pod("sys-1").obj()
    over.spec.priority = 5000
    return [_try(pkg, lambda: store.create(pkg.w.make_pod("web-1").obj()))[0],
            _try(pkg, lambda: store.create(pkg.w.make_pod("db-1").obj())),
            _try(pkg, lambda: store.create(over))]


def _policy_sandbox(pkg):
    api = pkg.api
    store = _store(pkg)
    out = [_try(pkg, lambda: store.create(api.ValidatingAdmissionPolicy(
        meta=api.ObjectMeta(name="evil", namespace=""),
        spec=api.ValidatingAdmissionPolicySpec(validations=[api.PolicyValidation(
            expression="__import__('os').system('true')")]))))]
    Expression = pkg.wh.Expression
    out.append(_try(pkg, lambda: Expression("object.__class__")))
    env = {"object": pkg.wh._Doc({"meta": {"name": "x", "labels": {"a": "1"}}, "spec": {}}),
           "true": True, "false": False}
    for expr in ("has(object.meta, 'labels')", "has(object.spec, 'priority')",
                 "size(object.meta.labels) == 1", "!(object.meta.name == 'y')",
                 "object.meta.labels['a'] == '1'", "'a' in object.meta.labels",
                 "object.meta.name.endsWith('x') && object.meta.name.contains('x')"):
        out.append((expr, Expression(expr).evaluate(env)))
    return out


WEBHOOK_CASES = {
    "mutating_webhook_applies_patch": _mutating,
    "validating_webhook_denies": _validating,
    "failure_policy": _failure_policy,
    "validating_policy_expressions": _policies,
    "policy_compile_time_rejection_and_sandbox": _policy_sandbox,
}


@pytest.mark.parametrize("case", sorted(WEBHOOK_CASES))
def test_webhooks_policies_match_reference(case):
    """tests/test_webhooks_policies.py's cases on both packages: a
    mutating webhook's patch lands (and only Pod writes are reviewed), a
    validating webhook's denial carries its message, failurePolicy Ignore
    passes and Fail refuses when the hook is down, an expression policy
    refuses with its messages, and a policy that reaches outside the
    admitted document is refused at its own write."""
    got, want = _on_both(WEBHOOK_CASES[case])
    assert got == want


def test_webhook_transcripts_hold_the_reference_contract():
    created, reviews = _mutating(PORT)
    assert created["meta"]["labels"] == {"injected": "yes"}
    assert [r["kind"] for r in reviews] == ["Pod"]
    assert _validating(PORT)[1] == ("AdmissionError",
                                    "webhook gate.example.com: pods named bad are bad")
    fp = _failure_policy(PORT)
    assert fp[0] == "ok" and fp[1][0] == "AdmissionError" and "webhook down" in fp[1][1]


# -- tests/test_apf_rbac.py -----------------------------------------------------------


def _role(pkg, name, ns, verbs, resources):
    api = pkg.api
    return api.Role(meta=api.ObjectMeta(name=name, namespace=ns),
                    rules=[api.PolicyRule(verbs=list(verbs), resources=list(resources))])


def _binding(pkg, name, ns, user, role, role_kind="Role"):
    api = pkg.api
    return api.RoleBinding(meta=api.ObjectMeta(name=name, namespace=ns),
                           subjects=[api.RbacSubject(kind="User", name=user)],
                           role_ref=api.RoleRef(kind=role_kind, name=role))


def _admin(pkg, store):
    api = pkg.api
    store.create(api.ClusterRole(meta=api.ObjectMeta(name="admin", namespace=""),
                                 rules=[api.PolicyRule()]))
    store.create(api.ClusterRoleBinding(
        meta=api.ObjectMeta(name="root-admin", namespace=""),
        subjects=[api.RbacSubject(kind="Group", name="system:masters")],
        role_ref=api.RoleRef(kind="ClusterRole", name="admin")))


def _rbac_scoping(pkg):
    store = _store(pkg, admission=False)
    store.create(_role(pkg, "pod-reader", "team-a", ["get", "list"], ["Pod"]))
    store.create(_binding(pkg, "alice-reads", "team-a", "alice", "pod-reader"))
    _admin(pkg, store)
    rbac = pkg.auth.RBACAuthorizer(store, ttl=0)
    alice = pkg.auth.Subject("alice")
    root = pkg.auth.Subject("root", ("system:masters",))
    return [rbac.allowed(alice, "list", "Pod", "team-a"), rbac.allowed(alice, "get", "Pod", "team-a"),
            rbac.allowed(alice, "create", "Pod", "team-a"), rbac.allowed(alice, "list", "Pod", "team-b"),
            rbac.allowed(alice, "list", "Node", "team-a"), rbac.allowed(alice, "list", "Pod", ""),
            rbac.allowed(root, "delete", "Node", ""), rbac.allowed(root, "create", "Pod", "team-b")]


def _rolebinding_to_clusterrole(pkg):
    api = pkg.api
    store = _store(pkg, admission=False)
    store.create(api.ClusterRole(meta=api.ObjectMeta(name="pod-admin", namespace=""),
                                 rules=[api.PolicyRule(verbs=["*"], resources=["Pod"])]))
    store.create(_binding(pkg, "bob-pods", "team-b", "bob", "pod-admin", "ClusterRole"))
    rbac = pkg.auth.RBACAuthorizer(store, ttl=0)
    bob = pkg.auth.Subject("bob")
    return [rbac.allowed(bob, "create", "Pod", "team-b"), rbac.allowed(bob, "create", "Pod", "team-a"),
            rbac.allowed(bob, "create", "Pod", "")]


def _rbac_through_server(pkg):
    auth = pkg.auth
    store = _store(pkg, admission=False)
    store.create(_role(pkg, "pod-reader", "team-a", ["get", "list"], ["Pod"]))
    store.create(_binding(pkg, "alice-reads", "team-a", "alice", "pod-reader"))
    _admin(pkg, store)
    authn = auth.TokenAuthenticator({"alice-token": auth.Subject("alice"),
                                     "root-token": auth.Subject("root", ("system:masters",))})
    srv = pkg.APIServer(store, authn=authn, authz=auth.RBACAuthorizer(store, ttl=0)).start()
    try:
        root = pkg.RestClient(srv.url, token="root-token")
        alice = pkg.RestClient(srv.url, token="alice-token")
        root.create(pkg.w.make_pod("p", namespace="team-a").obj())
        root.create(pkg.w.make_pod("q", namespace="team-b").obj())
        return [alice.get("Pod", "p", namespace="team-a").meta.name,
                len(alice.list("Pod", namespace="team-a")[0]),
                _try(pkg, lambda: alice.get("Pod", "q", namespace="team-b")),
                _try(pkg, lambda: alice.create(pkg.w.make_pod("r", namespace="team-a").obj())),
                _try(pkg, lambda: alice.list("Pod"))]
    finally:
        srv.stop()
        store.close()


def _apf_server(pkg, store, catch_all=(1, 0)):
    auth = pkg.auth
    authn = auth.TokenAuthenticator({
        "sched-token": auth.Subject("system:kube-scheduler", ("system:schedulers",)),
        "viewer-token": auth.Subject("viewer"),  # no groups: the catch-all
    })
    apf = pkg.flow.APFGate(levels={"system": (8, 32), "workload-high": (8, 32),
                                   "catch-all": catch_all}, queue_wait_s=0.2)
    return pkg.APIServer(store, authn=authn, apf=apf).start(), apf


def _apf_watch_seat(pkg):
    store = _store(pkg, admission=False)
    srv, apf = _apf_server(pkg, store)
    try:
        sched = pkg.RestClient(srv.url, token="sched-token")
        viewer = pkg.RestClient(srv.url, token="viewer-token")
        req = urllib.request.Request(f"{srv.url}/api/v1/watch/Pod",
                                     headers={"Authorization": "Bearer viewer-token"})
        stream = urllib.request.urlopen(req, timeout=5)
        assert _poll(lambda: store._watchers.get("Pod"))
        # catch-all has 1 seat and 0 queue slots: were the stream still
        # holding its seat, this list would shed with 429
        out = [len(viewer.list("Pod")[0])]
        sched.create(pkg.w.make_pod("p").obj())
        out += [sched.get("Pod", "p").meta.name, apf.levels["catch-all"].rejected_total]
        stream.close()
        return out
    finally:
        srv.stop()
        store.close()


def _apf_flood(pkg):
    store = _store(pkg, admission=False)
    srv, apf = _apf_server(pkg, store, catch_all=(2, 4))
    try:
        sched = pkg.RestClient(srv.url, token="sched-token")
        stop = threading.Event()
        floods = [0]

        def flood():
            viewer = pkg.RestClient(srv.url, token="viewer-token")
            while not stop.is_set():
                try:
                    viewer.list("Pod")
                except Exception:  # noqa: BLE001 — shed requests are the flood's lot
                    pass
                floods[0] += 1

        threads = [threading.Thread(target=flood, daemon=True) for _ in range(12)]
        for t in threads:
            t.start()
        assert _poll(lambda: floods[0] >= 24)  # the flood is on
        t0 = time.monotonic()
        for i in range(20):
            sched.create(pkg.w.make_pod(f"p-{i}").obj())
        dt = time.monotonic() - t0
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
        return [dt < 5.0, len(store.list("Pod")[0])]
    finally:
        srv.stop()
        store.close()


def _apf_config_knobs(pkg):
    flow = pkg.flow
    gate = flow.APFGate.from_config({"apfLevels": {"catch-all": {"seats": 1, "queueLimit": 0},
                                                   "workload-high": {"seats": 64}},
                                     "queueWaitSeconds": 0.05})
    out = [(lv.name, lv.seats, lv.queue_limit) for lv in gate.levels.values()]
    nobody = pkg.auth.ANONYMOUS
    first = gate.acquire(nobody, "list")
    out += [first is not None, gate.acquire(nobody, "list") is None,
            gate.levels["catch-all"].rejected_total]
    first.release()
    out.append(gate.acquire(nobody, "list") is not None)
    out.append(dict(flow.DEFAULT_LEVELS))
    return out


def _apf_config_served(pkg):
    store = _store(pkg, admission=False)
    srv = pkg.APIServer(store, apf={"apfLevels": {"catch-all": {"seats": 2,
                                                                 "queueLimit": 1}}}).start()
    try:
        client = pkg.RestClient(srv.url)
        client.create(pkg.w.make_pod("p").obj())
        gate = srv.httpd.RequestHandlerClass.apf
        return [client.get("Pod", "p").meta.name, gate.levels["catch-all"].seats,
                gate.levels["catch-all"].queue_limit, gate is srv.apf]
    finally:
        srv.stop()
        store.close()


def _apf_config_validation(pkg):
    flow = pkg.flow
    return [_try(pkg, lambda: flow.levels_from_config({"catch-all": {"seats": 0}})),
            _try(pkg, lambda: flow.levels_from_config({"system": {"seats": 4, "queueLimit": -1}})),
            _try(pkg, lambda: flow.levels_from_config({"system": {"seat": 4}})),
            _try(pkg, lambda: flow.APFGate.from_config({"levels": {}}))]


def _apf_fifo(pkg):
    gate = pkg.flow.APFGate(levels={"system": (1, 8), "workload-high": (1, 8),
                                    "catch-all": (1, 8)}, queue_wait_s=5.0)
    nobody = pkg.auth.ANONYMOUS
    hold = gate.acquire(nobody, "list")
    order = []

    def waiter(tag):
        seat = gate.acquire(nobody, "list")
        order.append(tag)
        seat.release()

    threads = []
    for n, tag in enumerate("ABC", 1):
        t = threading.Thread(target=waiter, args=(tag,), daemon=True)
        t.start()
        threads.append(t)
        assert _poll(lambda: gate.levels["catch-all"].queued >= n)
    hold.release()
    for t in threads:
        t.join(timeout=WAIT_S)
    return order


def _apf_priority(pkg):
    gate = pkg.flow.APFGate(levels={"system": (1, 8), "workload-high": (1, 8),
                                    "catch-all": (1, 8)}, queue_wait_s=5.0)
    sys_subj = pkg.auth.Subject("system:kube-scheduler", ("system:schedulers",))
    wh_subj = pkg.auth.Subject("dev", ("system:authenticated",))
    s_hold = gate.acquire(sys_subj, "update")
    w_hold = gate.acquire(wh_subj, "list")
    c_hold = gate.acquire(pkg.auth.ANONYMOUS, "list")
    grants = []

    def queued_acquire(subject, tag):
        seat = gate.acquire(subject, "list")
        grants.append((tag, seat.donor.name))

    t_w = threading.Thread(target=queued_acquire, args=(wh_subj, "wh"), daemon=True)
    t_w.start()
    assert _poll(lambda: gate.levels["workload-high"].queued == 1)
    t_s = threading.Thread(target=queued_acquire, args=(sys_subj, "system"), daemon=True)
    t_s.start()
    assert _poll(lambda: gate.levels["system"].queued == 1)
    # the catch-all seat frees: the system waiter borrows it downward
    c_hold.release()
    t_s.join(timeout=WAIT_S)
    out = [list(grants), gate.levels["workload-high"].queued]
    # the system seat frees: borrowing never goes upward
    s_hold.release()
    out.append(gate.levels["workload-high"].queued)
    w_hold.release()
    t_w.join(timeout=WAIT_S)
    out.append(list(grants))
    return out


def _apf_catch_all(pkg):
    gate = pkg.flow.APFGate(levels={"system": (4, 8), "workload-high": (1, 0),
                                    "catch-all": (1, 0)}, queue_wait_s=0.05)
    nobody = pkg.auth.ANONYMOUS
    a = gate.acquire(nobody, "list")
    out = [a.donor.name, gate.acquire(nobody, "list") is None,
           gate.levels["system"].seats_used, gate.levels["workload-high"].seats_used,
           gate.levels["catch-all"].rejected_total]
    a.release()
    return out


def _apf_adaptive(pkg):
    flow = pkg.flow
    gate = flow.APFGate(levels={"system": (8, 16), "workload-high": (8, 16),
                                "catch-all": (4, 8)}, queue_wait_s=0.05)
    adaptive = flow.AdaptiveAPF(gate, recover_after=3)

    def state():
        return [(lv.name, lv.seats_effective, lv.queue_limit_effective)
                for lv in gate.levels.values()] + [gate.seats_current(), gate.retry_after_s()]

    out = [state(), adaptive.note(overload_level=2), state()]
    held = gate.acquire(pkg.auth.ANONYMOUS, "list")
    out.append(gate.acquire(pkg.auth.ANONYMOUS, "list") is None)
    out.append(gate.levels["catch-all"].rejected_total)
    for level in (0, 0, 2, 0, 0, 0, 0, 0, 0):
        out.append((adaptive.note(level), gate.seats_current(), gate.retry_after_s()))
    out.append(state())
    held.release()
    return out


def _apf_depth_ladder(pkg):
    flow = pkg.flow
    gate = flow.APFGate(queue_wait_s=0.05)
    adaptive = flow.AdaptiveAPF(gate, depth_threshold=256, recover_after=2)
    return [adaptive.note(watch_depth=255), adaptive.note(watch_depth=256),
            adaptive.note(dispatch_depth=1024), adaptive.note(overload_level=1, watch_depth=0),
            adaptive.note(overload_level=1), gate.levels["catch-all"].seats_effective]


def _apf_retry_after(pkg):
    store = _store(pkg, admission=False)
    srv, apf = _apf_server(pkg, store, catch_all=(1, 4))
    try:
        apf.set_pressure(2)
        seat = apf.acquire(pkg.auth.ANONYMOUS, "list")
        req = urllib.request.Request(f"{srv.url}/api/v1/Pod",
                                     headers={"Authorization": "Bearer viewer-token"})
        try:
            urllib.request.urlopen(req, timeout=5)
            shed = None
        except urllib.error.HTTPError as exc:
            shed = (exc.code, exc.headers["Retry-After"])
        seat.release()
        apf.set_pressure(0)
        body = json.loads(urllib.request.urlopen(req, timeout=5).read())
        return [shed, sorted(body)]
    finally:
        srv.stop()
        store.close()


def _apf_metrics(pkg):
    store = _store(pkg, admission=False)
    srv, apf = _apf_server(pkg, store)
    try:
        pkg.RestClient(srv.url, token="sched-token").list("Pod")
        try:
            urllib.request.urlopen(f"{srv.url}/metrics", timeout=5)
            anon = None
        except urllib.error.HTTPError as exc:
            anon = exc.code
        req = urllib.request.Request(f"{srv.url}/metrics",
                                     headers={"Authorization": "Bearer sched-token"})
        text = urllib.request.urlopen(req, timeout=5).read().decode()
        return [anon, text]
    finally:
        srv.stop()
        store.close()


APF_RBAC_CASES = {
    "rbac_namespace_scoping": _rbac_scoping,
    "rolebinding_to_clusterrole_is_namespace_scoped": _rolebinding_to_clusterrole,
    "rbac_through_api_server_restricted_user": _rbac_through_server,
    "apf_watch_releases_seat_after_initialization": _apf_watch_seat,
    "apf_flood_does_not_starve_system_writes": _apf_flood,
    "apf_levels_are_config_knobs": _apf_config_knobs,
    "apf_config_served_end_to_end": _apf_config_served,
    "apf_config_validation_rejects_bad_knobs": _apf_config_validation,
    "apf_fifo_within_level_no_barging": _apf_fifo,
    "apf_priority_across_levels_and_borrow_downward": _apf_priority,
    "apf_catch_all_never_borrows_system_seats": _apf_catch_all,
    "adaptive_apf_sheds_and_recovers_with_hysteresis": _apf_adaptive,
    "adaptive_apf_depth_ladder": _apf_depth_ladder,
    "apf_shed_carries_adaptive_retry_after": _apf_retry_after,
    "apf_metrics_endpoint": _apf_metrics,
}


@pytest.mark.parametrize("case", sorted(APF_RBAC_CASES))
def test_apf_rbac_matches_reference(case):
    """tests/test_apf_rbac.py's cases on both packages: RBAC's namespace
    scoping (Role, RoleBinding to a ClusterRole, cluster bindings) alone
    and through the API server; APF's seat released after a watch
    starts, a flood that cannot starve system writes, the levels as
    config knobs (dict config, validation), FIFO within a level,
    priority across levels with borrowing downward only, the adaptive
    ladder and its Retry-After, and /metrics behind authn."""
    got, want = _on_both(APF_RBAC_CASES[case])
    assert got == want


def test_apf_rbac_transcripts_hold_the_reference_contract():
    assert _rbac_scoping(PORT) == [True, True, False, False, False, False, True, True]
    assert _rolebinding_to_clusterrole(PORT) == [True, False, False]
    assert _apf_watch_seat(PORT) == [0, "p", 0]
    assert _apf_fifo(PORT) == ["A", "B", "C"]
    prio = _apf_priority(PORT)
    assert prio == [[("system", "catch-all")], 1, 1,
                    [("system", "catch-all"), ("wh", "workload-high")]]
    assert _apf_retry_after(PORT) == [(429, "4"), ["items", "resourceVersion"]]
    anon, text = _apf_metrics(PORT)
    assert anon == 401 and 'priority_level="system"' in text
