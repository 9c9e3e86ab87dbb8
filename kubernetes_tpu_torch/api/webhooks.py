"""Dynamic admission: webhook callouts + expression policies.

Reference: the apiserver's mutating/validating webhook plugins
(apiserver/pkg/admission/plugin/webhook — AdmissionReview POSTs with
failurePolicy semantics) and ValidatingAdmissionPolicy
(admission/plugin/policy/validating/plugin.go — CEL expressions over
`object`/`oldObject`).

Webhooks: configurations are API objects; on every matching write the
chain POSTs an AdmissionReview-ish JSON {operation, kind, object} to
the webhook URL.  Mutating responses return {"allowed": true, "patch":
{...}} with an RFC 7386 merge patch (the reference uses JSONPatch; the
merge dialect covers the defaulting/labeling cases a merge patch can
express and is what our PATCH verb already speaks — documented
divergence).  Validating responses return {"allowed": bool,
"status": {"message": ...}}.  failurePolicy=Fail turns call errors into
rejections; Ignore skips them.

Policies: CEL-style boolean expressions compiled to a SAFE evaluator —
the expression is parsed with Python's ast after translating CEL's
&&/||/! operators, and only a whitelisted node set (bool ops,
comparisons, attribute/index access on `object`/`oldObject`, arithmetic,
len/has/startsWith/endsWith/contains/size calls, literals) evaluates;
anything else is rejected at policy-admission time.  No attribute can
reach outside the admitted object's wire document, so a policy cannot
touch the process (the sandboxing property CEL provides the reference).

A copy of the reference package's api/webhooks.py, whole.
"""

from __future__ import annotations

import ast
import json
import operator
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from . import types as api
from .admission import AdmissionError

_CACHE_TTL = 0.5


class _Doc:
    """Dot-and-index access over a wire document (CEL's object view)."""

    def __init__(self, doc: Any):
        self._doc = doc

    def get(self, name: str) -> Any:
        if isinstance(self._doc, dict) and name in self._doc:
            return _wrap(self._doc[name])
        raise AdmissionError(f"no such field {name!r}")

    def has(self, name: str) -> bool:
        return isinstance(self._doc, dict) and name in self._doc


def _wrap(v: Any):
    return _Doc(v) if isinstance(v, dict) else v


def _unwrap(v: Any):
    return v._doc if isinstance(v, _Doc) else v


_CMP = {
    ast.Eq: operator.eq, ast.NotEq: operator.ne,
    ast.Lt: operator.lt, ast.LtE: operator.le,
    ast.Gt: operator.gt, ast.GtE: operator.ge,
    ast.In: lambda a, b: a in b, ast.NotIn: lambda a, b: a not in b,
}
_BIN = {
    ast.Add: operator.add, ast.Sub: operator.sub,
    ast.Mult: operator.mul, ast.Div: operator.truediv,
    ast.Mod: operator.mod,
}


def _translate_cel(source: str) -> str:
    """CEL's &&/||/! -> Python's and/or/not, OUTSIDE string literals —
    a naive str.replace would rewrite an operator inside a quoted value
    ('a&&b') and silently change the policy's meaning."""
    out = []
    i, n = 0, len(source)
    quote = None
    while i < n:
        ch = source[i]
        if quote is not None:
            out.append(ch)
            if ch == "\\" and i + 1 < n:
                out.append(source[i + 1])
                i += 2
                continue
            if ch == quote:
                quote = None
            i += 1
            continue
        if ch in "'\"":
            quote = ch
            out.append(ch)
            i += 1
            continue
        if source.startswith("&&", i):
            out.append(" and ")
            i += 2
            continue
        if source.startswith("||", i):
            out.append(" or ")
            i += 2
            continue
        if ch == "!" and not source.startswith("!=", i):
            out.append(" not ")
            i += 1
            continue
        out.append(ch)
        i += 1
    return "".join(out).strip()


class Expression:
    """One compiled policy expression."""

    def __init__(self, source: str):
        self.source = source
        py = _translate_cel(source)
        try:
            tree = ast.parse(py, mode="eval")
        except SyntaxError as e:
            raise AdmissionError(f"policy expression {source!r}: {e}") from None
        self._validate(tree.body)
        self._tree = tree.body

    # -- compile-time whitelist --------------------------------------------

    _ALLOWED = (
        ast.BoolOp, ast.UnaryOp, ast.Compare, ast.BinOp, ast.Attribute,
        ast.Subscript, ast.Name, ast.Constant, ast.Call, ast.And, ast.Or,
        ast.Not, ast.USub, ast.List, ast.Tuple, ast.IfExp,
        *(_CMP.keys()), *(_BIN.keys()),
    )
    _FUNCS = ("len", "size", "has", "startsWith", "endsWith", "contains")

    def _validate(self, node: ast.AST) -> None:
        if not isinstance(node, self._ALLOWED):
            raise AdmissionError(
                f"policy expression {self.source!r}: "
                f"{type(node).__name__} not allowed"
            )
        if isinstance(node, (ast.Attribute, ast.Name)):
            ident = node.attr if isinstance(node, ast.Attribute) else node.id
            if ident.startswith("_"):
                raise AdmissionError(
                    f"policy expression {self.source!r}: "
                    f"identifier {ident!r} not allowed"
                )
        if isinstance(node, ast.Call):
            fn = node.func
            name = (
                fn.id if isinstance(fn, ast.Name)
                else fn.attr if isinstance(fn, ast.Attribute)
                else None
            )
            if name not in self._FUNCS:
                raise AdmissionError(
                    f"policy expression {self.source!r}: "
                    f"call to {name!r} not allowed"
                )
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr_context, ast.operator,
                                  ast.boolop, ast.unaryop, ast.cmpop)):
                continue
            self._validate(child)

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, env: Dict[str, Any]) -> bool:
        return bool(_unwrap(self._eval(self._tree, env)))

    def _eval(self, node: ast.AST, env: Dict[str, Any]):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            raise AdmissionError(
                f"policy expression {self.source!r}: unknown name {node.id!r}"
            )
        if isinstance(node, ast.Attribute):
            base = self._eval(node.value, env)
            if isinstance(base, _Doc):
                return base.get(node.attr)
            raise AdmissionError(
                f"policy expression {self.source!r}: attribute access on "
                f"{type(base).__name__}"
            )
        if isinstance(node, ast.Subscript):
            base = _unwrap(self._eval(node.value, env))
            key = _unwrap(self._eval(node.slice, env))
            try:
                return _wrap(base[key])
            except (KeyError, IndexError, TypeError):
                raise AdmissionError(
                    f"policy expression {self.source!r}: no element {key!r}"
                ) from None
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                return all(
                    _unwrap(self._eval(v, env)) for v in node.values
                )
            return any(_unwrap(self._eval(v, env)) for v in node.values)
        if isinstance(node, ast.UnaryOp):
            v = _unwrap(self._eval(node.operand, env))
            return (not v) if isinstance(node.op, ast.Not) else -v
        if isinstance(node, ast.Compare):
            left = _unwrap(self._eval(node.left, env))
            for op, right in zip(node.ops, node.comparators):
                r = _unwrap(self._eval(right, env))
                if not _CMP[type(op)](left, r):
                    return False
                left = r
            return True
        if isinstance(node, ast.BinOp):
            return _BIN[type(node.op)](
                _unwrap(self._eval(node.left, env)),
                _unwrap(self._eval(node.right, env)),
            )
        if isinstance(node, (ast.List, ast.Tuple)):
            return [_unwrap(self._eval(e, env)) for e in node.elts]
        if isinstance(node, ast.IfExp):
            return (
                self._eval(node.body, env)
                if _unwrap(self._eval(node.test, env))
                else self._eval(node.orelse, env)
            )
        if isinstance(node, ast.Call):
            fn = node.func
            args = [self._eval(a, env) for a in node.args]
            if isinstance(fn, ast.Name):
                name = fn.id
                if name in ("len", "size"):
                    return len(_unwrap(args[0]))
                if name == "has":
                    doc, field = args
                    return isinstance(doc, _Doc) and doc.has(_unwrap(field))
            else:  # method style: x.startsWith("p")
                recv = _unwrap(self._eval(fn.value, env))
                name = fn.attr
                if name == "startsWith":
                    return str(recv).startswith(_unwrap(args[0]))
                if name == "endsWith":
                    return str(recv).endswith(_unwrap(args[0]))
                if name == "contains":
                    return _unwrap(args[0]) in recv
                if name in ("len", "size"):
                    return len(recv)
            raise AdmissionError(
                f"policy expression {self.source!r}: bad call"
            )
        raise AdmissionError(
            f"policy expression {self.source!r}: "
            f"{type(node).__name__} unsupported"
        )


_compiled_cache: Dict[str, "Expression"] = {}


def _compiled(source: str) -> "Expression":
    """Compiled-expression cache: policies match every write on the hot
    path; re-parsing per admitted object would tax each Lease heartbeat
    and status update (the reference caches compiled CEL programs)."""
    e = _compiled_cache.get(source)
    if e is None:
        if len(_compiled_cache) >= 1024:
            _compiled_cache.clear()
        e = _compiled_cache[source] = Expression(source)
    return e


def _rule_matches(rules: List[api.WebhookRule], kind: str, op: str) -> bool:
    if not rules:
        return True
    for r in rules:
        if ("*" in r.kinds or kind in r.kinds) and (
            "*" in r.operations or op in r.operations
        ):
            return True
    return False


class _ConfigCache:
    """Per-store TTL cache of the registered configurations (one
    process can host several independent stores — tests, kubemark)."""

    def __init__(self):
        import weakref

        self._by_store = weakref.WeakKeyDictionary()

    def get(self, store) -> Tuple:
        now = time.monotonic()
        entry = self._by_store.get(store)
        if entry is None or now - entry[0] >= _CACHE_TTL:
            entry = (
                now,
                (
                    tuple(store.list("MutatingWebhookConfiguration")[0]),
                    tuple(store.list("ValidatingWebhookConfiguration")[0]),
                    tuple(store.list("ValidatingAdmissionPolicy")[0]),
                ),
            )
            self._by_store[store] = entry
        return entry[1]


_cache = _ConfigCache()


def _configs(store) -> Tuple:
    return _cache.get(store)


def _call_webhook(hook: api.Webhook, review: Dict[str, Any]) -> Dict[str, Any]:
    req = urllib.request.Request(
        hook.url,
        data=json.dumps(review).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=hook.timeout_seconds) as resp:
        return json.loads(resp.read() or b"{}")


def _review(obj: Any, operation: str) -> Dict[str, Any]:
    from . import wire

    return {
        "operation": operation,
        "kind": getattr(obj, "KIND", ""),
        "object": wire.to_wire(obj),
    }


def _skip(obj: Any) -> bool:
    # admission on the admission machinery itself would recurse/bootstrap
    return getattr(obj, "KIND", "") in (
        "MutatingWebhookConfiguration",
        "ValidatingWebhookConfiguration",
        "ValidatingAdmissionPolicy",
        "Event",
    )


def mutating_webhooks(obj: Any, operation: str, store=None) -> None:
    """Mutator: POST to each matching mutating webhook, apply returned
    merge patches in order (webhook ordering = config name order)."""
    if store is None or _skip(obj):
        return
    configs, _, _ = _configs(store)
    if not configs:
        return
    from . import wire
    from .server import merge_patch

    kind = getattr(obj, "KIND", "")
    doc = None
    for cfg in sorted(configs, key=lambda c: c.meta.name):
        for hook in cfg.webhooks:
            if not _rule_matches(hook.rules, kind, operation):
                continue
            if doc is None:
                doc = wire.to_wire(obj)
            try:
                out = _call_webhook(
                    hook, {"operation": operation, "kind": kind, "object": doc}
                )
            except (urllib.error.URLError, OSError, ValueError) as e:
                if hook.failure_policy == "Fail":
                    raise AdmissionError(
                        f"webhook {hook.name}: {e}"
                    ) from None
                continue
            if not out.get("allowed", True):
                msg = (out.get("status") or {}).get("message", "denied")
                raise AdmissionError(f"webhook {hook.name}: {msg}")
            patch = out.get("patch")
            if patch:
                doc = merge_patch(doc, patch)
    if doc is not None:
        mutated = wire.from_wire(doc)
        fields = (
            obj.__dataclass_fields__
            if hasattr(obj, "__dataclass_fields__")
            else ("meta", "spec", "status")  # DynamicObject
        )
        for f in fields:
            setattr(obj, f, getattr(mutated, f))


mutating_webhooks.wants_store = True


def validating_webhooks(obj: Any, operation: str, store=None) -> None:
    if store is None or _skip(obj):
        return
    _, configs, _ = _configs(store)
    kind = getattr(obj, "KIND", "")
    for cfg in sorted(configs, key=lambda c: c.meta.name):
        for hook in cfg.webhooks:
            if not _rule_matches(hook.rules, kind, operation):
                continue
            try:
                out = _call_webhook(hook, _review(obj, operation))
            except (urllib.error.URLError, OSError, ValueError) as e:
                if hook.failure_policy == "Fail":
                    raise AdmissionError(
                        f"webhook {hook.name}: {e}"
                    ) from None
                continue
            if not out.get("allowed", True):
                msg = (out.get("status") or {}).get("message", "denied")
                raise AdmissionError(f"webhook {hook.name}: {msg}")


validating_webhooks.wants_store = True


def validating_policies(obj: Any, operation: str, store=None) -> None:
    """ValidatingAdmissionPolicy: every matching validation expression
    must evaluate true over the object's wire document."""
    if store is None or _skip(obj):
        return
    _, _, policies = _configs(store)
    if not policies:
        return
    from . import wire

    kind = getattr(obj, "KIND", "")
    env = {"object": _Doc(wire.to_wire(obj)), "true": True, "false": False}
    for policy in sorted(policies, key=lambda p: p.meta.name):
        if not _rule_matches([policy.spec.match], kind, operation):
            continue
        for v in policy.spec.validations:
            expr = _compiled(v.expression)
            ok = False
            try:
                ok = expr.evaluate(env)
            except AdmissionError:
                ok = False  # missing fields fail closed, like CEL errors
            if not ok:
                raise AdmissionError(
                    v.message
                    or f"policy {policy.meta.name}: "
                       f"{v.expression!r} evaluated false"
                )


validating_policies.wants_store = True


def validate_policy_object(obj: Any, operation: str) -> None:
    """Compile expressions at policy-admission time so a bad expression
    is rejected when the POLICY is written, not when workloads are."""
    if isinstance(obj, api.ValidatingAdmissionPolicy):
        for v in obj.spec.validations:
            Expression(v.expression)
