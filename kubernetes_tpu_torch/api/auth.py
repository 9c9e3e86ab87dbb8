"""Authentication + authorization for the API server.

The reference wires authn/authz into the generic apiserver's handler
chain (DefaultBuildHandlerChain, apiserver/pkg/server/config.go:983-1028:
authorization at :987, authentication at :1014) with pluggable token
authenticators and RBAC/webhook authorizers.  Ours is the minimal
useful pair:

  * TokenAuthenticator — static bearer-token -> subject map (the
    --token-auth-file pattern, apiserver/pkg/authentication/token);
  * RuleAuthorizer — an ordered allow-list evaluated per
    (subject, verb, kind), "*" wildcards (the ABAC policy-file shape,
    apiserver/plugin/pkg/authorizer/abac reduced to allow rules).

Semantics: with no authenticator every request is anonymous; with one,
a missing/unknown bearer token is 401.  With no authorizer everything
is allowed; with one, any non-matching request is 403.  Reads and
writes use the reference verb set (get/list/watch/create/update/patch/
delete).

A copy of the reference package's api/auth.py, whole.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Subject:
    name: str
    groups: Tuple[str, ...] = ()


ANONYMOUS = Subject("system:anonymous", ("system:unauthenticated",))


class TokenAuthenticator:
    def __init__(self, tokens: Dict[str, Subject]):
        self._tokens = dict(tokens)

    def authenticate(self, authorization: Optional[str]) -> Optional[Subject]:
        """Subject for an Authorization header value, or None (401)."""
        if not authorization or not authorization.startswith("Bearer "):
            return None
        return self._tokens.get(authorization[len("Bearer "):].strip())


@dataclass
class Rule:
    """Allow rule: subject name OR group must match, plus verb + kind."""

    subjects: Sequence[str] = ("*",)   # names or group names
    verbs: Sequence[str] = ("*",)
    kinds: Sequence[str] = ("*",)

    def matches(self, subject: Subject, verb: str, kind: str) -> bool:
        who = {subject.name, *subject.groups}
        return (
            ("*" in self.subjects or who.intersection(self.subjects))
            and ("*" in self.verbs or verb in self.verbs)
            and ("*" in self.kinds or kind in self.kinds)
        )


READ_VERBS = ("get", "list", "watch")


class RuleAuthorizer:
    def __init__(self, rules: Sequence[Rule]):
        self.rules = list(rules)

    def allowed(
        self, subject: Subject, verb: str, kind: str, namespace: str = ""
    ) -> bool:
        # flat ABAC-style rules have no namespace dimension; every grant
        # is cluster-wide (use RBACAuthorizer for namespace scoping)
        return any(r.matches(subject, verb, kind) for r in self.rules)


class RBACAuthorizer:
    """Role/RoleBinding evaluation (plugin/pkg/auth/authorizer/rbac/
    rbac.go:75 VisitRulesFor):

      ClusterRoleBinding -> ClusterRole   grants everywhere
      RoleBinding        -> Role          grants in the binding's ns
      RoleBinding        -> ClusterRole   grants the cluster role's
                                          rules IN that namespace only

    Bindings and roles are read from the store with a short TTL cache
    (the reference keeps them in informers); the namespace dimension
    makes multi-tenant grants expressible at last."""

    def __init__(self, store, ttl: float = 0.5, clock=None):
        import time as _t

        self.store = store
        self.ttl = ttl
        self._clock = clock or _t.monotonic
        self._cache = None
        self._cached_at = -1e9

    def _snapshot(self):
        now = self._clock()
        if self._cache is not None and now - self._cached_at < self.ttl:
            return self._cache
        roles = {
            (r.meta.namespace, r.meta.name): r
            for r in self.store.list("Role")[0]
        }
        cluster_roles = {
            r.meta.name: r for r in self.store.list("ClusterRole")[0]
        }
        bindings = self.store.list("RoleBinding")[0]
        cluster_bindings = self.store.list("ClusterRoleBinding")[0]
        self._cache = (roles, cluster_roles, bindings, cluster_bindings)
        self._cached_at = now
        return self._cache

    @staticmethod
    def _subject_matches(subjects, subject: Subject) -> bool:
        for s in subjects:
            if s.kind == "User" and s.name == subject.name:
                return True
            if s.kind == "Group" and s.name in subject.groups:
                return True
        return False

    @staticmethod
    def _rules_allow(rules, verb: str, kind: str) -> bool:
        for rule in rules:
            if ("*" in rule.verbs or verb in rule.verbs) and (
                "*" in rule.resources or kind in rule.resources
            ):
                return True
        return False

    def allowed(
        self, subject: Subject, verb: str, kind: str, namespace: str = ""
    ) -> bool:
        roles, cluster_roles, bindings, cluster_bindings = self._snapshot()
        for b in cluster_bindings:
            if not self._subject_matches(b.subjects, subject):
                continue
            role = cluster_roles.get(b.role_ref.name)
            if role is not None and self._rules_allow(role.rules, verb, kind):
                return True
        for b in bindings:
            if namespace and b.meta.namespace != namespace:
                continue
            if not namespace:
                # cluster-scoped request (e.g. list across namespaces):
                # only cluster bindings can grant it
                continue
            if not self._subject_matches(b.subjects, subject):
                continue
            if b.role_ref.kind == "ClusterRole":
                role_rules = cluster_roles.get(b.role_ref.name)
                rules = role_rules.rules if role_rules else []
            else:
                role = roles.get((b.meta.namespace, b.role_ref.name))
                rules = role.rules if role else []
            if self._rules_allow(rules, verb, kind):
                return True
        return False
