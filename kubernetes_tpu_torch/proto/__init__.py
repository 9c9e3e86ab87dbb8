"""The dense-snapshot proto boundary: snapshot.proto is the contract and
snapshot_pb2 its committed generated messages (built in a private
descriptor pool; see that module)."""

from . import snapshot_pb2  # noqa: F401
