"""snapshot.proto's messages, built in a private descriptor pool.

The serialized FileDescriptorProto below is protoc's output for
snapshot.proto (beside this file), as committed; nothing runs protoc at
import.  The descriptors live in a pool of this module's own, not in
protobuf's default pool, so this package can be imported in one process
with another package that registers the same snapshot.proto there.  The
wire format is the contract's: the same fields, numbers and types.
"""

from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

POOL = _descriptor_pool.DescriptorPool()
DESCRIPTOR = POOL.AddSerializedFile(b'\n\x0esnapshot.proto\x12\x11kubernetes_tpu.v1\"\x1e\n\rResourceVocab\x12\r\n\x05names\x18\x01 \x03(\t\";\n\x0b\x44\x65nseMatrix\x12\x0c\n\x04rows\x18\x01 \x01(\r\x12\x0c\n\x04\x63ols\x18\x02 \x01(\r\x12\x10\n\x04\x64\x61ta\x18\x03 \x03(\x02\x42\x02\x10\x01\"\xc2\x01\n\x0f\x43lusterSnapshot\x12\x33\n\tresources\x18\x01 \x01(\x0b\x32 .kubernetes_tpu.v1.ResourceVocab\x12\x12\n\nnode_names\x18\x02 \x03(\t\x12\x33\n\x0b\x61llocatable\x18\x03 \x01(\x0b\x32\x1e.kubernetes_tpu.v1.DenseMatrix\x12\x31\n\trequested\x18\x04 \x01(\x0b\x32\x1e.kubernetes_tpu.v1.DenseMatrix\"v\n\x08PodBatch\x12\x11\n\tpod_names\x18\x01 \x03(\t\x12\x30\n\x08requests\x18\x02 \x01(\x0b\x32\x1e.kubernetes_tpu.v1.DenseMatrix\x12\x12\n\npriorities\x18\x03 \x03(\x05\x12\x11\n\tgroup_ids\x18\x04 \x03(\t\"\x7f\n\x0cSolveRequest\x12\x33\n\x07\x63luster\x18\x01 \x01(\x0b\x32\".kubernetes_tpu.v1.ClusterSnapshot\x12)\n\x04pods\x18\x02 \x01(\x0b\x32\x1b.kubernetes_tpu.v1.PodBatch\x12\x0f\n\x07profile\x18\x03 \x01(\t\"E\n\nAssignment\x12\x10\n\x08pod_name\x18\x01 \x01(\t\x12\x11\n\tnode_name\x18\x02 \x01(\t\x12\x12\n\nnode_index\x18\x03 \x01(\x05\"k\n\rSolveResponse\x12\x32\n\x0b\x61ssignments\x18\x01 \x03(\x0b\x32\x1d.kubernetes_tpu.v1.Assignment\x12\x0f\n\x07reasons\x18\x02 \x03(\x05\x12\x15\n\rsolve_seconds\x18\x03 \x01(\x02\x32Z\n\x0cTPUScheduler\x12J\n\x05Solve\x12\x1f.kubernetes_tpu.v1.SolveRequest\x1a .kubernetes_tpu.v1.SolveResponseB$Z\"kubernetes-tpu/proto/v1;tpuschedv1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'snapshot_pb2', globals())
