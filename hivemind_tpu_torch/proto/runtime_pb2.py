# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: hivemind_tpu_torch/proto/runtime.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n&hivemind_tpu_torch/proto/runtime.proto\x12\x12hivemind_tpu_torch\"\x96\x01\n\x06Tensor\x12\x0e\n\x06\x62uffer\x18\x01 \x01(\x0c\x12\x0c\n\x04size\x18\x02 \x03(\r\x12\r\n\x05\x64type\x18\x03 \x01(\t\x12\x15\n\rrequires_grad\x18\x04 \x01(\x08\x12\x38\n\x0b\x63ompression\x18\x05 \x01(\x0e\x32#.hivemind_tpu_torch.CompressionType\x12\x0e\n\x06\x63hunks\x18\x06 \x01(\r\"\x18\n\tExpertUID\x12\x0b\n\x03uid\x18\x01 \x01(\t\"[\n\rExpertRequest\x12\x0b\n\x03uid\x18\x01 \x01(\t\x12+\n\x07tensors\x18\x02 \x03(\x0b\x32\x1a.hivemind_tpu_torch.Tensor\x12\x10\n\x08metadata\x18\x03 \x01(\x0c\"O\n\x0e\x45xpertResponse\x12+\n\x07tensors\x18\x01 \x03(\x0b\x32\x1a.hivemind_tpu_torch.Tensor\x12\x10\n\x08metadata\x18\x02 \x01(\x0c\"-\n\x12\x45xpertInfoResponse\x12\x17\n\x0fserialized_info\x18\x01 \x01(\x0c*t\n\x0f\x43ompressionType\x12\x08\n\x04NONE\x10\x00\x12\x0b\n\x07\x46LOAT16\x10\x01\x12\x11\n\rMEANSTD_16BIT\x10\x02\x12\x10\n\x0cUNIFORM_8BIT\x10\x03\x12\x11\n\rQUANTILE_8BIT\x10\x04\x12\x12\n\x0e\x42LOCKWISE_8BIT\x10\x05\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'hivemind_tpu_torch.proto.runtime_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _COMPRESSIONTYPE._serialized_start=462
  _COMPRESSIONTYPE._serialized_end=578
  _TENSOR._serialized_start=63
  _TENSOR._serialized_end=213
  _EXPERTUID._serialized_start=215
  _EXPERTUID._serialized_end=239
  _EXPERTREQUEST._serialized_start=241
  _EXPERTREQUEST._serialized_end=332
  _EXPERTRESPONSE._serialized_start=334
  _EXPERTRESPONSE._serialized_end=413
  _EXPERTINFORESPONSE._serialized_start=415
  _EXPERTINFORESPONSE._serialized_end=460
# @@protoc_insertion_point(module_scope)
