# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: node.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nnode.proto\x12\tp2pfl_tpu\"\x8c\x01\n\x08\x45nvelope\x12\x0e\n\x06source\x18\x01 \x01(\t\x12\x0b\n\x03\x63md\x18\x02 \x01(\t\x12\r\n\x05round\x18\x03 \x01(\r\x12%\n\x07\x63ontrol\x18\x04 \x01(\x0b\x32\x12.p2pfl_tpu.ControlH\x00\x12%\n\x07weights\x18\x05 \x01(\x0b\x32\x12.p2pfl_tpu.WeightsH\x00\x42\x06\n\x04\x62ody\"4\n\x07\x43ontrol\x12\x0c\n\x04\x61rgs\x18\x01 \x03(\t\x12\x0b\n\x03ttl\x18\x02 \x01(\r\x12\x0e\n\x06msg_id\x18\x03 \x01(\x06\"E\n\x07Weights\x12\x0f\n\x07payload\x18\x01 \x01(\x0c\x12\x14\n\x0c\x63ontributors\x18\x02 \x03(\t\x12\x13\n\x0bnum_samples\x18\x03 \x01(\x04\"\x15\n\x05Hello\x12\x0c\n\x04\x61\x64\x64r\x18\x01 \x01(\t\"\x14\n\x03\x41\x63k\x12\r\n\x05\x65rror\x18\x01 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'node_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ENVELOPE._serialized_start=26
  _ENVELOPE._serialized_end=166
  _CONTROL._serialized_start=168
  _CONTROL._serialized_end=220
  _WEIGHTS._serialized_start=222
  _WEIGHTS._serialized_end=291
  _HELLO._serialized_start=293
  _HELLO._serialized_end=314
  _ACK._serialized_start=316
  _ACK._serialized_end=336
# @@protoc_insertion_point(module_scope)
