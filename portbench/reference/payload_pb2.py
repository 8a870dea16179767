# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: pir_tpu/proto/payload.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1bpir_tpu/proto/payload.proto\x12\x07pir_tpu\"\x19\n\x0b\x43iphertexts\x12\n\n\x02\x63t\x18\x01 \x03(\x0c\"W\n\x07Request\x12#\n\x05query\x18\x01 \x03(\x0b\x32\x14.pir_tpu.Ciphertexts\x12\x13\n\x0bgalois_keys\x18\x02 \x01(\x0c\x12\x12\n\nrelin_keys\x18\x03 \x01(\x0c\"/\n\x08Response\x12#\n\x05reply\x18\x01 \x03(\x0b\x32\x14.pir_tpu.Ciphertexts\"\xf0\x01\n\rPIRParameters\x12\x11\n\tnum_items\x18\x01 \x01(\x04\x12\x12\n\ndimensions\x18\x02 \x03(\r\x12\x1d\n\x15\x65ncryption_parameters\x18\x03 \x01(\x0c\x12\x0e\n\x06num_pt\x18\x04 \x01(\x04\x12\x16\n\x0e\x62ytes_per_item\x18\x05 \x01(\r\x12\x1b\n\x13items_per_plaintext\x18\x06 \x01(\r\x12\x16\n\x0e\x62its_per_coeff\x18\x07 \x01(\r\x12%\n\x1duse_ciphertext_multiplication\x18\x08 \x01(\x08\x12\x15\n\rreencode_mode\x18\t \x01(\rb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'portbench.reference.payload_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CIPHERTEXTS._serialized_start=40
  _CIPHERTEXTS._serialized_end=65
  _REQUEST._serialized_start=67
  _REQUEST._serialized_end=154
  _RESPONSE._serialized_start=156
  _RESPONSE._serialized_end=203
  _PIRPARAMETERS._serialized_start=206
  _PIRPARAMETERS._serialized_end=446
# @@protoc_insertion_point(module_scope)
