# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: common.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0c\x63ommon.proto\x12\ndistar_sc2\">\n\x10\x41vailableAbility\x12\x12\n\nability_id\x18\x01 \x01(\x05\x12\x16\n\x0erequires_point\x18\x02 \x01(\x08\"T\n\tImageData\x12\x16\n\x0e\x62its_per_pixel\x18\x01 \x01(\x05\x12!\n\x04size\x18\x02 \x01(\x0b\x32\x13.distar_sc2.Size2DI\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\"\x1e\n\x06PointI\x12\t\n\x01x\x18\x01 \x01(\x05\x12\t\n\x01y\x18\x02 \x01(\x05\"L\n\nRectangleI\x12\x1e\n\x02p0\x18\x01 \x01(\x0b\x32\x12.distar_sc2.PointI\x12\x1e\n\x02p1\x18\x02 \x01(\x0b\x32\x12.distar_sc2.PointI\"\x1f\n\x07Point2D\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\"(\n\x05Point\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\x12\t\n\x01z\x18\x03 \x01(\x02\"\x1f\n\x07Size2DI\x12\t\n\x01x\x18\x01 \x01(\x05\x12\t\n\x01y\x18\x02 \x01(\x05*A\n\x04Race\x12\n\n\x06NoRace\x10\x00\x12\n\n\x06Terran\x10\x01\x12\x08\n\x04Zerg\x10\x02\x12\x0b\n\x07Protoss\x10\x03\x12\n\n\x06Random\x10\x04')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'common_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RACE._serialized_start=396
  _RACE._serialized_end=461
  _AVAILABLEABILITY._serialized_start=28
  _AVAILABLEABILITY._serialized_end=90
  _IMAGEDATA._serialized_start=92
  _IMAGEDATA._serialized_end=176
  _POINTI._serialized_start=178
  _POINTI._serialized_end=208
  _RECTANGLEI._serialized_start=210
  _RECTANGLEI._serialized_end=286
  _POINT2D._serialized_start=288
  _POINT2D._serialized_end=319
  _POINT._serialized_start=321
  _POINT._serialized_end=361
  _SIZE2DI._serialized_start=363
  _SIZE2DI._serialized_end=394
# @@protoc_insertion_point(module_scope)
