# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: spatial.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import common_pb2 as common__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rspatial.proto\x12\ndistar_sc2\x1a\x0c\x63ommon.proto\"\xbb\x01\n\x12SpatialCameraSetup\x12\r\n\x05width\x18\x01 \x01(\x02\x12\'\n\nresolution\x18\x02 \x01(\x0b\x32\x13.distar_sc2.Size2DI\x12/\n\x12minimap_resolution\x18\x03 \x01(\x0b\x32\x13.distar_sc2.Size2DI\x12\x1d\n\x15\x63rop_to_playable_area\x18\x04 \x01(\x08\x12\x1d\n\x15\x61llow_cheating_layers\x18\x05 \x01(\x08\"\x80\x01\n\x17ObservationFeatureLayer\x12*\n\x07renders\x18\x01 \x01(\x0b\x32\x19.distar_sc2.FeatureLayers\x12\x39\n\x0fminimap_renders\x18\x02 \x01(\x0b\x32 .distar_sc2.FeatureLayersMinimap\"\xb0\t\n\rFeatureLayers\x12)\n\nheight_map\x18\x01 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12-\n\x0evisibility_map\x18\x02 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12$\n\x05\x63reep\x18\x03 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12$\n\x05power\x18\x04 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12(\n\tplayer_id\x18\x05 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12(\n\tunit_type\x18\x06 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12\'\n\x08selected\x18\x07 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12.\n\x0funit_hit_points\x18\x08 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12\x34\n\x15unit_hit_points_ratio\x18\x11 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12*\n\x0bunit_energy\x18\t \x01(\x0b\x32\x15.distar_sc2.ImageData\x12\x30\n\x11unit_energy_ratio\x18\x12 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12+\n\x0cunit_shields\x18\n \x01(\x0b\x32\x15.distar_sc2.ImageData\x12\x31\n\x12unit_shields_ratio\x18\x13 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12.\n\x0fplayer_relative\x18\x0b \x01(\x0b\x32\x15.distar_sc2.ImageData\x12.\n\x0funit_density_aa\x18\x0e \x01(\x0b\x32\x15.distar_sc2.ImageData\x12+\n\x0cunit_density\x18\x0f \x01(\x0b\x32\x15.distar_sc2.ImageData\x12&\n\x07\x65\x66\x66\x65\x63ts\x18\x14 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12-\n\x0ehallucinations\x18\x15 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12&\n\x07\x63loaked\x18\x16 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12#\n\x04\x62lip\x18\x17 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12$\n\x05\x62uffs\x18\x18 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12,\n\rbuff_duration\x18\x1a \x01(\x0b\x32\x15.distar_sc2.ImageData\x12%\n\x06\x61\x63tive\x18\x19 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12-\n\x0e\x62uild_progress\x18\x1b \x01(\x0b\x32\x15.distar_sc2.ImageData\x12(\n\tbuildable\x18\x1c \x01(\x0b\x32\x15.distar_sc2.ImageData\x12\'\n\x08pathable\x18\x1d \x01(\x0b\x32\x15.distar_sc2.ImageData\x12*\n\x0bplaceholder\x18\x1e \x01(\x0b\x32\x15.distar_sc2.ImageData\"\xe4\x03\n\x14\x46\x65\x61tureLayersMinimap\x12)\n\nheight_map\x18\x01 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12-\n\x0evisibility_map\x18\x02 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12$\n\x05\x63reep\x18\x03 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12%\n\x06\x63\x61mera\x18\x04 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12(\n\tplayer_id\x18\x05 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12.\n\x0fplayer_relative\x18\x06 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12\'\n\x08selected\x18\x07 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12(\n\tunit_type\x18\x08 \x01(\x0b\x32\x15.distar_sc2.ImageData\x12%\n\x06\x61lerts\x18\t \x01(\x0b\x32\x15.distar_sc2.ImageData\x12(\n\tbuildable\x18\n \x01(\x0b\x32\x15.distar_sc2.ImageData\x12\'\n\x08pathable\x18\x0b \x01(\x0b\x32\x15.distar_sc2.ImageData')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'spatial_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SPATIALCAMERASETUP._serialized_start=44
  _SPATIALCAMERASETUP._serialized_end=231
  _OBSERVATIONFEATURELAYER._serialized_start=234
  _OBSERVATIONFEATURELAYER._serialized_end=362
  _FEATURELAYERS._serialized_start=365
  _FEATURELAYERS._serialized_end=1565
  _FEATURELAYERSMINIMAP._serialized_start=1568
  _FEATURELAYERSMINIMAP._serialized_end=2052
# @@protoc_insertion_point(module_scope)
