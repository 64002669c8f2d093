# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: score.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bscore.proto\x12\ndistar_sc2\"h\n\x14\x43\x61tegoryScoreDetails\x12\x0c\n\x04none\x18\x01 \x01(\x02\x12\x0c\n\x04\x61rmy\x18\x02 \x01(\x02\x12\x0f\n\x07\x65\x63onomy\x18\x03 \x01(\x02\x12\x12\n\ntechnology\x18\x04 \x01(\x02\x12\x0f\n\x07upgrade\x18\x05 \x01(\x02\"B\n\x11VitalScoreDetails\x12\x0c\n\x04life\x18\x01 \x01(\x02\x12\x0f\n\x07shields\x18\x02 \x01(\x02\x12\x0e\n\x06\x65nergy\x18\x03 \x01(\x02\"\xd2\t\n\x0cScoreDetails\x12\x1c\n\x14idle_production_time\x18\x01 \x01(\x02\x12\x18\n\x10idle_worker_time\x18\x02 \x01(\x02\x12\x19\n\x11total_value_units\x18\x03 \x01(\x02\x12\x1e\n\x16total_value_structures\x18\x04 \x01(\x02\x12\x1a\n\x12killed_value_units\x18\x05 \x01(\x02\x12\x1f\n\x17killed_value_structures\x18\x06 \x01(\x02\x12\x1a\n\x12\x63ollected_minerals\x18\x07 \x01(\x02\x12\x19\n\x11\x63ollected_vespene\x18\x08 \x01(\x02\x12 \n\x18\x63ollection_rate_minerals\x18\t \x01(\x02\x12\x1f\n\x17\x63ollection_rate_vespene\x18\n \x01(\x02\x12\x16\n\x0espent_minerals\x18\x0b \x01(\x02\x12\x15\n\rspent_vespene\x18\x0c \x01(\x02\x12\x33\n\tfood_used\x18\r \x01(\x0b\x32 .distar_sc2.CategoryScoreDetails\x12\x39\n\x0fkilled_minerals\x18\x0e \x01(\x0b\x32 .distar_sc2.CategoryScoreDetails\x12\x38\n\x0ekilled_vespene\x18\x0f \x01(\x0b\x32 .distar_sc2.CategoryScoreDetails\x12\x37\n\rlost_minerals\x18\x10 \x01(\x0b\x32 .distar_sc2.CategoryScoreDetails\x12\x36\n\x0clost_vespene\x18\x11 \x01(\x0b\x32 .distar_sc2.CategoryScoreDetails\x12@\n\x16\x66riendly_fire_minerals\x18\x12 \x01(\x0b\x32 .distar_sc2.CategoryScoreDetails\x12?\n\x15\x66riendly_fire_vespene\x18\x13 \x01(\x0b\x32 .distar_sc2.CategoryScoreDetails\x12\x37\n\rused_minerals\x18\x14 \x01(\x0b\x32 .distar_sc2.CategoryScoreDetails\x12\x36\n\x0cused_vespene\x18\x15 \x01(\x0b\x32 .distar_sc2.CategoryScoreDetails\x12=\n\x13total_used_minerals\x18\x16 \x01(\x0b\x32 .distar_sc2.CategoryScoreDetails\x12<\n\x12total_used_vespene\x18\x17 \x01(\x0b\x32 .distar_sc2.CategoryScoreDetails\x12\x39\n\x12total_damage_dealt\x18\x18 \x01(\x0b\x32\x1d.distar_sc2.VitalScoreDetails\x12\x39\n\x12total_damage_taken\x18\x19 \x01(\x0b\x32\x1d.distar_sc2.VitalScoreDetails\x12\x33\n\x0ctotal_healed\x18\x1a \x01(\x0b\x32\x1d.distar_sc2.VitalScoreDetails\x12\x13\n\x0b\x63urrent_apm\x18\x1b \x01(\x02\x12\x1d\n\x15\x63urrent_effective_apm\x18\x1c \x01(\x02\"\xa0\x01\n\x05Score\x12/\n\nscore_type\x18\x06 \x01(\x0e\x32\x1b.distar_sc2.Score.ScoreType\x12\r\n\x05score\x18\x07 \x01(\x05\x12/\n\rscore_details\x18\x08 \x01(\x0b\x32\x18.distar_sc2.ScoreDetails\"&\n\tScoreType\x12\x0e\n\nCurriculum\x10\x01\x12\t\n\x05Melee\x10\x02')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'score_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CATEGORYSCOREDETAILS._serialized_start=27
  _CATEGORYSCOREDETAILS._serialized_end=131
  _VITALSCOREDETAILS._serialized_start=133
  _VITALSCOREDETAILS._serialized_end=199
  _SCOREDETAILS._serialized_start=202
  _SCOREDETAILS._serialized_end=1436
  _SCORE._serialized_start=1439
  _SCORE._serialized_end=1599
  _SCORE_SCORETYPE._serialized_start=1561
  _SCORE_SCORETYPE._serialized_end=1599
# @@protoc_insertion_point(module_scope)
