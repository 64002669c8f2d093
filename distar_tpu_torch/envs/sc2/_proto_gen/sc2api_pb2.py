# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: sc2api.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import common_pb2 as common__pb2
from . import raw_pb2 as raw__pb2
from . import score_pb2 as score__pb2
from . import spatial_pb2 as spatial__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0csc2api.proto\x12\ndistar_sc2\x1a\x0c\x63ommon.proto\x1a\traw.proto\x1a\x0bscore.proto\x1a\rspatial.proto\"\xbe\x06\n\x07Request\x12\x34\n\x0b\x63reate_game\x18\x01 \x01(\x0b\x32\x1d.distar_sc2.RequestCreateGameH\x00\x12\x30\n\tjoin_game\x18\x02 \x01(\x0b\x32\x1b.distar_sc2.RequestJoinGameH\x00\x12\x36\n\x0crestart_game\x18\x03 \x01(\x0b\x32\x1e.distar_sc2.RequestRestartGameH\x00\x12\x36\n\x0cstart_replay\x18\x04 \x01(\x0b\x32\x1e.distar_sc2.RequestStartReplayH\x00\x12\x32\n\nleave_game\x18\x05 \x01(\x0b\x32\x1c.distar_sc2.RequestLeaveGameH\x00\x12\'\n\x04quit\x18\x08 \x01(\x0b\x32\x17.distar_sc2.RequestQuitH\x00\x12\x30\n\tgame_info\x18\t \x01(\x0b\x32\x1b.distar_sc2.RequestGameInfoH\x00\x12\x35\n\x0bobservation\x18\n \x01(\x0b\x32\x1e.distar_sc2.RequestObservationH\x00\x12+\n\x06\x61\x63tion\x18\x0b \x01(\x0b\x32\x19.distar_sc2.RequestActionH\x00\x12\'\n\x04step\x18\x0c \x01(\x0b\x32\x17.distar_sc2.RequestStepH\x00\x12\'\n\x04\x64\x61ta\x18\r \x01(\x0b\x32\x17.distar_sc2.RequestDataH\x00\x12\x34\n\x0bsave_replay\x18\x0f \x01(\x0b\x32\x1d.distar_sc2.RequestSaveReplayH\x00\x12\x34\n\x0breplay_info\x18\x10 \x01(\x0b\x32\x1d.distar_sc2.RequestReplayInfoH\x00\x12:\n\x0e\x61vailable_maps\x18\x11 \x01(\x0b\x32 .distar_sc2.RequestAvailableMapsH\x00\x12.\n\x08save_map\x18\x12 \x01(\x0b\x32\x1a.distar_sc2.RequestSaveMapH\x00\x12\'\n\x04ping\x18\x13 \x01(\x0b\x32\x17.distar_sc2.RequestPingH\x00\x12\n\n\x02id\x18\x61 \x01(\rB\t\n\x07request\"\x83\x07\n\x08Response\x12\x35\n\x0b\x63reate_game\x18\x01 \x01(\x0b\x32\x1e.distar_sc2.ResponseCreateGameH\x00\x12\x31\n\tjoin_game\x18\x02 \x01(\x0b\x32\x1c.distar_sc2.ResponseJoinGameH\x00\x12\x37\n\x0crestart_game\x18\x03 \x01(\x0b\x32\x1f.distar_sc2.ResponseRestartGameH\x00\x12\x37\n\x0cstart_replay\x18\x04 \x01(\x0b\x32\x1f.distar_sc2.ResponseStartReplayH\x00\x12\x33\n\nleave_game\x18\x05 \x01(\x0b\x32\x1d.distar_sc2.ResponseLeaveGameH\x00\x12(\n\x04quit\x18\x08 \x01(\x0b\x32\x18.distar_sc2.ResponseQuitH\x00\x12\x31\n\tgame_info\x18\t \x01(\x0b\x32\x1c.distar_sc2.ResponseGameInfoH\x00\x12\x36\n\x0bobservation\x18\n \x01(\x0b\x32\x1f.distar_sc2.ResponseObservationH\x00\x12,\n\x06\x61\x63tion\x18\x0b \x01(\x0b\x32\x1a.distar_sc2.ResponseActionH\x00\x12(\n\x04step\x18\x0c \x01(\x0b\x32\x18.distar_sc2.ResponseStepH\x00\x12(\n\x04\x64\x61ta\x18\r \x01(\x0b\x32\x18.distar_sc2.ResponseDataH\x00\x12\x35\n\x0bsave_replay\x18\x0f \x01(\x0b\x32\x1e.distar_sc2.ResponseSaveReplayH\x00\x12\x35\n\x0breplay_info\x18\x10 \x01(\x0b\x32\x1e.distar_sc2.ResponseReplayInfoH\x00\x12;\n\x0e\x61vailable_maps\x18\x11 \x01(\x0b\x32!.distar_sc2.ResponseAvailableMapsH\x00\x12/\n\x08save_map\x18\x12 \x01(\x0b\x32\x1b.distar_sc2.ResponseSaveMapH\x00\x12(\n\x04ping\x18\x13 \x01(\x0b\x32\x18.distar_sc2.ResponsePingH\x00\x12\n\n\x02id\x18\x61 \x01(\r\x12\r\n\x05\x65rror\x18\x62 \x03(\t\x12\"\n\x06status\x18\x63 \x01(\x0e\x32\x12.distar_sc2.StatusB\n\n\x08response\".\n\x08LocalMap\x12\x10\n\x08map_path\x18\x01 \x01(\t\x12\x10\n\x08map_data\x18\x07 \x01(\x0c\"\xce\x01\n\x11RequestCreateGame\x12)\n\tlocal_map\x18\x01 \x01(\x0b\x32\x14.distar_sc2.LocalMapH\x00\x12\x1c\n\x12\x62\x61ttlenet_map_name\x18\x02 \x01(\tH\x00\x12-\n\x0cplayer_setup\x18\x03 \x03(\x0b\x32\x17.distar_sc2.PlayerSetup\x12\x13\n\x0b\x64isable_fog\x18\x04 \x01(\x08\x12\x13\n\x0brandom_seed\x18\x05 \x01(\r\x12\x10\n\x08realtime\x18\x06 \x01(\x08\x42\x05\n\x03Map\"\x98\x02\n\x12ResponseCreateGame\x12\x33\n\x05\x65rror\x18\x01 \x01(\x0e\x32$.distar_sc2.ResponseCreateGame.Error\x12\x15\n\rerror_details\x18\x02 \x01(\t\"\xb5\x01\n\x05\x45rror\x12\x0e\n\nMissingMap\x10\x01\x12\x12\n\x0eInvalidMapPath\x10\x02\x12\x12\n\x0eInvalidMapData\x10\x03\x12\x12\n\x0eInvalidMapName\x10\x04\x12\x14\n\x10InvalidMapHandle\x10\x05\x12\x16\n\x12MissingPlayerSetup\x10\x06\x12\x16\n\x12InvalidPlayerSetup\x10\x07\x12\x1a\n\x16MultiplayerUnsupported\x10\x08\"\xbb\x01\n\x0bPlayerSetup\x12$\n\x04type\x18\x01 \x01(\x0e\x32\x16.distar_sc2.PlayerType\x12\x1e\n\x04race\x18\x02 \x01(\x0e\x32\x10.distar_sc2.Race\x12*\n\ndifficulty\x18\x03 \x01(\x0e\x32\x16.distar_sc2.Difficulty\x12\x13\n\x0bplayer_name\x18\x04 \x01(\t\x12%\n\x08\x61i_build\x18\x05 \x01(\x0e\x32\x13.distar_sc2.AIBuild\"/\n\x07PortSet\x12\x11\n\tgame_port\x18\x01 \x01(\x05\x12\x11\n\tbase_port\x18\x02 \x01(\x05\"\xa7\x02\n\x10InterfaceOptions\x12\x0b\n\x03raw\x18\x01 \x01(\x08\x12\r\n\x05score\x18\x02 \x01(\x08\x12\x35\n\rfeature_layer\x18\x03 \x01(\x0b\x32\x1e.distar_sc2.SpatialCameraSetup\x12.\n\x06render\x18\x04 \x01(\x0b\x32\x1e.distar_sc2.SpatialCameraSetup\x12\x14\n\x0cshow_cloaked\x18\x05 \x01(\x08\x12\x1d\n\x15raw_affects_selection\x18\x06 \x01(\x08\x12!\n\x19raw_crop_to_playable_area\x18\x07 \x01(\x08\x12\x19\n\x11show_placeholders\x18\x08 \x01(\x08\x12\x1d\n\x15show_burrowed_shadows\x18\t \x01(\x08\"\xa2\x02\n\x0fRequestJoinGame\x12 \n\x04race\x18\x01 \x01(\x0e\x32\x10.distar_sc2.RaceH\x00\x12\x1c\n\x12observed_player_id\x18\x02 \x01(\rH\x00\x12-\n\x07options\x18\x03 \x01(\x0b\x32\x1c.distar_sc2.InterfaceOptions\x12)\n\x0cserver_ports\x18\x04 \x01(\x0b\x32\x13.distar_sc2.PortSet\x12)\n\x0c\x63lient_ports\x18\x05 \x03(\x0b\x32\x13.distar_sc2.PortSet\x12\x13\n\x0bshared_port\x18\x06 \x01(\x05\x12\x13\n\x0bplayer_name\x18\x07 \x01(\t\x12\x0f\n\x07host_ip\x18\x08 \x01(\tB\x0f\n\rparticipation\"\xfe\x02\n\x10ResponseJoinGame\x12\x11\n\tplayer_id\x18\x01 \x01(\r\x12\x31\n\x05\x65rror\x18\x02 \x01(\x0e\x32\".distar_sc2.ResponseJoinGame.Error\x12\x15\n\rerror_details\x18\x03 \x01(\t\"\x8c\x02\n\x05\x45rror\x12\x18\n\x14MissingParticipation\x10\x01\x12\x1b\n\x17InvalidObservedPlayerId\x10\x02\x12\x12\n\x0eMissingOptions\x10\x03\x12\x10\n\x0cMissingPorts\x10\x04\x12\x0c\n\x08GameFull\x10\x05\x12\x0f\n\x0bLaunchError\x10\x06\x12\x16\n\x12\x46\x65\x61tureUnsupported\x10\x07\x12\x12\n\x0eNoSpaceForUser\x10\x08\x12\x13\n\x0fMapDoesNotExist\x10\t\x12\x11\n\rCannotOpenMap\x10\n\x12\x11\n\rChecksumError\x10\x0b\x12\x10\n\x0cNetworkError\x10\x0c\x12\x0e\n\nOtherError\x10\r\"\x14\n\x12RequestRestartGame\"\x95\x01\n\x13ResponseRestartGame\x12\x34\n\x05\x65rror\x18\x01 \x01(\x0e\x32%.distar_sc2.ResponseRestartGame.Error\x12\x15\n\rerror_details\x18\x02 \x01(\t\x12\x17\n\x0fneed_hard_reset\x18\x03 \x01(\x08\"\x18\n\x05\x45rror\x12\x0f\n\x0bLaunchError\x10\x01\"\xe7\x01\n\x12RequestStartReplay\x12\x15\n\x0breplay_path\x18\x01 \x01(\tH\x00\x12\x15\n\x0breplay_data\x18\x05 \x01(\x0cH\x00\x12\x10\n\x08map_data\x18\x06 \x01(\x0c\x12\x1a\n\x12observed_player_id\x18\x02 \x01(\x05\x12-\n\x07options\x18\x03 \x01(\x0b\x32\x1c.distar_sc2.InterfaceOptions\x12\x13\n\x0b\x64isable_fog\x18\x04 \x01(\x08\x12\x10\n\x08realtime\x18\x07 \x01(\x08\x12\x15\n\rrecord_replay\x18\x08 \x01(\x08\x42\x08\n\x06replay\"\x83\x02\n\x13ResponseStartReplay\x12\x34\n\x05\x65rror\x18\x01 \x01(\x0e\x32%.distar_sc2.ResponseStartReplay.Error\x12\x15\n\rerror_details\x18\x02 \x01(\t\"\x9e\x01\n\x05\x45rror\x12\x11\n\rMissingReplay\x10\x01\x12\x15\n\x11InvalidReplayPath\x10\x02\x12\x15\n\x11InvalidReplayData\x10\x03\x12\x12\n\x0eInvalidMapData\x10\x04\x12\x1b\n\x17InvalidObservedPlayerId\x10\x05\x12\x12\n\x0eMissingOptions\x10\x06\x12\x0f\n\x0bLaunchError\x10\x07\"\x12\n\x10RequestLeaveGame\"\x13\n\x11ResponseLeaveGame\"\r\n\x0bRequestQuit\"\x0e\n\x0cResponseQuit\"\x11\n\x0fRequestGameInfo\"\xfe\x01\n\nPlayerInfo\x12\x11\n\tplayer_id\x18\x01 \x01(\r\x12$\n\x04type\x18\x02 \x01(\x0e\x32\x16.distar_sc2.PlayerType\x12(\n\x0erace_requested\x18\x03 \x01(\x0e\x32\x10.distar_sc2.Race\x12%\n\x0brace_actual\x18\x04 \x01(\x0e\x32\x10.distar_sc2.Race\x12*\n\ndifficulty\x18\x05 \x01(\x0e\x32\x16.distar_sc2.Difficulty\x12\x13\n\x0bplayer_name\x18\x06 \x01(\t\x12%\n\x08\x61i_build\x18\x07 \x01(\x0e\x32\x13.distar_sc2.AIBuild\"\xd4\x01\n\x10ResponseGameInfo\x12\x10\n\x08map_name\x18\x01 \x01(\t\x12\x16\n\x0elocal_map_path\x18\x02 \x01(\t\x12+\n\x0bplayer_info\x18\x03 \x03(\x0b\x32\x16.distar_sc2.PlayerInfo\x12\'\n\tstart_raw\x18\x04 \x01(\x0b\x32\x14.distar_sc2.StartRaw\x12-\n\x07options\x18\x05 \x01(\x0b\x32\x1c.distar_sc2.InterfaceOptions\x12\x11\n\tmod_names\x18\x06 \x03(\t\"\r\n\x0bRequestPing\"b\n\x0cResponsePing\x12\x14\n\x0cgame_version\x18\x01 \x01(\t\x12\x14\n\x0c\x64\x61ta_version\x18\x02 \x01(\t\x12\x12\n\ndata_build\x18\x03 \x01(\r\x12\x12\n\nbase_build\x18\x04 \x01(\r\"<\n\x12RequestObservation\x12\x13\n\x0b\x64isable_fog\x18\x01 \x01(\x08\x12\x11\n\tgame_loop\x18\x02 \x01(\r\"\xf1\x01\n\x13ResponseObservation\x12#\n\x07\x61\x63tions\x18\x01 \x03(\x0b\x32\x12.distar_sc2.Action\x12.\n\raction_errors\x18\x02 \x03(\x0b\x32\x17.distar_sc2.ActionError\x12,\n\x0bobservation\x18\x03 \x01(\x0b\x32\x17.distar_sc2.Observation\x12/\n\rplayer_result\x18\x04 \x03(\x0b\x32\x18.distar_sc2.PlayerResult\x12&\n\x04\x63hat\x18\x05 \x03(\x0b\x32\x18.distar_sc2.ChatReceived\"2\n\x0c\x43hatReceived\x12\x11\n\tplayer_id\x18\x01 \x01(\r\x12\x0f\n\x07message\x18\x02 \x01(\t\"C\n\x0b\x41\x63tionError\x12\x10\n\x08unit_tag\x18\x01 \x01(\x04\x12\x12\n\nability_id\x18\x02 \x01(\x04\x12\x0e\n\x06result\x18\x03 \x01(\x05\"\xef\x01\n\x0cPlayerCommon\x12\x11\n\tplayer_id\x18\x01 \x01(\r\x12\x10\n\x08minerals\x18\x02 \x01(\r\x12\x0f\n\x07vespene\x18\x03 \x01(\r\x12\x10\n\x08\x66ood_cap\x18\x04 \x01(\r\x12\x11\n\tfood_used\x18\x05 \x01(\r\x12\x11\n\tfood_army\x18\x06 \x01(\r\x12\x14\n\x0c\x66ood_workers\x18\x07 \x01(\r\x12\x19\n\x11idle_worker_count\x18\x08 \x01(\r\x12\x12\n\narmy_count\x18\t \x01(\r\x12\x17\n\x0fwarp_gate_count\x18\n \x01(\r\x12\x13\n\x0blarva_count\x18\x0b \x01(\r\"\xb6\x02\n\x0bObservation\x12/\n\rplayer_common\x18\x01 \x01(\x0b\x32\x18.distar_sc2.PlayerCommon\x12/\n\tabilities\x18\x03 \x03(\x0b\x32\x1c.distar_sc2.AvailableAbility\x12 \n\x05score\x18\x04 \x01(\x0b\x32\x11.distar_sc2.Score\x12,\n\x08raw_data\x18\x05 \x01(\x0b\x32\x1a.distar_sc2.ObservationRaw\x12?\n\x12\x66\x65\x61ture_layer_data\x18\x06 \x01(\x0b\x32#.distar_sc2.ObservationFeatureLayer\x12\x11\n\tgame_loop\x18\t \x01(\r\x12!\n\x06\x61lerts\x18\n \x03(\x0e\x32\x11.distar_sc2.Alert\"r\n\nActionChat\x12/\n\x07\x63hannel\x18\x01 \x01(\x0e\x32\x1e.distar_sc2.ActionChat.Channel\x12\x0f\n\x07message\x18\x02 \x01(\t\"\"\n\x07\x43hannel\x12\r\n\tBroadcast\x10\x01\x12\x08\n\x04Team\x10\x02\"s\n\x06\x41\x63tion\x12)\n\naction_raw\x18\x01 \x01(\x0b\x32\x15.distar_sc2.ActionRaw\x12+\n\x0b\x61\x63tion_chat\x18\x06 \x01(\x0b\x32\x16.distar_sc2.ActionChat\x12\x11\n\tgame_loop\x18\x07 \x01(\r\"E\n\x0cPlayerResult\x12\x11\n\tplayer_id\x18\x01 \x01(\r\x12\"\n\x06result\x18\x02 \x01(\x0e\x32\x12.distar_sc2.Result\"4\n\rRequestAction\x12#\n\x07\x61\x63tions\x18\x01 \x03(\x0b\x32\x12.distar_sc2.Action\" \n\x0eResponseAction\x12\x0e\n\x06result\x18\x01 \x03(\x05\"\x1c\n\x0bRequestStep\x12\r\n\x05\x63ount\x18\x01 \x01(\r\"\'\n\x0cResponseStep\x12\x17\n\x0fsimulation_loop\x18\x01 \x01(\r\"\x13\n\x11RequestSaveReplay\"\"\n\x12ResponseSaveReplay\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\"b\n\x11RequestReplayInfo\x12\x15\n\x0breplay_path\x18\x01 \x01(\tH\x00\x12\x15\n\x0breplay_data\x18\x02 \x01(\x0cH\x00\x12\x15\n\rdownload_data\x18\x03 \x01(\x08\x42\x08\n\x06replay\"\x97\x01\n\x0fPlayerInfoExtra\x12+\n\x0bplayer_info\x18\x01 \x01(\x0b\x32\x16.distar_sc2.PlayerInfo\x12/\n\rplayer_result\x18\x02 \x01(\x0b\x32\x18.distar_sc2.PlayerResult\x12\x12\n\nplayer_mmr\x18\x03 \x01(\x05\x12\x12\n\nplayer_apm\x18\x04 \x01(\x05\"\xbb\x03\n\x12ResponseReplayInfo\x12\x10\n\x08map_name\x18\x01 \x01(\t\x12\x16\n\x0elocal_map_path\x18\x02 \x01(\t\x12\x30\n\x0bplayer_info\x18\x03 \x03(\x0b\x32\x1b.distar_sc2.PlayerInfoExtra\x12\x1b\n\x13game_duration_loops\x18\x04 \x01(\r\x12\x1d\n\x15game_duration_seconds\x18\x05 \x01(\x02\x12\x14\n\x0cgame_version\x18\x06 \x01(\t\x12\x12\n\ndata_build\x18\x07 \x01(\r\x12\x12\n\nbase_build\x18\x08 \x01(\r\x12\x33\n\x05\x65rror\x18\t \x01(\x0e\x32$.distar_sc2.ResponseReplayInfo.Error\x12\x15\n\rerror_details\x18\n \x01(\t\x12\x14\n\x0c\x64\x61ta_version\x18\x0b \x01(\t\"m\n\x05\x45rror\x12\x11\n\rMissingReplay\x10\x01\x12\x15\n\x11InvalidReplayPath\x10\x02\x12\x15\n\x11InvalidReplayData\x10\x03\x12\x10\n\x0cParsingError\x10\x04\x12\x11\n\rDownloadError\x10\x05\"\x16\n\x14RequestAvailableMaps\"M\n\x15ResponseAvailableMaps\x12\x17\n\x0flocal_map_paths\x18\x01 \x03(\t\x12\x1b\n\x13\x62\x61ttlenet_map_names\x18\x02 \x03(\t\"4\n\x0eRequestSaveMap\x12\x10\n\x08map_path\x18\x01 \x01(\t\x12\x10\n\x08map_data\x18\x02 \x01(\x0c\"`\n\x0fResponseSaveMap\x12\x30\n\x05\x65rror\x18\x01 \x01(\x0e\x32!.distar_sc2.ResponseSaveMap.Error\"\x1b\n\x05\x45rror\x12\x12\n\x0eInvalidMapData\x10\x01\"o\n\x0bRequestData\x12\x12\n\nability_id\x18\x01 \x01(\x08\x12\x14\n\x0cunit_type_id\x18\x02 \x01(\x08\x12\x12\n\nupgrade_id\x18\x03 \x01(\x08\x12\x0f\n\x07\x62uff_id\x18\x04 \x01(\x08\x12\x11\n\teffect_id\x18\x05 \x01(\x08\"\xa2\x01\n\x0b\x41\x62ilityData\x12\x12\n\nability_id\x18\x01 \x01(\r\x12\x11\n\tlink_name\x18\x02 \x01(\t\x12\x12\n\nlink_index\x18\x03 \x01(\r\x12\x13\n\x0b\x62utton_name\x18\x04 \x01(\t\x12\x15\n\rfriendly_name\x18\x05 \x01(\t\x12\x0e\n\x06hotkey\x18\x06 \x01(\t\x12\x1c\n\x14remaps_to_ability_id\x18\x07 \x01(\r\"l\n\x0cUnitTypeData\x12\x0f\n\x07unit_id\x18\x01 \x01(\r\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x11\n\tavailable\x18\x03 \x01(\x08\x12\x12\n\ncargo_size\x18\x04 \x01(\r\x12\x16\n\x0emovement_speed\x18\x05 \x01(\r\"/\n\x0bUpgradeData\x12\x12\n\nupgrade_id\x18\x01 \x01(\r\x12\x0c\n\x04name\x18\x02 \x01(\t\")\n\x08\x42uffData\x12\x0f\n\x07\x62uff_id\x18\x01 \x01(\r\x12\x0c\n\x04name\x18\x02 \x01(\t\"T\n\nEffectData\x12\x11\n\teffect_id\x18\x01 \x01(\r\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x15\n\rfriendly_name\x18\x03 \x01(\t\x12\x0e\n\x06radius\x18\x04 \x01(\x02\"\xdc\x01\n\x0cResponseData\x12*\n\tabilities\x18\x01 \x03(\x0b\x32\x17.distar_sc2.AbilityData\x12\'\n\x05units\x18\x02 \x03(\x0b\x32\x18.distar_sc2.UnitTypeData\x12)\n\x08upgrades\x18\x03 \x03(\x0b\x32\x17.distar_sc2.UpgradeData\x12#\n\x05\x62uffs\x18\x04 \x03(\x0b\x32\x14.distar_sc2.BuffData\x12\'\n\x07\x65\x66\x66\x65\x63ts\x18\x05 \x03(\x0b\x32\x16.distar_sc2.EffectData*c\n\x06Status\x12\x0c\n\x08launched\x10\x01\x12\r\n\tinit_game\x10\x02\x12\x0b\n\x07in_game\x10\x03\x12\r\n\tin_replay\x10\x04\x12\t\n\x05\x65nded\x10\x05\x12\x08\n\x04quit\x10\x06\x12\x0b\n\x07unknown\x10\x63*9\n\nPlayerType\x12\x0f\n\x0bParticipant\x10\x01\x12\x0c\n\x08\x43omputer\x10\x02\x12\x0c\n\x08Observer\x10\x03*\x96\x01\n\nDifficulty\x12\x0c\n\x08VeryEasy\x10\x01\x12\x08\n\x04\x45\x61sy\x10\x02\x12\n\n\x06Medium\x10\x03\x12\x0e\n\nMediumHard\x10\x04\x12\x08\n\x04Hard\x10\x05\x12\n\n\x06Harder\x10\x06\x12\x0c\n\x08VeryHard\x10\x07\x12\x0f\n\x0b\x43heatVision\x10\x08\x12\x0e\n\nCheatMoney\x10\t\x12\x0f\n\x0b\x43heatInsane\x10\n*O\n\x07\x41IBuild\x12\x0f\n\x0bRandomBuild\x10\x01\x12\x08\n\x04Rush\x10\x02\x12\n\n\x06Timing\x10\x03\x12\t\n\x05Power\x10\x04\x12\t\n\x05Macro\x10\x05\x12\x07\n\x03\x41ir\x10\x06*\xdb\x03\n\x05\x41lert\x12\x19\n\x15NuclearLaunchDetected\x10\x01\x12\x15\n\x11NydusWormDetected\x10\x02\x12\x0e\n\nAlertError\x10\x03\x12\x11\n\rAddOnComplete\x10\x04\x12\x14\n\x10\x42uildingComplete\x10\x05\x12\x17\n\x13\x42uildingUnderAttack\x10\x06\x12\x10\n\x0cLarvaHatched\x10\x07\x12\x11\n\rMergeComplete\x10\x08\x12\x15\n\x11MineralsExhausted\x10\t\x12\x11\n\rMorphComplete\x10\n\x12\x16\n\x12MothershipComplete\x10\x0b\x12\x0f\n\x0bMULEExpired\x10\x0c\x12\x10\n\x0cNukeComplete\x10\r\x12\x14\n\x10ResearchComplete\x10\x0e\x12\x0e\n\nTrainError\x10\x0f\x12\x15\n\x11TrainUnitComplete\x10\x10\x12\x17\n\x13TrainWorkerComplete\x10\x11\x12\x1a\n\x16TransformationComplete\x10\x12\x12\x13\n\x0fUnitUnderAttack\x10\x13\x12\x13\n\x0fUpgradeComplete\x10\x14\x12\x14\n\x10VespeneExhausted\x10\x15\x12\x12\n\x0eWarpInComplete\x10\x16*9\n\x06Result\x12\x0b\n\x07Victory\x10\x01\x12\n\n\x06\x44\x65\x66\x65\x61t\x10\x02\x12\x07\n\x03Tie\x10\x03\x12\r\n\tUndecided\x10\x04')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'sc2api_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _STATUS._serialized_start=8165
  _STATUS._serialized_end=8264
  _PLAYERTYPE._serialized_start=8266
  _PLAYERTYPE._serialized_end=8323
  _DIFFICULTY._serialized_start=8326
  _DIFFICULTY._serialized_end=8476
  _AIBUILD._serialized_start=8478
  _AIBUILD._serialized_end=8557
  _ALERT._serialized_start=8560
  _ALERT._serialized_end=9035
  _RESULT._serialized_start=9037
  _RESULT._serialized_end=9094
  _REQUEST._serialized_start=82
  _REQUEST._serialized_end=912
  _RESPONSE._serialized_start=915
  _RESPONSE._serialized_end=1814
  _LOCALMAP._serialized_start=1816
  _LOCALMAP._serialized_end=1862
  _REQUESTCREATEGAME._serialized_start=1865
  _REQUESTCREATEGAME._serialized_end=2071
  _RESPONSECREATEGAME._serialized_start=2074
  _RESPONSECREATEGAME._serialized_end=2354
  _RESPONSECREATEGAME_ERROR._serialized_start=2173
  _RESPONSECREATEGAME_ERROR._serialized_end=2354
  _PLAYERSETUP._serialized_start=2357
  _PLAYERSETUP._serialized_end=2544
  _PORTSET._serialized_start=2546
  _PORTSET._serialized_end=2593
  _INTERFACEOPTIONS._serialized_start=2596
  _INTERFACEOPTIONS._serialized_end=2891
  _REQUESTJOINGAME._serialized_start=2894
  _REQUESTJOINGAME._serialized_end=3184
  _RESPONSEJOINGAME._serialized_start=3187
  _RESPONSEJOINGAME._serialized_end=3569
  _RESPONSEJOINGAME_ERROR._serialized_start=3301
  _RESPONSEJOINGAME_ERROR._serialized_end=3569
  _REQUESTRESTARTGAME._serialized_start=3571
  _REQUESTRESTARTGAME._serialized_end=3591
  _RESPONSERESTARTGAME._serialized_start=3594
  _RESPONSERESTARTGAME._serialized_end=3743
  _RESPONSERESTARTGAME_ERROR._serialized_start=3719
  _RESPONSERESTARTGAME_ERROR._serialized_end=3743
  _REQUESTSTARTREPLAY._serialized_start=3746
  _REQUESTSTARTREPLAY._serialized_end=3977
  _RESPONSESTARTREPLAY._serialized_start=3980
  _RESPONSESTARTREPLAY._serialized_end=4239
  _RESPONSESTARTREPLAY_ERROR._serialized_start=4081
  _RESPONSESTARTREPLAY_ERROR._serialized_end=4239
  _REQUESTLEAVEGAME._serialized_start=4241
  _REQUESTLEAVEGAME._serialized_end=4259
  _RESPONSELEAVEGAME._serialized_start=4261
  _RESPONSELEAVEGAME._serialized_end=4280
  _REQUESTQUIT._serialized_start=4282
  _REQUESTQUIT._serialized_end=4295
  _RESPONSEQUIT._serialized_start=4297
  _RESPONSEQUIT._serialized_end=4311
  _REQUESTGAMEINFO._serialized_start=4313
  _REQUESTGAMEINFO._serialized_end=4330
  _PLAYERINFO._serialized_start=4333
  _PLAYERINFO._serialized_end=4587
  _RESPONSEGAMEINFO._serialized_start=4590
  _RESPONSEGAMEINFO._serialized_end=4802
  _REQUESTPING._serialized_start=4804
  _REQUESTPING._serialized_end=4817
  _RESPONSEPING._serialized_start=4819
  _RESPONSEPING._serialized_end=4917
  _REQUESTOBSERVATION._serialized_start=4919
  _REQUESTOBSERVATION._serialized_end=4979
  _RESPONSEOBSERVATION._serialized_start=4982
  _RESPONSEOBSERVATION._serialized_end=5223
  _CHATRECEIVED._serialized_start=5225
  _CHATRECEIVED._serialized_end=5275
  _ACTIONERROR._serialized_start=5277
  _ACTIONERROR._serialized_end=5344
  _PLAYERCOMMON._serialized_start=5347
  _PLAYERCOMMON._serialized_end=5586
  _OBSERVATION._serialized_start=5589
  _OBSERVATION._serialized_end=5899
  _ACTIONCHAT._serialized_start=5901
  _ACTIONCHAT._serialized_end=6015
  _ACTIONCHAT_CHANNEL._serialized_start=5981
  _ACTIONCHAT_CHANNEL._serialized_end=6015
  _ACTION._serialized_start=6017
  _ACTION._serialized_end=6132
  _PLAYERRESULT._serialized_start=6134
  _PLAYERRESULT._serialized_end=6203
  _REQUESTACTION._serialized_start=6205
  _REQUESTACTION._serialized_end=6257
  _RESPONSEACTION._serialized_start=6259
  _RESPONSEACTION._serialized_end=6291
  _REQUESTSTEP._serialized_start=6293
  _REQUESTSTEP._serialized_end=6321
  _RESPONSESTEP._serialized_start=6323
  _RESPONSESTEP._serialized_end=6362
  _REQUESTSAVEREPLAY._serialized_start=6364
  _REQUESTSAVEREPLAY._serialized_end=6383
  _RESPONSESAVEREPLAY._serialized_start=6385
  _RESPONSESAVEREPLAY._serialized_end=6419
  _REQUESTREPLAYINFO._serialized_start=6421
  _REQUESTREPLAYINFO._serialized_end=6519
  _PLAYERINFOEXTRA._serialized_start=6522
  _PLAYERINFOEXTRA._serialized_end=6673
  _RESPONSEREPLAYINFO._serialized_start=6676
  _RESPONSEREPLAYINFO._serialized_end=7119
  _RESPONSEREPLAYINFO_ERROR._serialized_start=7010
  _RESPONSEREPLAYINFO_ERROR._serialized_end=7119
  _REQUESTAVAILABLEMAPS._serialized_start=7121
  _REQUESTAVAILABLEMAPS._serialized_end=7143
  _RESPONSEAVAILABLEMAPS._serialized_start=7145
  _RESPONSEAVAILABLEMAPS._serialized_end=7222
  _REQUESTSAVEMAP._serialized_start=7224
  _REQUESTSAVEMAP._serialized_end=7276
  _RESPONSESAVEMAP._serialized_start=7278
  _RESPONSESAVEMAP._serialized_end=7374
  _RESPONSESAVEMAP_ERROR._serialized_start=7347
  _RESPONSESAVEMAP_ERROR._serialized_end=7374
  _REQUESTDATA._serialized_start=7376
  _REQUESTDATA._serialized_end=7487
  _ABILITYDATA._serialized_start=7490
  _ABILITYDATA._serialized_end=7652
  _UNITTYPEDATA._serialized_start=7654
  _UNITTYPEDATA._serialized_end=7762
  _UPGRADEDATA._serialized_start=7764
  _UPGRADEDATA._serialized_end=7811
  _BUFFDATA._serialized_start=7813
  _BUFFDATA._serialized_end=7854
  _EFFECTDATA._serialized_start=7856
  _EFFECTDATA._serialized_end=7940
  _RESPONSEDATA._serialized_start=7943
  _RESPONSEDATA._serialized_end=8163
# @@protoc_insertion_point(module_scope)
