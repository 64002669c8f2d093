"""The SC2 client layer (the reference's pysc2-fork role, L1).

Counterpart of ``distar_tpu.envs.sc2``, with the same exports. Modules:
  proto              — s2client protobuf resolution (pip package or vendored)
  wsclient           — the port's stdlib RFC 6455 client (no websocket-client)
  protocol           — websocket request/response framing + status machine
  remote_controller  — blocking python calls onto the SC2 api
  sc_process         — binary launch / port / teardown
  run_configs        — version routing + platform install discovery
  maps               — map registry (sizes, localized names, install)
  replay_header      — a replay's MPQ header (build, duration)
  launcher           — N-process create/join orchestration -> RealSC2Env
  lan                — the remote human showmatch (handshake, LanSC2Env)
  fake_sc2           — in-process fake SC2 websocket server (tests/demos)
"""
from .proto import PROVIDER, Status, sc_pb  # noqa: F401
from .remote_controller import RemoteController, ConnectError, RequestError  # noqa: F401
from .protocol import ConnectionError, ProtocolError, StarcraftProtocol  # noqa: F401
