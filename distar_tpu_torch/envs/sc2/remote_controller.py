"""RemoteController: the python interface to a running SC2 binary.

Counterpart of ``distar_tpu.envs.sc2.remote_controller``. Role parity with
the reference RemoteController (reference: distar/pysc2/
lib/remote_controller.py:127-386): blocking request/response calls with
status-gated validity, create/join/restart/start_replay lifecycle,
``observe(target_game_loop)`` with the stub-observation regurgitation, the
batched ``acts`` used by the env's hot loop, 'Game has already ended'
suppression, connect retries against a booting process.

Provenance: the status-gating decorator shapes (``valid_status`` /
``skip_status`` / ``decorate_check_error``) follow the request-validity
semantics of the SC2 api itself, which DeepMind's Apache-2.0 pysc2
(``pysc2/lib/remote_controller.py``) first codified as decorators — the
state machine they encode (which Status values make which request legal)
is fixed by the game protocol, so any correct client expresses the same
table. The implementations here are this repo's own.
"""
from __future__ import annotations

import copy
import functools
import logging
import os
import socket
import time

from . import protocol, wsclient
from .proto import Status, sc_pb

DEFAULT_TIMEOUT_SECONDS = int(os.environ.get("DISTAR_SC2_TIMEOUT", "120"))


class ConnectError(Exception):
    pass


class RequestError(Exception):
    pass


def check_error(res, error_enum):
    """Raise RequestError if the response carries an error field."""
    if res.HasField("error"):
        enum_name = error_enum.DESCRIPTOR.full_name
        error_name = error_enum.Name(res.error)
        details = getattr(res, "error_details", "<none>")
        raise RequestError(f"{enum_name}.{error_name}: '{details}'")
    return res


def decorate_check_error(error_enum):
    def decorator(func):
        @functools.wraps(func)
        def _check_error(*args, **kwargs):
            return check_error(func(*args, **kwargs), error_enum)

        return _check_error

    return decorator


def skip_status(*skipped):
    """No-op the call when in one of the skipped states."""

    def decorator(func):
        @functools.wraps(func)
        def _skip_status(self, *args, **kwargs):
            if self.status not in skipped:
                return func(self, *args, **kwargs)

        return _skip_status

    return decorator


def valid_status(*valid):
    """Assert we are in a state where this request is legal."""

    def decorator(func):
        @functools.wraps(func)
        def _valid_status(self, *args, **kwargs):
            if self.status not in valid:
                raise protocol.ProtocolError(
                    f"`{func.__name__}` called while in state: {self.status}, "
                    f"valid: ({','.join(map(str, valid))})"
                )
            return func(self, *args, **kwargs)

        return _valid_status

    return decorator


def catch_game_end(func):
    """Suppress the spurious 'Game has already ended' protocol error that SC2
    can emit while our status is still in_game (reference :99-124)."""

    @functools.wraps(func)
    def _catch_game_end(self, *args, **kwargs):
        prev_status = self.status
        try:
            return func(self, *args, **kwargs)
        except protocol.ProtocolError as protocol_error:
            if prev_status == Status.in_game and (
                "Game has already ended" in str(protocol_error)
            ):
                logging.warning(
                    "Received a 'Game has already ended' error from SC2 whilst "
                    "status in_game. Suppressing the exception, returning None."
                )
                return None
            raise

    return _catch_game_end


class RemoteController:
    """Blocking python calls mapped onto SC2 api requests."""

    def __init__(self, host, port, proc=None, timeout_seconds=None, sock=None):
        timeout_seconds = timeout_seconds or DEFAULT_TIMEOUT_SECONDS
        if sock is None:
            sock = self._connect(host, port, proc, timeout_seconds)
        self._client = protocol.StarcraftProtocol(sock)
        self._last_obs = None
        self.ping()

    def _connect(self, host, port, proc, timeout_seconds):
        """Dial the binary's /sc2api websocket until the deadline lapses.

        A booting SC2 binary refuses TCP for a while, then serves 404 until
        the /sc2api endpoint registers — both mean "keep dialing". Two
        conditions end the wait early: the endpoint actively closing the
        handshake (another client owns the port — one controller per
        process), and the process dying after it was seen alive (or never
        appearing within the first quarter of the budget). Role parity with
        the reference's connect retry (reference remote_controller.py:147).
        The port dials through its own stdlib client (``wsclient``)."""
        wire_host = f"[{host}]" if ":" in host and not host.startswith("[") else host
        endpoint = f"ws://{wire_host}:{port}/sc2api"
        start = time.monotonic()
        boot_grace = timeout_seconds / 4  # how long a proc may take to appear
        seen_alive = False
        dials = 0
        while time.monotonic() - start < timeout_seconds:
            alive = bool(proc and proc.running)
            seen_alive = seen_alive or alive
            if not alive and (seen_alive or time.monotonic() - start >= boot_grace):
                raise ConnectError(
                    f"SC2 process is gone; stopped dialing {endpoint} after "
                    f"{dials} attempts"
                )
            dials += 1
            logging.info("dialing %s (attempt %d, proc alive: %s)", endpoint, dials, alive)
            try:
                return wsclient.create_connection(endpoint, timeout=timeout_seconds)
            except wsclient.WebSocketBadStatusException as err:
                if err.status_code != 404:  # 404 = listening, endpoint not up yet
                    raise
            except wsclient.WebSocketConnectionClosedException:
                raise ConnectError(
                    f"{endpoint} closed the handshake — is another controller "
                    "already attached to this process?"
                )
            except socket.error:
                pass  # not listening yet
            time.sleep(1)
        raise ConnectError(f"no websocket at {endpoint} within {timeout_seconds}s")

    def close(self) -> None:
        self._client.close()

    @property
    def status(self) -> Status:
        return self._client.status

    @property
    def status_ended(self) -> bool:
        return self.status == Status.ended

    # -------------------------------------------------------- game lifecycle
    @valid_status(Status.launched, Status.ended, Status.in_game, Status.in_replay)
    @decorate_check_error(sc_pb.ResponseCreateGame.Error)
    def create_game(self, req_create_game):
        """Create a new game (host only)."""
        return self._client.send(create_game=req_create_game)

    @valid_status(Status.launched, Status.init_game)
    @decorate_check_error(sc_pb.ResponseSaveMap.Error)
    def save_map(self, map_path, map_data):
        """Save a map into the temp dir so multiplayer create can access it."""
        return self._client.send(
            save_map=sc_pb.RequestSaveMap(map_path=map_path, map_data=map_data)
        )

    @valid_status(Status.launched, Status.init_game)
    @decorate_check_error(sc_pb.ResponseJoinGame.Error)
    def join_game(self, req_join_game):
        """Join a game (all connected clients)."""
        return self._client.send(join_game=req_join_game)

    @valid_status(Status.ended, Status.in_game)
    @decorate_check_error(sc_pb.ResponseRestartGame.Error)
    def restart(self):
        """Restart the game (host only)."""
        return self._client.send(restart_game=sc_pb.RequestRestartGame())

    @valid_status(Status.launched, Status.ended, Status.in_game, Status.in_replay)
    @decorate_check_error(sc_pb.ResponseStartReplay.Error)
    def start_replay(self, req_start_replay):
        return self._client.send(start_replay=req_start_replay)

    @valid_status(Status.in_game, Status.ended)
    def leave(self):
        """Disconnect from a multiplayer game."""
        return self._client.send(leave_game=sc_pb.RequestLeaveGame())

    @skip_status(Status.quit)
    def quit(self):
        """Shut down the SC2 process."""
        try:
            # don't expect a response
            self._client.write(sc_pb.Request(quit=sc_pb.RequestQuit(), id=999999999))
        except protocol.ConnectionError:
            pass  # already (shutting) down
        finally:
            self.close()

    # ------------------------------------------------------------------ info
    @valid_status(Status.in_game, Status.in_replay)
    def game_info(self):
        return self._client.send(game_info=sc_pb.RequestGameInfo())

    @valid_status(Status.in_game, Status.in_replay)
    def data_raw(self, ability_id=True, unit_type_id=True, upgrade_id=True,
                 buff_id=True, effect_id=True):
        return self._client.send(
            data=sc_pb.RequestData(
                ability_id=ability_id, unit_type_id=unit_type_id,
                upgrade_id=upgrade_id, buff_id=buff_id, effect_id=effect_id,
            )
        )

    def ping(self):
        return self._client.send(ping=sc_pb.RequestPing())

    @decorate_check_error(sc_pb.ResponseReplayInfo.Error)
    def replay_info(self, replay_path=None, replay_data=None):
        req = sc_pb.RequestReplayInfo()
        if replay_data is not None:
            req.replay_data = replay_data
        else:
            req.replay_path = replay_path
        return self._client.send(replay_info=req)

    def available_maps(self):
        return self._client.send(available_maps=sc_pb.RequestAvailableMaps())

    # ---------------------------------------------------------- observe/step
    @valid_status(Status.in_game, Status.in_replay, Status.ended)
    def observe(self, disable_fog=False, target_game_loop=0):
        """Observation at an explicit target game loop (reference :241-272)."""
        obs = self._client.send(
            observation=sc_pb.RequestObservation(
                game_loop=target_game_loop, disable_fog=disable_fog
            )
        )
        if obs.observation.game_loop == 2 ** 32 - 1:
            logging.info("Received stub observation.")
            if not obs.player_result:
                raise ValueError("Expect a player result in a stub observation")
            if self._last_obs is None:
                raise RuntimeError("Received stub observation with no previous obs")
            # regurgitate the previous observation + the new result/actions
            new_obs = copy.deepcopy(self._last_obs)
            del new_obs.actions[:]
            new_obs.actions.extend(obs.actions)
            new_obs.player_result.extend(obs.player_result)
            obs = new_obs
            self._last_obs = None
        else:
            self._last_obs = obs
        return obs

    @valid_status(Status.in_game, Status.in_replay)
    @catch_game_end
    def step(self, count=1):
        """Step the engine forward by ``count`` game loops."""
        return self._client.send(step=sc_pb.RequestStep(count=count))

    # ---------------------------------------------------------------- actions
    @skip_status(Status.in_replay)
    @valid_status(Status.in_game)
    @catch_game_end
    def actions(self, req_action):
        """Send a RequestAction (may batch multiple actions)."""
        return self._client.send(action=req_action)

    def act(self, action):
        """Send a single action."""
        if action and action.ListFields():  # skip no-ops
            return self.actions(sc_pb.RequestAction(actions=[action]))

    def acts(self, act_list):
        """Batched actions — the env hot path (reference :330-333).

        Accepts sc_pb.Action protos OR the plain raw-command dicts emitted by
        ProtoFeatures.transform_action (converted here, keeping the feature
        layer proto-agnostic). Returns the per-action result list."""
        protos = [a if not isinstance(a, dict) else raw_cmd_to_action(a) for a in act_list]
        protos = [a for a in protos if a is not None]
        if not protos:
            return None
        res = self.actions(sc_pb.RequestAction(actions=protos))
        return list(res.result) if res is not None else None

    def chat(self, message, channel=None):
        if message:
            action = sc_pb.Action(
                action_chat=sc_pb.ActionChat(
                    channel=channel or sc_pb.ActionChat.Broadcast, message=message
                )
            )
            return self.act(action)

    # ----------------------------------------------------------------- misc
    @valid_status(Status.in_game, Status.in_replay, Status.ended)
    def save_replay(self):
        res = self._client.send(save_replay=sc_pb.RequestSaveReplay())
        return res.data


def raw_cmd_to_action(cmd: dict):
    """ProtoFeatures.transform_action dict -> sc_pb.Action raw unit command.

    The dict contract: {ability_id, queue_command, unit_tags,
    target_unit_tag?, target_world_space_pos?} (envs/features.py)."""
    if not cmd or not cmd.get("ability_id") and not cmd.get("unit_tags"):
        return None
    action = sc_pb.Action()
    uc = action.action_raw.unit_command
    uc.ability_id = int(cmd.get("ability_id", 0))
    uc.queue_command = bool(cmd.get("queue_command", False))
    uc.unit_tags.extend(int(t) for t in cmd.get("unit_tags", []))
    if cmd.get("target_unit_tag") is not None:
        uc.target_unit_tag = int(cmd["target_unit_tag"])
    elif cmd.get("target_world_space_pos") is not None:
        x, y = cmd["target_world_space_pos"]
        uc.target_world_space_pos.x = float(x)
        uc.target_world_space_pos.y = float(y)
    return action
