"""An in-process fake SC2: a real websocket server speaking real s2api
protos, backing the client stack's tests and game-free demos.

Counterpart of ``distar_tpu.envs.sc2.fake_sc2``.

Role of the reference's recorded-protocol strategy (pysc2's mock_sc2_env +
dummy_observation, applied one layer LOWER): the full production path —
websocket framing, StarcraftProtocol, RemoteController status machine,
create/join port plumbing — runs byte-identically against this server; only
the simulation behind /sc2api is scripted.

The server hosts any number of client connections on one port, so the
multiplayer create/join handshake (host creates, everyone joins, the game
starts when all participants joined — reference distar/envs/env.py:211-274)
is exercised across connections exactly like against N real processes.

Replays: a "replay file" is a pickled dict
  {"base_build", "game_version", "data_version", "players":
   [{player_id, race, mmr, apm, result}], "game_duration_loops",
   "actions": [(game_loop, ability_id, unit_tags, target|None)], "map_name"}
start_replay plays its action stream back through ResponseObservation.actions
— the two-pass replay decoder runs against it unmodified.

Also launchable as a fake binary: ``python -m distar_tpu_torch.envs.sc2.fake_sc2
-listen 127.0.0.1 -port N`` (SC2-style args), so StarcraftProcess's
launch/connect/retry path is testable end to end.
"""
from __future__ import annotations

import base64
import hashlib
import pickle
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .proto import sc_pb

_WS_MAGIC = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


# ---------------------------------------------------------------- websocket
class _WSConn:
    """Server side of one websocket connection (RFC6455 subset: unfragmented
    binary frames, client->server masked, server->client unmasked)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def handshake(self) -> bool:
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = self._sock.recv(4096)
            if not chunk:
                return False
            data += chunk
        head, _, rest = data.partition(b"\r\n\r\n")
        self._buf = rest
        lines = head.decode("latin-1").split("\r\n")
        if "/sc2api" not in lines[0]:
            self._sock.sendall(b"HTTP/1.1 404 Not Found\r\n\r\n")
            return False
        key = ""
        for line in lines[1:]:
            name, _, value = line.partition(":")
            if name.strip().lower() == "sec-websocket-key":
                key = value.strip()
        accept = base64.b64encode(
            hashlib.sha1(key.encode("latin-1") + _WS_MAGIC).digest()
        ).decode()
        self._sock.sendall(
            (
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
            ).encode("latin-1")
        )
        return True

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionResetError("client closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def recv(self) -> Optional[bytes]:
        """One message; None on close frame / disconnect."""
        while True:
            try:
                b1, b2 = self._read_exact(2)
            except (ConnectionResetError, OSError):
                return None
            opcode = b1 & 0x0F
            masked = b2 & 0x80
            length = b2 & 0x7F
            if length == 126:
                (length,) = struct.unpack(">H", self._read_exact(2))
            elif length == 127:
                (length,) = struct.unpack(">Q", self._read_exact(8))
            mask = self._read_exact(4) if masked else b""
            payload = self._read_exact(length)
            if mask:
                payload = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
            if opcode == 8:  # close
                return None
            if opcode == 9:  # ping -> pong
                self._send_frame(10, payload)
                continue
            if opcode in (1, 2):
                return payload
            # pong/continuation: ignore

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        header = bytes([0x80 | opcode])
        n = len(payload)
        if n < 126:
            header += bytes([n])
        elif n < 2 ** 16:
            header += bytes([126]) + struct.pack(">H", n)
        else:
            header += bytes([127]) + struct.pack(">Q", n)
        self._sock.sendall(header + payload)

    def send(self, payload: bytes) -> None:
        self._send_frame(2, payload)

    def close(self) -> None:
        try:
            self._send_frame(8, b"")
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# ------------------------------------------------------------------- game
class FakeGameCore:
    """The scripted simulation shared by all connections on one server."""

    def __init__(self, map_size=(120, 120), n_units: int = 8, end_at: int = 10_000,
                 winner: int = 1, seed: int = 0, game_version: str = "4.10.0",
                 base_build: int = 75689, replay_library: Optional[Dict[str, dict]] = None):
        self.lock = threading.RLock()
        self.map_size = map_size
        self.n_units = n_units
        self.end_at = end_at
        self.winner = winner
        self.game_version = game_version
        self.base_build = base_build
        self.replay_library = replay_library or {}
        self._rng = np.random.default_rng(seed)
        self.reset()
        self.saved_maps: Dict[str, bytes] = {}
        self.action_log: List = []

    def reset(self) -> None:
        self.game_loop = 0
        self.create_req = None
        self.joined: List[int] = []
        self.num_participants = 0
        self.started = False
        self.ended = False

    # ------------------------------------------------------------ lifecycle
    def create_game(self, req) -> None:
        self.reset()
        self.create_req = req
        self.num_participants = sum(
            1 for p in req.player_setup if p.type == sc_pb.Participant
        )

    def join(self, req) -> int:
        player_id = len(self.joined) + 1
        self.joined.append(player_id)
        if len(self.joined) >= max(self.num_participants, 1):
            self.started = True
        return player_id

    def advance(self, loops: int) -> None:
        if self.ended:
            return
        self.game_loop += loops
        if self.game_loop >= self.end_at:
            self.ended = True

    # ---------------------------------------------------------------- build
    def _image(self, bits: int) -> "sc_pb.ImageData":
        from .proto import common_pb

        y, x = self.map_size
        img = common_pb.ImageData()
        img.bits_per_pixel = bits
        img.size.x = x
        img.size.y = y
        if bits == 1:
            img.data = np.packbits(
                (self._rng.integers(0, 2, (y, x))).astype(np.uint8)
            ).tobytes()
        else:
            img.data = self._rng.integers(0, 4, (y, x), dtype=np.uint8).tobytes()
        return img

    def build_observation(self, player_id: int, with_result: bool = False,
                          actions: Optional[list] = None):
        res = sc_pb.ResponseObservation()
        obs = res.observation
        obs.game_loop = self.game_loop
        pc = obs.player_common
        pc.player_id = player_id
        pc.minerals = 50 + self.game_loop // 10
        pc.vespene = 25
        pc.food_cap = 15
        pc.food_used = 12
        pc.food_army = 4
        pc.food_workers = 8
        pc.idle_worker_count = 1
        pc.army_count = 4
        pc.warp_gate_count = 0
        pc.larva_count = 3

        sd = obs.score.score_details
        for cat in ("killed_minerals", "killed_vespene"):
            msg = getattr(sd, cat)
            msg.none = 0.0
            msg.army = float(self.game_loop // 100)
            msg.economy = 0.0
            msg.technology = 0.0
            msg.upgrade = 0.0

        raw = obs.raw_data
        # researched upgrades appear once the game has progressed (exercises
        # the scalar upgrades reorder-LUT path, features.py:350-353)
        if self.game_loop >= 100:
            raw.player.upgrade_ids.extend([1, 4])
        for side, alliance in ((player_id, 1), (3 - player_id, 4)):
            for i in range(self.n_units):
                u = raw.units.add()
                u.display_type = 1
                u.alliance = alliance
                u.tag = side * 10_000 + i
                u.unit_type = 104  # zerg drone
                u.owner = side
                u.pos.x = 5.0 + i + (0 if alliance == 1 else 40)
                u.pos.y = 10.0 + (0 if alliance == 1 else 40)
                u.health = 40.0
                u.health_max = 40.0
                u.is_powered = True
                u.build_progress = 1.0
                if i == 0:
                    # busy unit: queued orders with progress + a buff —
                    # real clients report these constantly (order_id_*,
                    # order_progress_*, buff_id_* entity fields)
                    o = u.orders.add()
                    o.ability_id = 1183  # zerg build ability (in contract)
                    o.progress = 0.5
                    o2 = u.orders.add()
                    o2.ability_id = 216  # in the queue-action vocabulary
                    # (ABILITY_TO_QUEUE_ACTION > 0) so order_id_1 remaps
                    # to a real class, not the 0 no-op
                    u.buff_ids.append(5)
                    u.energy = 25.0
                    u.energy_max = 50.0
                if i == 1 and self.n_units > 2:
                    # transport carrying a passenger: transform_obs emits the
                    # passenger as an is_in_cargo pseudo-entity
                    u.cargo_space_max = 8
                    u.cargo_space_taken = 1
                    p = u.passengers.add()
                    p.tag = side * 10_000 + 9000
                    p.unit_type = 104
                    p.health = 35.0
                    p.health_max = 40.0
                if i == 2 and self.n_units > 3:
                    u.add_on_tag = side * 10_000 + 3  # points at unit 3
                if i == 3 and self.n_units > 3:
                    u.unit_type = 5  # TechLab: a real addon type id so the
                    # addon_unit_type reorder LUT keeps it (others map to 0)
        # a transient battlefield effect (flat-index scatter plane path)
        if 50 <= self.game_loop < self.end_at:
            e = raw.effects.add()
            e.effect_id = 11  # CorrosiveBile
            p = e.pos.add()
            p.x, p.y = 30.0, 30.0

        fl = obs.feature_layer_data.minimap_renders
        for name, bits in (
            ("height_map", 8), ("visibility_map", 8), ("creep", 1),
            ("player_relative", 8), ("alerts", 8), ("pathable", 1),
            ("buildable", 1),
        ):
            getattr(fl, name).CopyFrom(self._image(bits))

        for a in actions or []:
            res.actions.add().CopyFrom(a)

        if with_result and (self.ended or self.game_loop >= self.end_at):
            for pid in (1, 2):
                pr = res.player_result.add()
                pr.player_id = pid
                pr.result = sc_pb.Victory if pid == self.winner else sc_pb.Defeat
        return res

    def build_game_info(self):
        gi = sc_pb.ResponseGameInfo()
        gi.map_name = "FakeMap"
        y, x = self.map_size
        gi.start_raw.map_size.x = x
        gi.start_raw.map_size.y = y
        n = max(self.num_participants, len(self.joined), 2)
        for pid in range(1, n + 1):
            pi = gi.player_info.add()
            pi.player_id = pid
            pi.type = sc_pb.Participant
            pi.race_requested = 2  # zerg
            pi.race_actual = 2
        return gi


class _ConnState:
    def __init__(self):
        self.status = sc_pb.launched
        self.player_id = 0
        self.in_replay = False
        self.replay: Optional[dict] = None
        self.replay_cursor = 0


class FakeSC2Server:
    """Accepts websocket connections on one port, dispatching /sc2api
    requests to a shared FakeGameCore."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 game: Optional[FakeGameCore] = None):
        self.game = game or FakeGameCore()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self.host, self.port = self._listener.getsockname()[:2]
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def stop(self) -> None:
        self._stop.set()
        # closing an fd does NOT wake a thread blocked in accept() on Linux;
        # poke the listener so the loop observes _stop and exits instead of
        # parking forever as a leaked daemon thread
        poke_host = self.host if self.host not in ("0.0.0.0", "") else "127.0.0.1"
        try:
            with socket.create_connection((poke_host, self.port), timeout=1):
                pass
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        # reap the accept loop: the poke above guarantees it observes _stop,
        # so this join is fast — stop() returning with the loop still
        # between accept() and its _stop check would race a re-bind
        self._accept_thread.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            if self._stop.is_set():  # stop()'s wake-up poke, not a client
                sock.close()
                return
            t = threading.Thread(target=self._serve_client, args=(sock,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_client(self, sock: socket.socket) -> None:
        conn = _WSConn(sock)
        if not conn.handshake():
            conn.close()
            return
        state = _ConnState()
        # real SC2's status is process-global, not per-connection: a second
        # connection (e.g. bin/observe attaching to a live game) arrives
        # mid-game and may observe immediately
        with self.game.lock:
            if self.game.started and not self.game.ended:
                state.status = sc_pb.in_game
                state.player_id = 1
        while not self._stop.is_set():
            payload = conn.recv()
            if payload is None:
                break
            req = sc_pb.Request.FromString(payload)
            try:
                resp = self._dispatch(state, req)
            except Exception as e:  # bug in the fake -> protocol error
                resp = sc_pb.Response()
                resp.error.append(f"fake_sc2 internal error: {e!r}")
            if resp is None:  # quit
                break
            if req.HasField("id"):
                resp.id = req.id
            resp.status = state.status
            conn.send(resp.SerializeToString())
        conn.close()

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, state: _ConnState, req) -> Optional["sc_pb.Response"]:
        which = req.WhichOneof("request")
        resp = sc_pb.Response()
        game = self.game
        if which == "join_game":
            # blocking call: returns when all participants joined (reference
            # join semantics, distar/envs/env.py:268-271) — waits OUTSIDE the
            # game lock so the other connections can join
            with game.lock:
                state.player_id = game.join(req.join_game)
            while not game.started and not self._stop.is_set():
                time.sleep(0.005)
            resp.join_game.player_id = state.player_id
            state.status = sc_pb.in_game
            return resp
        with game.lock:
            if which == "ping":
                resp.ping.game_version = game.game_version
                resp.ping.data_version = "FAKE"
                resp.ping.data_build = game.base_build
                resp.ping.base_build = game.base_build
            elif which == "create_game":
                game.create_game(req.create_game)
                resp.create_game.SetInParent()
                state.status = sc_pb.init_game
            elif which == "save_map":
                game.saved_maps[req.save_map.map_path] = req.save_map.map_data
                resp.save_map.SetInParent()
            elif which == "restart_game":
                game.reset()
                game.num_participants = 0
                game.joined = [state.player_id]
                game.started = True
                resp.restart_game.SetInParent()
                state.status = sc_pb.in_game
            elif which == "game_info":
                resp.game_info.CopyFrom(game.build_game_info())
            elif which == "observation":
                target = req.observation.game_loop
                if target > game.game_loop:
                    game.advance(target - game.game_loop)
                actions = None
                if state.in_replay and state.replay is not None:
                    actions, state.replay_cursor = _replay_actions_until(
                        state.replay, state.replay_cursor, game.game_loop
                    )
                resp.observation.CopyFrom(
                    game.build_observation(
                        max(state.player_id, 1), with_result=True, actions=actions
                    )
                )
                if game.ended:
                    state.status = sc_pb.ended
            elif which == "step":
                game.advance(req.step.count)
                resp.step.simulation_loop = game.game_loop
                if game.ended:
                    state.status = sc_pb.ended
            elif which == "action":
                game.action_log.append((state.player_id, req.action))
                for _ in req.action.actions:
                    resp.action.result.append(1)  # Success
            elif which == "replay_info":
                info = self._replay_info(req.replay_info)
                resp.replay_info.CopyFrom(info)
            elif which == "start_replay":
                rep = self._load_replay(req.start_replay)
                state.in_replay = True
                state.replay = rep
                state.replay_cursor = 0
                game.reset()
                game.started = True
                game.end_at = rep.get("game_duration_loops", game.end_at)
                state.player_id = req.start_replay.observed_player_id or 1
                resp.start_replay.SetInParent()
                state.status = sc_pb.in_replay
            elif which == "leave_game":
                resp.leave_game.SetInParent()
                state.status = sc_pb.launched
            elif which == "save_replay":
                resp.save_replay.data = pickle.dumps(
                    {"base_build": game.base_build, "actions": [],
                     "game_duration_loops": game.game_loop}
                )
            elif which == "available_maps":
                resp.available_maps.local_map_paths.extend(sorted(game.saved_maps))
            elif which == "data":
                resp.data.SetInParent()
            elif which == "quit":
                return None
            else:
                resp.error.append(f"unsupported request: {which}")
        return resp

    def _load_replay(self, req) -> dict:
        if req.HasField("replay_data") and req.replay_data:
            return pickle.loads(req.replay_data)
        name = req.replay_path
        if name in self.game.replay_library:
            return self.game.replay_library[name]
        with open(name, "rb") as f:
            return pickle.load(f)

    def _replay_info(self, req):
        rep = self._load_replay(req)
        info = sc_pb.ResponseReplayInfo()
        info.map_name = rep.get("map_name", "FakeMap")
        info.game_version = rep.get("game_version", self.game.game_version)
        info.data_version = rep.get("data_version", "FAKE")
        info.base_build = rep.get("base_build", self.game.base_build)
        info.data_build = info.base_build
        info.game_duration_loops = rep.get("game_duration_loops", 1000)
        info.game_duration_seconds = info.game_duration_loops / 22.4
        for p in rep.get("players", []):
            pie = info.player_info.add()
            pie.player_info.player_id = p.get("player_id", 1)
            pie.player_info.race_requested = p.get("race", 2)
            pie.player_info.race_actual = p.get("race", 2)
            pie.player_mmr = p.get("mmr", 4500)
            pie.player_apm = p.get("apm", 150)
            pr = pie.player_result
            pr.player_id = p.get("player_id", 1)
            pr.result = p.get("result", 1)
        return info


def _replay_actions_until(rep: dict, cursor: int, loop: int):
    """Actions whose recorded loop has been reached since the last observe."""
    out = []
    actions = rep.get("actions", [])
    while cursor < len(actions) and actions[cursor][0] <= loop:
        rec_loop, ability_id, unit_tags, target = actions[cursor]
        a = sc_pb.Action()
        a.game_loop = rec_loop
        uc = a.action_raw.unit_command
        uc.ability_id = ability_id
        uc.unit_tags.extend(unit_tags)
        if isinstance(target, (tuple, list)):
            uc.target_world_space_pos.x = float(target[0])
            uc.target_world_space_pos.y = float(target[1])
        elif isinstance(target, int):
            uc.target_unit_tag = target
        out.append(a)
        cursor += 1
    return out, cursor


def write_fake_install(root: str, repo_root: str) -> str:
    """Lay out an SC2 install under ``root`` whose binary is this module.

    ``Versions/Base75689/SC2_x64`` (the fake game's ``base_build``) is a
    shell script that runs ``python -m distar_tpu_torch.envs.sc2.fake_sc2
    "$@"`` with this interpreter and ``repo_root`` on ``PYTHONPATH``;
    ``Support64/`` (the binary's working directory) and ``Maps/`` are
    empty. With ``SC2PATH=root``, ``run_configs.get()``, ``sc_process`` and
    the launcher run as on a real install. (The port's addition: the tests
    and ``chip_smoke.py`` drive the entry points over it.) Returns
    ``root``."""
    import os
    import shlex
    import sys

    exe_dir = os.path.join(root, "Versions", "Base75689")
    os.makedirs(exe_dir, exist_ok=True)
    for sub in ("Support64", "Maps"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    exe = os.path.join(exe_dir, "SC2_x64")
    with open(exe, "w") as f:
        f.write(
            "#!/bin/sh\n"
            f"PYTHONPATH={shlex.quote(os.path.abspath(repo_root))}${{PYTHONPATH:+:$PYTHONPATH}} "
            f"exec {shlex.quote(sys.executable)} -m distar_tpu_torch.envs.sc2.fake_sc2 \"$@\"\n"
        )
    os.chmod(exe, 0o755)
    return root


def main(argv=None) -> None:
    """SC2-binary-compatible entry: -listen HOST -port N [ignored args]."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    host, port = "127.0.0.1", 0
    i = 0
    while i < len(argv):
        if argv[i] == "-listen":
            host = argv[i + 1]
            i += 2
        elif argv[i] == "-port":
            port = int(argv[i + 1])
            i += 2
        else:
            i += 1  # -dataDir/-tempDir/-dataVersion etc: accepted, ignored
    import logging

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    server = FakeSC2Server(port=port, host=host)
    logging.info("fake_sc2 listening on %s:%s", server.host, server.port)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
