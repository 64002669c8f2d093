"""Observer: render a running game's raw observation without the SC2 UI.

    python -m distar_tpu_torch.bin.observe --endpoint host:port [--ascii | --interactive | --frames DIR]
        [--count N] [--interval S] [--player P]

Counterpart of ``distar_tpu.bin.observe``. Realtime human play uses SC2's
own UI (``bin/play.py --game_type human_vs_agent``), so this renderer's jobs
are observing and debugging, with no extra dependencies:

  * ``--interactive``: a curses UI with camera pan (arrows/hjkl) and zoom
    (+/-), a cursor (WASD) that inspects the units under it (type, hp,
    orders), pause, and a live HUD (loop, camera rect, unit counts)
  * ``--ascii``: a downsampled live map in the terminal (own units 'o',
    enemies 'x', neutral "'", terrain shading by height)
  * ``--frames DIR``: binary PPM (P6) images, one per observation

It attaches to an already-running client (``--endpoint host:port``; the
port's fake server of ``envs/sc2/fake_sc2.py`` too) through
``envs.sc2.remote_controller.RemoteController`` and reads raw protos only,
so it never perturbs the game. No model runs here, so it takes no
``--device``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np

ASCII_RAMP = " .:-=+*#%@"


def decode_terrain(game_info, map_size: Tuple[int, int]) -> np.ndarray:
    """start_raw.terrain_height ImageData -> [H,W] u8 (zeros when absent —
    the fake server ships no height map)."""
    W, H = map_size
    img = getattr(getattr(game_info, "start_raw", None), "terrain_height", None)
    data = getattr(img, "data", b"") if img is not None else b""
    if img is None or not data or img.bits_per_pixel != 8:
        return np.zeros((H, W), np.uint8)
    arr = np.frombuffer(data, np.uint8)
    if arr.size != img.size.x * img.size.y:
        return np.zeros((H, W), np.uint8)
    arr = arr.reshape(img.size.y, img.size.x)
    if arr.shape[0] >= H and arr.shape[1] >= W:
        return arr[:H, :W]
    return np.zeros((H, W), np.uint8)


def obs_to_grid(raw_obs, map_size: Tuple[int, int], own_player: int,
                terrain: Optional[np.ndarray] = None) -> dict:
    """Raw proto -> numpy layers: terrain [H,W] u8, own(+ally)/enemy/neutral
    unit masks (proto Alliance: Self=1, Ally=2, Neutral=3, Enemy=4)."""
    W, H = map_size
    if terrain is None:
        terrain = np.zeros((H, W), np.uint8)
    own = np.zeros((H, W), bool)
    enemy = np.zeros((H, W), bool)
    neutral = np.zeros((H, W), bool)
    for u in raw_obs.units:
        x = int(np.clip(u.pos.x, 0, W - 1))
        y = int(np.clip(u.pos.y, 0, H - 1))
        if u.alliance in (1, 2):  # self + allies
            own[y, x] = True
        elif u.alliance == 4:
            enemy[y, x] = True
        else:  # neutral: minerals, geysers, destructibles
            neutral[y, x] = True
    return {"terrain": terrain, "own": own, "enemy": enemy, "neutral": neutral}


def _glyph(grid: dict, ys: slice, xs: slice) -> str:
    """One character for a world rect: unit presence by precedence, else a
    terrain shade (the shared glyph language of every renderer here)."""
    if grid["own"][ys, xs].any():
        return "o"
    if grid["enemy"][ys, xs].any():
        return "x"
    if grid["neutral"][ys, xs].any():
        return "'"
    t = grid["terrain"][ys, xs]
    shade = int(t.mean()) * (len(ASCII_RAMP) - 1) // 255 if t.size else 0
    return ASCII_RAMP[shade] if shade else "."


def render_ascii(grid: dict, width: int = 64) -> str:
    H, W = grid["own"].shape
    step_x = max(W // width, 1)
    step_y = max(H // (width // 2), 1)
    rows = []
    for y in range(0, H, step_y):
        row = [
            _glyph(grid, slice(y, y + step_y), slice(x, x + step_x))
            for x in range(0, W, step_x)
        ]
        rows.append("".join(row))
    return "\n".join(rows)


def render_ppm(grid: dict, path: str) -> None:
    H, W = grid["own"].shape
    img = np.zeros((H, W, 3), np.uint8)
    img[..., :] = grid["terrain"][..., None] // 2 + 40  # terrain shading
    img[grid["neutral"]] = (180, 180, 90)
    img[grid["own"]] = (60, 220, 60)
    img[grid["enemy"]] = (220, 60, 60)
    img = img[::-1]  # y-up -> image row order
    with open(path, "wb") as f:
        f.write(f"P6 {W} {H} 255\n".encode())
        f.write(img.tobytes())


class CameraView:
    """Viewport math + character rendering for the interactive observer,
    kept curses-free so it is testable headlessly (the curses loop in
    ``run_interactive`` is a thin input shell around it).

    World coordinates are game cells (y-up); the view renders y-down. One
    character covers ``scale`` world cells horizontally and ``2*scale``
    vertically (terminal glyphs are ~2x taller than wide)."""

    MIN_SCALE = 0.25

    def __init__(self, map_size: Tuple[int, int], cols: int = 64, rows: int = 24):
        self.W, self.H = int(map_size[0]), int(map_size[1])
        self.cols, self.rows = max(cols, 8), max(rows, 4)
        self.cx, self.cy = self.W / 2.0, self.H / 2.0
        # start fully zoomed out: the whole map fits the view
        self.scale = max(self.W / self.cols, self.H / (2.0 * self.rows), self.MIN_SCALE)
        self.cur_col, self.cur_row = self.cols // 2, self.rows // 2

    # ------------------------------------------------------------- controls
    def pan(self, dx_chars: int, dy_chars: int) -> None:
        """Move the camera by character steps (dy_chars > 0 pans DOWN on
        screen = toward smaller world y)."""
        self.cx = float(np.clip(self.cx + dx_chars * self.scale, 0, self.W))
        self.cy = float(np.clip(self.cy - dy_chars * 2.0 * self.scale, 0, self.H))

    def zoom(self, factor: float) -> None:
        max_scale = max(self.W / self.cols, self.H / (2.0 * self.rows), self.MIN_SCALE)
        self.scale = float(np.clip(self.scale * factor, self.MIN_SCALE, max_scale))

    def move_cursor(self, d_col: int, d_row: int) -> None:
        self.cur_col = int(np.clip(self.cur_col + d_col, 0, self.cols - 1))
        self.cur_row = int(np.clip(self.cur_row + d_row, 0, self.rows - 1))

    # ------------------------------------------------------------- geometry
    def world_rect(self):
        """(x0, y0, x1, y1) world-cell bounds of the viewport."""
        half_w = self.cols * self.scale / 2.0
        half_h = self.rows * 2.0 * self.scale / 2.0
        return (self.cx - half_w, self.cy - half_h, self.cx + half_w, self.cy + half_h)

    def char_rect(self, col: int, row: int):
        """World rect covered by one character cell (row 0 = TOP = max y)."""
        x0, y0, x1, y1 = self.world_rect()
        cw = (x1 - x0) / self.cols
        ch = (y1 - y0) / self.rows
        cx0 = x0 + col * cw
        cy1 = y1 - row * ch
        return (cx0, cy1 - ch, cx0 + cw, cy1)

    # ------------------------------------------------------------ rendering
    def render(self, grid: dict) -> list:
        """Viewport -> list of row strings (the shared _glyph language,
        plus '+' for the cursor and blanks beyond the map edge)."""
        H, W = grid["own"].shape
        rows = []
        for r in range(self.rows):
            row = []
            for c in range(self.cols):
                x0, y0, x1, y1 = self.char_rect(c, r)
                xs = slice(max(int(x0), 0), max(int(np.ceil(x1)), 0))
                ys = slice(max(int(y0), 0), max(int(np.ceil(y1)), 0))
                out_of_map = xs.start >= W or ys.start >= H or x1 <= 0 or y1 <= 0
                if (r, c) == (self.cur_row, self.cur_col):
                    row.append("+")
                elif out_of_map:
                    row.append(" ")
                else:
                    row.append(_glyph(grid, ys, xs))
            rows.append("".join(row))
        return rows

    def inspect(self, raw_obs) -> list:
        """Units under the cursor's character cell, nearest first — the
        unit overlay (fields after the reference's select/overlay panel)."""
        x0, y0, x1, y1 = self.char_rect(self.cur_col, self.cur_row)
        mx, my = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        hits = []
        for u in raw_obs.units:
            if x0 <= u.pos.x < x1 and y0 <= u.pos.y < y1:
                d = (u.pos.x - mx) ** 2 + (u.pos.y - my) ** 2
                orders = [o.ability_id for o in getattr(u, "orders", [])]
                hits.append((d, {
                    "tag": u.tag,
                    "unit_type": u.unit_type,
                    "alliance": u.alliance,
                    "health": float(u.health),
                    "health_max": float(u.health_max),
                    "pos": (float(u.pos.x), float(u.pos.y)),
                    "orders": orders,
                }))
        return [info for _, info in sorted(hits, key=lambda t: t[0])]


def hud_line(view: CameraView, loop: int, grid: dict, paused: bool) -> str:
    x0, y0, x1, y1 = view.world_rect()
    return (
        f"loop {loop}  cam[{x0:.0f},{y0:.0f}..{x1:.0f},{y1:.0f}] "
        f"x{view.scale:.2f}  own {int(grid['own'].sum())} "
        f"enemy {int(grid['enemy'].sum())}"
        + ("  [PAUSED]" if paused else "")
        + "  (q quit, arrows pan, +/- zoom, wasd cursor, space pause)"
    )


def run_interactive(controller, map_size, terrain, interval: float) -> None:
    """Curses shell: keyboard -> CameraView, one observe() per frame."""
    import curses

    def loop(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        h, w = scr.getmaxyx()
        view = CameraView(map_size, cols=min(w - 2, 100), rows=max(h - 8, 6))
        paused = False
        obs = controller.observe()
        last = 0.0
        def put(row, text):
            # clamp to the window: short terminals / resize races must not
            # kill the observer with a curses.error
            if 0 <= row < h - 1:
                try:
                    scr.addnstr(row, 0, text, w - 1)
                except curses.error:
                    pass

        while True:
            now = time.time()
            if not paused and now - last >= interval:
                obs = controller.observe()
                last = now
            raw = obs.observation.raw_data
            grid = obs_to_grid(raw, map_size, 1, terrain)
            scr.erase()
            put(0, hud_line(view, obs.observation.game_loop, grid, paused))
            for i, row in enumerate(view.render(grid)):
                put(1 + i, row)
            for i, u in enumerate(view.inspect(raw)[:4]):
                put(
                    2 + view.rows + i,
                    f"> type {u['unit_type']} ally {u['alliance']} "
                    f"hp {u['health']:.0f}/{u['health_max']:.0f} "
                    f"at ({u['pos'][0]:.1f},{u['pos'][1]:.1f}) orders {u['orders']}",
                )
            scr.refresh()
            key = scr.getch()
            if key in (ord("q"), 27):
                return
            elif key == ord(" "):
                paused = not paused
            elif key in (curses.KEY_LEFT, ord("h")):
                view.pan(-4, 0)
            elif key in (curses.KEY_RIGHT, ord("l")):
                view.pan(4, 0)
            elif key in (curses.KEY_UP, ord("k")):
                view.pan(0, -2)
            elif key in (curses.KEY_DOWN, ord("j")):
                view.pan(0, 2)
            elif key in (ord("+"), ord("=")):
                view.zoom(0.5)
            elif key == ord("-"):
                view.zoom(2.0)
            elif key == ord("a"):
                view.move_cursor(-1, 0)
            elif key == ord("d"):
                view.move_cursor(1, 0)
            elif key == ord("w"):
                view.move_cursor(0, -1)
            elif key == ord("s"):
                view.move_cursor(0, 1)
            time.sleep(0.03)

    curses.wrapper(loop)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--endpoint", default="", help="host:port of a running client")
    p.add_argument("--player", type=int, default=1)
    p.add_argument("--interval", type=float, default=1.0, help="seconds between frames")
    p.add_argument("--count", type=int, default=0, help="frames to capture (0 = forever)")
    p.add_argument("--ascii", action="store_true", help="live terminal map")
    p.add_argument("--interactive", action="store_true",
                   help="curses UI: camera pan/zoom + unit-inspect cursor")
    p.add_argument("--frames", default="", help="directory for PPM frames")
    args = p.parse_args(argv)

    from ..envs.sc2.remote_controller import RemoteController

    if not args.endpoint:
        raise SystemExit("--endpoint host:port required (launch a client via "
                         "bin/sc2_tools or point at a live game)")
    host, _, port = args.endpoint.rpartition(":")
    controller = RemoteController(host or "127.0.0.1", int(port), timeout_seconds=30)
    gi = controller.game_info()
    map_size = (gi.start_raw.map_size.x, gi.start_raw.map_size.y)
    terrain = decode_terrain(gi, map_size)
    if args.interactive:
        run_interactive(controller, map_size, terrain, args.interval)
        return
    if args.frames:
        os.makedirs(args.frames, exist_ok=True)

    n = 0
    while args.count == 0 or n < args.count:
        obs = controller.observe()
        grid = obs_to_grid(obs.observation.raw_data, map_size, args.player, terrain)
        loop = obs.observation.game_loop
        if args.ascii:
            sys.stdout.write(f"\x1b[2J\x1b[Hloop {loop}\n{render_ascii(grid)}\n")
            sys.stdout.flush()
        if args.frames:
            render_ppm(grid, os.path.join(args.frames, f"frame_{n:05d}_loop{loop}.ppm"))
        n += 1
        if args.count == 0 or n < args.count:
            time.sleep(args.interval)
    if args.frames:
        print(f"{n} frames written to {args.frames}")


if __name__ == "__main__":
    main()
