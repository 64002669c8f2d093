"""The port's observer (``distar_tpu_torch/bin/observe.py``): the
counterparts of tests/test_observe.py's eight tests on the port's modules
(the curses-free ``CameraView``: pan and zoom clamping, viewport glyphs,
the unit-inspect overlay; the HUD; the headless ASCII and PPM paths; the
``decode_terrain`` dimension guard), then the renders held equal to the
JAX observer's on the same observation, and the live mode's counterpart in
tests/test_torch_sc2_client.py."""
import numpy as np
import pytest

from distar_tpu.bin import observe as jobserve
from distar_tpu_torch.bin.observe import (
    CameraView, decode_terrain, hud_line, obs_to_grid, render_ascii, render_ppm,
)
from distar_tpu_torch.envs.dummy_obs import NS, build_dummy_obs, make_unit


def _grid(map_x=120, map_y=120):
    units = [
        make_unit(1, 86, x=30.0, y=40.0),
        make_unit(2, 48, alliance=4, x=90.0, y=100.0),
        make_unit(3, 341, alliance=3, x=10.0, y=10.0),
    ]
    obs = build_dummy_obs(units=units, map_y=map_y, map_x=map_x)
    grid = obs_to_grid(obs.observation.raw_data, (map_x, map_y), 1)
    return obs, grid


def test_camera_starts_fit_and_pan_clamps():
    view = CameraView((120, 120), cols=60, rows=20)
    x0, y0, x1, y1 = view.world_rect()
    assert x0 <= 0 and y0 <= 0 and x1 >= 120 and y1 >= 120  # whole map visible
    for _ in range(100):
        view.pan(10, 0)
    assert view.cx == 120  # clamped at the map edge
    for _ in range(100):
        view.pan(0, 10)
    assert view.cy == 0  # pan down = toward smaller world y


def test_zoom_bounds():
    view = CameraView((120, 120), cols=60, rows=20)
    fit_scale = view.scale
    view.zoom(100.0)
    assert view.scale == fit_scale  # cannot zoom out past whole-map fit
    for _ in range(10):
        view.zoom(0.5)
    assert view.scale == CameraView.MIN_SCALE


def test_render_marks_units_and_cursor():
    obs, grid = _grid()
    view = CameraView((120, 120), cols=60, rows=20)
    rows = view.render(grid)
    assert len(rows) == 20 and all(len(r) == 60 for r in rows)
    joined = "\n".join(rows)
    assert "o" in joined and "x" in joined and "'" in joined
    assert joined.count("+") == 1  # exactly one cursor glyph


def test_zoomed_camera_sees_only_its_rect():
    obs, grid = _grid()
    view = CameraView((120, 120), cols=60, rows=20)
    view.scale = CameraView.MIN_SCALE  # tight zoom ...
    view.cx, view.cy = 30.0, 40.0      # ... on the own hatchery
    joined = "\n".join(view.render(grid))
    assert "o" in joined
    assert "x" not in joined  # the enemy at (90,100) is outside the rect


def test_inspect_returns_units_under_cursor():
    obs, _ = _grid()
    view = CameraView((120, 120), cols=60, rows=20)
    view.scale = 1.0
    # center the view so the cursor's half-open char cell [30,31)x[39,41)
    # covers the hatchery at (30,40)
    view.cx, view.cy = 30.0, 41.0
    hits = view.inspect(obs.observation.raw_data)
    assert hits and hits[0]["unit_type"] == 86 and hits[0]["alliance"] == 1
    assert hits[0]["health"] == 50.0
    # move the cursor to a corner: empty ground there
    view.cur_col, view.cur_row = 0, 0
    assert view.inspect(obs.observation.raw_data) == []


def test_hud_line_contents():
    obs, grid = _grid()
    view = CameraView((120, 120))
    line = hud_line(view, 777, grid, paused=True)
    assert "loop 777" in line and "[PAUSED]" in line and "own 1" in line


def test_ascii_and_ppm_roundtrip(tmp_path):
    obs, grid = _grid()
    art = render_ascii(grid)
    assert "o" in art and "x" in art
    path = str(tmp_path / "f.ppm")
    render_ppm(grid, path)
    blob = open(path, "rb").read()
    assert blob.startswith(b"P6 120 120 255\n")
    assert len(blob) == len(b"P6 120 120 255\n") + 120 * 120 * 3


def test_decode_terrain_dimension_guard():
    # rows >= H but cols < W must fall back to zeros, not a ragged slice
    W, H = 64, 32
    img = NS(size=NS(x=48, y=40), bits_per_pixel=8,
             data=bytes(np.zeros(48 * 40, np.uint8)))
    gi = NS(start_raw=NS(terrain_height=img))
    out = decode_terrain(gi, (W, H))
    assert out.shape == (H, W)
    assert not out.any()


@pytest.mark.parametrize("scale,cursor", [(None, None), (1.0, (3, 7)), (0.25, (0, 0))])
def test_renders_equal_the_jax_observer(tmp_path, scale, cursor):
    """The same observation and camera give the JAX observer's grid, ASCII
    map, viewport rows, inspect overlay, HUD and PPM bytes."""
    rng = np.random.default_rng(0)
    obs, grid = _grid(map_x=96, map_y=80)
    terrain = rng.integers(0, 256, (80, 96), dtype=np.uint8)
    raw = obs.observation.raw_data
    grid = obs_to_grid(raw, (96, 80), 1, terrain)
    jgrid = jobserve.obs_to_grid(raw, (96, 80), 1, terrain)
    for k in grid:
        np.testing.assert_array_equal(grid[k], jgrid[k])
    views = [CameraView((96, 80), cols=40, rows=12), jobserve.CameraView((96, 80), cols=40, rows=12)]
    for view in views:
        if scale is not None:
            view.scale = scale
            view.cx, view.cy = 30.0, 41.0
        if cursor is not None:
            view.cur_col, view.cur_row = cursor
    assert views[0].render(grid) == views[1].render(jgrid)
    assert views[0].inspect(raw) == views[1].inspect(raw)
    assert hud_line(views[0], 5, grid, False) == jobserve.hud_line(views[1], 5, jgrid, False)
    assert render_ascii(grid, width=48) == jobserve.render_ascii(jgrid, width=48)
    render_ppm(grid, str(tmp_path / "port.ppm"))
    jobserve.render_ppm(jgrid, str(tmp_path / "jax.ppm"))
    assert (tmp_path / "port.ppm").read_bytes() == (tmp_path / "jax.ppm").read_bytes()
