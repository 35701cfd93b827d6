"""Native viewer tests: PPM/PNG writers, ANSI compositor, fallbacks."""

import os

import numpy as np
import pytest

from raycastworlds_tpu.utils import viewer


@pytest.fixture
def frame():
    img = np.zeros((8, 8), np.uint32)
    img[:4] = 0x00FF0000  # top half red
    img[4:] = 0x000000FF  # bottom half blue
    return img


def test_save_ppm(tmp_path, frame):
    p = str(tmp_path / "f.ppm")
    viewer.save_ppm(p, frame)
    data = open(p, "rb").read()
    assert data.startswith(b"P6")
    body = data.split(b"255\n", 1)[1]
    assert len(body) == 8 * 8 * 3
    # first pixel red, last pixel blue
    assert body[:3] == b"\xff\x00\x00"
    assert body[-3:] == b"\x00\x00\xff"


def test_save_png(tmp_path, frame):
    p = str(tmp_path / "f.png")
    viewer.save_png(p, frame)
    data = open(p, "rb").read()
    assert data.startswith(b"\x89PNG")
    assert b"IHDR" in data and b"IDAT" in data and b"IEND" in data


def test_ansi_frame(frame):
    s = viewer.ansi_frame(frame)
    assert "\x1b[38;2;255;0;0m" in s  # red foreground appears
    assert "\x1b[48;2;0;0;255m" in s  # blue background appears
    assert "▀" in s
    # 4 rendered rows (8 px / 2 per cell)
    assert s.count("\n") == 4


def test_ansi_native_matches_fallback(frame):
    lib = viewer._native_lib()
    if lib is None:
        pytest.skip("native viewer not built")
    native = viewer.ansi_frame(frame)
    saved = viewer._LIB
    try:
        viewer._LIB = None
        fallback = viewer.ansi_frame(frame)
    finally:
        viewer._LIB = saved
    # same escape content modulo trailing newline handling
    assert native.replace("\n", "") == fallback.replace("\n", "")


def test_play_headless_renders_one_frame(capsys):
    import io

    out = io.StringIO()
    viewer.play(seed=0, max_width=32, out=out)
    s = out.getvalue()
    assert "steps=0" in s
    assert "▀" in s


def test_window_degrades_headless(monkeypatch):
    # No $DISPLAY: the X11 path must report unavailable and open None —
    # headless accelerator hosts fall back to the terminal in play().
    monkeypatch.delenv("DISPLAY", raising=False)
    assert viewer.Window.available() is False
    assert viewer.Window.open("t", 16, 16) is None


def test_window_refused_display(monkeypatch):
    # A set-but-dead DISPLAY: libX11 loads (available), the connection is
    # refused, and open returns None instead of crashing.
    monkeypatch.setenv("DISPLAY", ":99")
    lib = viewer._native_lib()
    if lib is None or not hasattr(lib, "rcw_window_open"):
        pytest.skip("native viewer not built")
    assert viewer.Window.open("t", 16, 16) is None


def test_play_auto_window_falls_back(monkeypatch):
    # window=None auto-detect on a headless host must still render.
    import io

    monkeypatch.delenv("DISPLAY", raising=False)
    out = io.StringIO()
    viewer.play(seed=1, max_width=32, out=out, window=None)
    assert "steps=0" in out.getvalue()
