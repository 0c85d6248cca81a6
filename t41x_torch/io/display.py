"""Host-side panadapter rendering: spectrum + waterfall tensors → image.

Re-expression of the reference's display layer (tmr4/T41_SDR
`Display.cpp`): the spectrum polyline (`ShowSpectrum` `Display.cpp:240`,
drawn column-by-column at `:343-362`), the scrolling waterfall with its
gradient LUT (`gradient[]` `Display.cpp:148`, pixel mapping `:459-466`,
BTE scroll `:476-492`), the dB scale (`ShowSpectrumdBScale:608`,
`displayScale[]` `Display.cpp:127`), the bandwidth bar
(`DrawBandwidthBar:1098`) and the S-meter bar (`DrawSmeterBar:955`).

Design deviations (TPU-first, documented per PARITY.md):

* The chain produces whole spectrum/waterfall *tensors* per step; the
  reference's per-pixel-column interleave of DSP and SPI pushes
  (SURVEY.md §1 quirk) does not exist here.  Rendering is a pure host
  function over those tensors.
* The waterfall colormap is synthesized as a piecewise-linear ramp
  through the reference gradient's anchor colors (black → blue → cyan →
  green → yellow → red → pink) instead of transcribing the 117-entry
  RGB565 table — same visual semantics, resolution-independent.
* Output is an RGB uint8 array (+ optional PNG via PIL) or an ASCII
  panadapter for terminals, instead of RA8875 layer blits.

A copy of `t41x.io.display`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import numpy as np

SPECTRUM_RES = 512          # reference Display.h:11

# dB-per-division table (reference `displayScale[]` Display.cpp:127):
# (label, pixels_per_dB)
DISPLAY_SCALES = (
    ("20 dB/", 2.0),
    ("10 dB/", 4.0),
    ("5 dB/", 8.0),
    ("2 dB/", 20.0),
    ("1 dB/", 40.0),
)

# colormap anchors: fraction of range -> RGB  (gradient[] semantics)
_ANCHORS = (
    (0.00, (0, 0, 0)),
    (0.10, (0, 0, 160)),
    (0.22, (0, 110, 255)),
    (0.32, (0, 255, 200)),
    (0.45, (40, 255, 40)),
    (0.60, (255, 255, 0)),
    (0.75, (255, 60, 0)),
    (0.90, (255, 0, 80)),
    (1.00, (255, 130, 220)),
)


def waterfall_colormap(n: int = 117) -> np.ndarray:
    """(n, 3) uint8 colormap; n defaults to the reference LUT length."""
    xs = np.linspace(0.0, 1.0, n)
    pts = np.array([a for a, _ in _ANCHORS])
    cols = np.array([c for _, c in _ANCHORS], dtype=np.float64)
    out = np.stack([np.interp(xs, pts, cols[:, k]) for k in range(3)],
                   axis=1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def waterfall_rows_to_rgb(rows_db: np.ndarray, floor_db: float = 0.0,
                          scale_index: int = 1) -> np.ndarray:
    """Map waterfall rows (time, bins) in dB-above-noise to RGB.

    Mirrors the reference pixel mapping (`Display.cpp:459-466`): value
    clipped into the LUT range, newest row first.
    """
    cmap = waterfall_colormap()
    pix = (np.asarray(rows_db, np.float64) - floor_db) \
        * DISPLAY_SCALES[scale_index][1]
    idx = np.clip(pix.astype(np.int64), 0, len(cmap) - 1)
    return cmap[idx]


def render_panadapter(spectrum_db: np.ndarray,
                      waterfall_db: np.ndarray | None = None,
                      *, floor_db: float = 0.0, scale_index: int = 1,
                      spectrum_height: int = 150,
                      f_lo: float | None = None,
                      f_hi: float | None = None,
                      span_hz: float | None = None) -> np.ndarray:
    """Compose the panadapter: spectrum polyline over a waterfall.

    spectrum_db: (bins,) latest spectrum, dB (relative floor is fine).
    waterfall_db: (rows, bins) history, newest row first (optional).
    f_lo/f_hi + span_hz: filter passband edges, drawn as the reference's
    bandwidth bar (center of the display = tuned frequency).

    Returns (H, bins, 3) uint8.
    """
    spec = np.asarray(spectrum_db, np.float64)
    bins = spec.shape[-1]
    px_per_db = DISPLAY_SCALES[scale_index][1]

    pane = np.zeros((spectrum_height, bins, 3), np.uint8)
    pane[..., :] = (10, 12, 24)          # dark background
    # horizontal graticule every 10 dB
    for db in range(0, int(spectrum_height / px_per_db) + 1, 10):
        y = spectrum_height - 1 - int(db * px_per_db)
        if 0 <= y < spectrum_height:
            pane[y, :, :] = (28, 32, 52)

    # bandwidth bar (DrawBandwidthBar): shade the passband columns
    if f_lo is not None and f_hi is not None and span_hz:
        c0 = int((0.5 + f_lo / span_hz) * bins)
        c1 = int((0.5 + f_hi / span_hz) * bins)
        c0, c1 = sorted((c0, c1))
        c0, c1 = max(c0, 0), min(c1, bins)
        pane[:, c0:c1, :] = np.maximum(pane[:, c0:c1, :], 40)
        mid = bins // 2
        pane[:, mid, :] = (120, 0, 0)    # tuned-frequency cursor

    # spectrum polyline: fill under the curve, bright line on top
    h = np.clip(((spec - floor_db) * px_per_db).astype(np.int64),
                0, spectrum_height - 1)
    ys = spectrum_height - 1 - h
    col_idx = np.arange(bins)
    rows_grid = np.arange(spectrum_height)[:, None]
    under = rows_grid >= ys[None, :]
    pane[under] = np.maximum(pane[under], np.uint8(60))
    pane[ys, col_idx] = (255, 255, 120)

    panes = [pane]
    if waterfall_db is not None and len(waterfall_db):
        panes.append(waterfall_rows_to_rgb(waterfall_db, floor_db,
                                           scale_index))
    return np.concatenate(panes, axis=0)


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(np.asarray(img, np.uint8), "RGB").save(path)


# S-unit color ladder for beacon SNR patches (reference
# `beaconSNRColor[]` / `GetSNRColor` `Beacon.cpp:280-295`: one color per
# 6 dB ≈ one S-unit, black → grey → purple → blue → cyan → greens →
# yellow → orange → red).
SNR_COLORS = (
    (0, 0, 0), (140, 140, 140), (160, 40, 200), (40, 60, 255),
    (0, 220, 220), (0, 130, 0), (0, 255, 0), (255, 255, 0),
    (255, 140, 0), (255, 0, 0),
)


def snr_color(snr_db: float) -> tuple[int, int, int]:
    """SNR in dB -> patch color, one step per 6 dB (S-unit)."""
    if not np.isfinite(snr_db) or snr_db <= 0:
        return SNR_COLORS[0]
    return SNR_COLORS[min(int(snr_db // 6), len(SNR_COLORS) - 1)]


def render_beacon_map(beacon_report, home_grid: str | None = None,
                      band_index: int = 0, scale: int = 3) -> np.ndarray:
    """World-map beacon SNR display (reference `DisplayBeaconsSNR`
    `Beacon.cpp:297`): an equirectangular canvas with one colored patch
    per NCDXF beacon, colored by measured SNR on the selected band, plus
    the operator QTH marker.

    The reference blits a BMP world map from SD; here the map is a
    graticule canvas (no bundled bitmap), and the observable product —
    beacon position + SNR color — is identical.  Returns
    (180*scale, 360*scale, 3) uint8.
    """
    from t41x_torch.decode.beacon import BEACONS
    from t41x_torch.decode.locator import grid_to_latlon

    h, w = 180 * scale, 360 * scale
    img = np.zeros((h, w, 3), np.uint8)
    img[..., :] = (8, 12, 28)
    # graticule every 30°
    for lat in range(-90, 91, 30):
        img[min(int((90 - lat) * scale), h - 1), :, :] = (30, 36, 60)
    for lon in range(-180, 181, 30):
        img[:, min(int((lon + 180) * scale), w - 1), :] = (30, 36, 60)

    def patch(lat, lon, color, r):
        y = int((90.0 - lat) * scale)
        x = int((lon + 180.0) * scale)
        img[max(y - r, 0): y + r + 1, max(x - r, 0): x + r + 1] = color

    snr = np.asarray(beacon_report.snr)
    for i, (call, grid) in enumerate(BEACONS):
        lat, lon = grid_to_latlon(grid)
        patch(lat, lon, snr_color(float(snr[i, band_index])), scale)
    if home_grid:
        lat, lon = grid_to_latlon(home_grid)
        patch(lat, lon, (255, 255, 255), scale + 1)
    return img


def render_bearing_map(home_grid: str, callsign: str,
                       scale: int = 3) -> tuple[np.ndarray, dict]:
    """DX bearing map (reference `bmpDraw` + `BeaconBearingHeading`
    `Bearing.cpp:825,1034`): world canvas with the operator QTH, the DX
    country location (longest-prefix DXCC lookup), and the great-circle
    path between them.  The reference blits a BMP from SD and draws the
    heading line; the observable product — endpoints, path, heading and
    distance — is identical.  Returns (image, info dict)."""
    from t41x_torch.decode import bearing as bearing_mod
    from t41x_torch.decode.locator import (bearing_deg, distance_km,
                                     grid_to_latlon)

    country = bearing_mod.find_country(callsign)
    if country is None:
        raise ValueError(f"no DXCC match for callsign {callsign!r}")
    dx_grid = country.grid
    heading = bearing_deg(home_grid, dx_grid)
    dist = distance_km(home_grid, dx_grid)

    h, w = 180 * scale, 360 * scale
    img = np.zeros((h, w, 3), np.uint8)
    img[..., :] = (8, 12, 28)
    for lat in range(-90, 91, 30):
        img[min(int((90 - lat) * scale), h - 1), :, :] = (30, 36, 60)
    for lon in range(-180, 181, 30):
        img[:, min(int((lon + 180) * scale), w - 1), :] = (30, 36, 60)

    def to_xy(lat, lon):
        return (int((90.0 - lat) * scale), int((lon + 180.0) * scale))

    def patch(lat, lon, color, r):
        y, x = to_xy(lat, lon)
        img[max(y - r, 0): y + r + 1, max(x - r, 0): x + r + 1] = color

    # great-circle path via slerp between the unit vectors
    la1, lo1 = np.radians(grid_to_latlon(home_grid))
    la2, lo2 = np.radians(grid_to_latlon(dx_grid))
    v1 = np.array([np.cos(la1) * np.cos(lo1), np.cos(la1) * np.sin(lo1),
                   np.sin(la1)])
    v2 = np.array([np.cos(la2) * np.cos(lo2), np.cos(la2) * np.sin(lo2),
                   np.sin(la2)])
    omega = np.arccos(np.clip(np.dot(v1, v2), -1.0, 1.0))
    for f in np.linspace(0.0, 1.0, 256):
        if omega < 1e-9:
            v = v1
        else:
            v = (np.sin((1 - f) * omega) * v1 + np.sin(f * omega) * v2) \
                / np.sin(omega)
        lat = np.degrees(np.arcsin(np.clip(v[2], -1.0, 1.0)))
        lon = np.degrees(np.arctan2(v[1], v[0]))
        y, x = to_xy(lat, lon)
        img[min(y, h - 1), min(x, w - 1)] = (255, 210, 60)

    patch(*grid_to_latlon(home_grid), (255, 255, 255), scale + 1)
    patch(*grid_to_latlon(dx_grid), (255, 60, 60), scale + 1)
    info = {"country": country.name, "grid": dx_grid,
            "bearing_deg": heading, "distance_km": dist}
    return img, info


def render_smeter(dbm: float, width: int = 360, height: int = 24
                  ) -> np.ndarray:
    """S-meter bar (reference `DrawSmeterBar` `Display.cpp:955`):
    S1..S9 green segment, over-S9 red segment, 6 dB per S-unit,
    S9 = -73 dBm."""
    img = np.zeros((height, width, 3), np.uint8)
    img[..., :] = (12, 12, 20)
    s9_px = int(width * 0.6)
    s_units = (dbm + 127.0) / 6.0          # S1 at -121 dBm
    frac = np.clip(s_units / 9.0, 0.0, 1.0)
    img[2:-2, : int(frac * s9_px)] = (0, 255, 0)
    if dbm > -73.0:
        over = np.clip((dbm + 73.0) / 40.0, 0.0, 1.0)
        img[2:-2, s9_px: s9_px + int(over * (width - s9_px))] = (255, 0, 0)
    # S-unit tick marks
    for s in range(1, 10):
        img[:, int(s / 9.0 * s9_px) - 1, :] = (80, 80, 100)
    return img


def ascii_spectrum(spectrum_db: np.ndarray, width: int = 80,
                   height: int = 12, floor_db: float = 0.0,
                   ceil_db: float = 60.0) -> str:
    """Terminal panadapter (no reference analog — CLI affordance)."""
    spec = np.asarray(spectrum_db, np.float64)
    # max-pool bins down to `width` columns
    pad = (-len(spec)) % width
    cols = np.pad(spec, (0, pad), constant_values=spec.min()) \
        .reshape(width, -1).max(axis=1)
    lvl = np.clip((cols - floor_db) / max(ceil_db - floor_db, 1e-9), 0, 1)
    h = np.rint(lvl * height).astype(int)
    lines = []
    for row in range(height, 0, -1):
        lines.append("".join("#" if h[c] >= row else " "
                             for c in range(width)))
    lines.append("-" * width)
    return "\n".join(lines)
