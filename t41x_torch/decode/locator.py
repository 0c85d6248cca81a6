"""Maidenhead locator / bearing utilities (host side).

Re-expression of the reference's locator + bearing math
(tmr4/T41_SDR `locator.cpp:30-90` `process_locator`/`distance`,
`Bearing.cpp:1017` haversine) used for FT8 distance and the bearing map.

A copy of `t41x.decode.locator`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import math

EARTH_RADIUS_KM = 6371.0


def grid_to_latlon(grid: str) -> tuple[float, float]:
    """Maidenhead locator (4 or 6 chars) -> (lat, lon) of square center."""
    g = grid.strip().upper()
    if len(g) < 4:
        raise ValueError(f"bad locator {grid!r}")
    lon = (ord(g[0]) - 65) * 20.0 - 180.0
    lat = (ord(g[1]) - 65) * 10.0 - 90.0
    lon += int(g[2]) * 2.0
    lat += int(g[3]) * 1.0
    if len(g) >= 6:
        lon += (ord(g[4]) - 65) * 5.0 / 60.0 + 2.5 / 60.0
        lat += (ord(g[5]) - 65) * 2.5 / 60.0 + 1.25 / 60.0
    else:
        lon += 1.0
        lat += 0.5
    return lat, lon


def latlon_to_grid(lat: float, lon: float, precision: int = 6) -> str:
    lon += 180.0
    lat += 90.0
    g = chr(65 + int(lon // 20)) + chr(65 + int(lat // 10))
    lon %= 20.0
    lat %= 10.0
    g += str(int(lon // 2)) + str(int(lat // 1))
    if precision >= 6:
        lon = (lon % 2.0) * 60.0
        lat = (lat % 1.0) * 60.0
        g += chr(97 + int(lon // 5)) + chr(97 + int(lat // 2.5))
    return g


def distance_km(grid_a: str, grid_b: str) -> float:
    """Great-circle distance between two locators (haversine)."""
    la1, lo1 = map(math.radians, grid_to_latlon(grid_a))
    la2, lo2 = map(math.radians, grid_to_latlon(grid_b))
    dla, dlo = la2 - la1, lo2 - lo1
    a = (math.sin(dla / 2) ** 2
         + math.cos(la1) * math.cos(la2) * math.sin(dlo / 2) ** 2)
    return 2 * EARTH_RADIUS_KM * math.asin(min(1.0, math.sqrt(a)))


def bearing_deg(grid_from: str, grid_to: str) -> float:
    """Initial great-circle bearing, degrees true."""
    la1, lo1 = map(math.radians, grid_to_latlon(grid_from))
    la2, lo2 = map(math.radians, grid_to_latlon(grid_to))
    dlo = lo2 - lo1
    y = math.sin(dlo) * math.cos(la2)
    x = (math.cos(la1) * math.sin(la2)
         - math.sin(la1) * math.cos(la2) * math.cos(dlo))
    return (math.degrees(math.atan2(y, x)) + 360.0) % 360.0
