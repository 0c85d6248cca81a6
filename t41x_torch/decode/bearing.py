"""DX country lookup + beam-heading utilities (host side).

Re-expression of the reference's bearing feature (tmr4/T41_SDR
`Bearing.cpp:974` `FindCountry` over the `dxCities[]` prefix table
`Bearing.cpp:101`, haversine distance `Bearing.cpp:1017`, azimuth via
`Target_Distance`): given a DX callsign, find the country and return the
great-circle beam heading + distance from the operator's QTH.

Design deviations from the reference (documented per PARITY.md):

* The table below is an independently-authored DXCC/ITU prefix list
  (amateur-radio prefix allocations with approximate entity-center
  coordinates) rather than a transcription of the reference's table;
  prefix→entity allocations are ITU facts, coordinates are entity
  centroids good to ~1° — ample for a beam heading.
* `find_country` does a **longest-prefix match** against the table.  The
  reference compares `len(prefix)` characters of the *user* string
  against each row in file order, which can read past the end of a
  shorter table entry; longest-prefix is the intended semantics.
* The QTH comes from a Maidenhead grid (shared with [[locator]] /
  FT8) instead of a map-file lat/lon.

BMP world-map blitting and the on-screen keyboard (`Bearing.cpp:1034,
577`) are host-UI rendering; the equivalent observable output here is
the (country, bearing°, km) tuple, which `t41x/io/display.py` can
annotate onto rendered frames.

A copy of `t41x.decode.bearing`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from t41x_torch.decode.locator import bearing_deg, distance_km, latlon_to_grid

# (prefix, entity, lat, lon) — longest-prefix match, case-insensitive.
# Approximate entity-center coordinates (degrees; +N / +E).
DXCC_TABLE: tuple[tuple[str, str, float, float], ...] = (
    ("1A", "Sov. Military Order of Malta", 41.9, 12.4),
    ("3A", "Monaco", 43.7, 7.4),
    ("3B8", "Mauritius", -20.3, 57.6),
    ("3B9", "Rodrigues Island", -19.7, 63.4),
    ("3C", "Equatorial Guinea", 1.6, 10.3),
    ("3D2", "Fiji", -17.7, 178.0),
    ("3DA", "Eswatini", -26.5, 31.5),
    ("3V", "Tunisia", 34.0, 9.0),
    ("3W", "Vietnam", 16.0, 107.8),
    ("3X", "Guinea", 10.4, -10.9),
    ("3Y", "Bouvet Island", -54.4, 3.4),
    ("4J", "Azerbaijan", 40.3, 47.7),
    ("4K", "Azerbaijan", 40.3, 47.7),
    ("4L", "Georgia", 42.0, 43.5),
    ("4O", "Montenegro", 42.7, 19.3),
    ("4S", "Sri Lanka", 7.5, 80.7),
    ("4U1ITU", "ITU HQ Geneva", 46.2, 6.1),
    ("4U1UN", "United Nations HQ", 40.7, -74.0),
    ("4W", "Timor-Leste", -8.8, 125.9),
    ("4X", "Israel", 31.4, 35.0),
    ("4Z", "Israel", 31.4, 35.0),
    ("5A", "Libya", 27.0, 17.0),
    ("5B", "Cyprus", 35.0, 33.2),
    ("5H", "Tanzania", -6.4, 35.0),
    ("5N", "Nigeria", 9.1, 8.7),
    ("5R", "Madagascar", -19.4, 46.7),
    ("5T", "Mauritania", 20.3, -10.3),
    ("5U", "Niger", 17.6, 8.1),
    ("5V", "Togo", 8.6, 1.0),
    ("5W", "Samoa", -13.8, -172.1),
    ("5X", "Uganda", 1.4, 32.3),
    ("5Y", "Kenya", 0.2, 37.9),
    ("5Z", "Kenya", 0.2, 37.9),
    ("6W", "Senegal", 14.4, -14.5),
    ("6Y", "Jamaica", 18.1, -77.3),
    ("7P", "Lesotho", -29.6, 28.2),
    ("7Q", "Malawi", -13.3, 34.3),
    ("7X", "Algeria", 28.0, 2.6),
    ("7Z", "Saudi Arabia", 24.0, 45.0),
    ("8P", "Barbados", 13.2, -59.5),
    ("8Q", "Maldives", 3.2, 73.2),
    ("8R", "Guyana", 4.9, -58.9),
    ("9A", "Croatia", 45.1, 15.2),
    ("9G", "Ghana", 7.9, -1.0),
    ("9H", "Malta", 35.9, 14.4),
    ("9J", "Zambia", -13.1, 27.8),
    ("9K", "Kuwait", 29.3, 47.5),
    ("9L", "Sierra Leone", 8.5, -11.8),
    ("9M2", "West Malaysia", 4.2, 102.0),
    ("9M6", "East Malaysia", 4.0, 114.0),
    ("9N", "Nepal", 28.4, 84.1),
    ("9Q", "DR Congo", -2.9, 23.6),
    ("9U", "Burundi", -3.4, 29.9),
    ("9V", "Singapore", 1.35, 103.8),
    ("9X", "Rwanda", -2.0, 29.9),
    ("9Y", "Trinidad & Tobago", 10.4, -61.3),
    ("A2", "Botswana", -22.3, 24.7),
    ("A3", "Tonga", -21.2, -175.2),
    ("A4", "Oman", 21.5, 55.9),
    ("A5", "Bhutan", 27.5, 90.4),
    ("A6", "United Arab Emirates", 24.0, 54.0),
    ("A7", "Qatar", 25.3, 51.2),
    ("A9", "Bahrain", 26.0, 50.5),
    ("AP", "Pakistan", 30.4, 69.3),
    ("B", "China", 35.9, 104.2),
    ("BV", "Taiwan", 23.7, 121.0),
    ("C2", "Nauru", -0.5, 166.9),
    ("C3", "Andorra", 42.5, 1.6),
    ("C5", "The Gambia", 13.4, -15.3),
    ("C6", "Bahamas", 24.3, -76.0),
    ("C9", "Mozambique", -18.7, 35.5),
    ("CE", "Chile", -33.5, -70.7),
    ("CE0Y", "Easter Island", -27.1, -109.4),
    ("CM", "Cuba", 21.5, -79.5),
    ("CN", "Morocco", 31.8, -7.1),
    ("CO", "Cuba", 21.5, -79.5),
    ("CP", "Bolivia", -16.7, -64.7),
    ("CT", "Portugal", 39.6, -8.0),
    ("CT3", "Madeira", 32.7, -17.0),
    ("CU", "Azores", 38.5, -28.0),
    ("CX", "Uruguay", -32.8, -56.0),
    ("D2", "Angola", -12.3, 17.5),
    ("D4", "Cape Verde", 16.0, -24.0),
    ("DL", "Germany", 51.1, 10.4),
    ("DU", "Philippines", 13.0, 122.0),
    ("E5", "Cook Islands", -21.2, -159.8),
    ("E7", "Bosnia-Herzegovina", 44.0, 17.8),
    ("EA", "Spain", 40.3, -3.7),
    ("EA6", "Balearic Islands", 39.6, 2.9),
    ("EA8", "Canary Islands", 28.3, -16.5),
    ("EA9", "Ceuta & Melilla", 35.9, -5.3),
    ("EI", "Ireland", 53.3, -8.0),
    ("EK", "Armenia", 40.2, 44.9),
    ("EL", "Liberia", 6.4, -9.4),
    ("EP", "Iran", 32.4, 53.7),
    ("ER", "Moldova", 47.2, 28.5),
    ("ES", "Estonia", 58.7, 25.5),
    ("ET", "Ethiopia", 9.1, 40.5),
    ("EU", "Belarus", 53.7, 27.9),
    ("EW", "Belarus", 53.7, 27.9),
    ("EX", "Kyrgyzstan", 41.2, 74.8),
    ("EY", "Tajikistan", 38.9, 71.3),
    ("EZ", "Turkmenistan", 38.9, 59.6),
    ("F", "France", 46.2, 2.2),
    ("FG", "Guadeloupe", 16.2, -61.5),
    ("FH", "Mayotte", -12.8, 45.2),
    ("FK", "New Caledonia", -21.3, 165.5),
    ("FM", "Martinique", 14.6, -61.0),
    ("FO", "French Polynesia", -17.6, -149.6),
    ("FP", "St. Pierre & Miquelon", 46.9, -56.3),
    ("FR", "Reunion", -21.1, 55.5),
    ("FY", "French Guiana", 4.0, -53.0),
    ("G", "England", 52.5, -1.5),
    ("GD", "Isle of Man", 54.2, -4.5),
    ("GI", "Northern Ireland", 54.6, -6.7),
    ("GJ", "Jersey", 49.2, -2.1),
    ("GM", "Scotland", 56.8, -4.2),
    ("GU", "Guernsey", 49.5, -2.6),
    ("GW", "Wales", 52.3, -3.7),
    ("H4", "Solomon Islands", -9.6, 160.2),
    ("HA", "Hungary", 47.2, 19.5),
    ("HB", "Switzerland", 46.8, 8.2),
    ("HB0", "Liechtenstein", 47.2, 9.5),
    ("HC", "Ecuador", -1.8, -78.2),
    ("HH", "Haiti", 19.0, -72.7),
    ("HI", "Dominican Republic", 18.7, -70.2),
    ("HK", "Colombia", 4.6, -74.1),
    ("HL", "South Korea", 36.5, 127.8),
    ("HP", "Panama", 8.5, -80.1),
    ("HR", "Honduras", 14.8, -86.6),
    ("HS", "Thailand", 15.1, 101.0),
    ("HV", "Vatican City", 41.9, 12.45),
    ("HZ", "Saudi Arabia", 24.0, 45.0),
    ("I", "Italy", 42.8, 12.8),
    ("IS0", "Sardinia", 40.1, 9.1),
    ("J2", "Djibouti", 11.8, 42.6),
    ("J3", "Grenada", 12.1, -61.7),
    ("J5", "Guinea-Bissau", 11.8, -15.2),
    ("J6", "St. Lucia", 13.9, -61.0),
    ("J7", "Dominica", 15.4, -61.4),
    ("J8", "St. Vincent", 13.3, -61.2),
    ("JA", "Japan", 36.2, 138.3),
    ("JT", "Mongolia", 46.9, 103.8),
    ("JW", "Svalbard", 78.2, 15.6),
    ("JY", "Jordan", 31.3, 36.4),
    ("K", "United States", 39.8, -98.6),
    ("KH0", "Mariana Islands", 15.2, 145.7),
    ("KH2", "Guam", 13.4, 144.8),
    ("KH6", "Hawaii", 20.8, -156.3),
    ("KL", "Alaska", 64.1, -152.3),
    ("KP2", "US Virgin Islands", 18.0, -64.8),
    ("KP4", "Puerto Rico", 18.2, -66.4),
    ("LA", "Norway", 61.0, 9.0),
    ("LU", "Argentina", -34.6, -64.0),
    ("LX", "Luxembourg", 49.8, 6.1),
    ("LY", "Lithuania", 55.2, 23.9),
    ("LZ", "Bulgaria", 42.7, 25.2),
    ("OA", "Peru", -9.2, -75.0),
    ("OD", "Lebanon", 33.9, 35.9),
    ("OE", "Austria", 47.6, 14.1),
    ("OH", "Finland", 62.9, 26.3),
    ("OH0", "Aland Islands", 60.2, 20.0),
    ("OK", "Czech Republic", 49.8, 15.5),
    ("OM", "Slovakia", 48.7, 19.5),
    ("ON", "Belgium", 50.6, 4.7),
    ("OX", "Greenland", 71.7, -42.6),
    ("OY", "Faroe Islands", 62.0, -6.9),
    ("OZ", "Denmark", 56.0, 10.0),
    ("P2", "Papua New Guinea", -6.5, 145.0),
    ("P4", "Aruba", 12.5, -70.0),
    ("P5", "North Korea", 40.3, 127.0),
    ("PA", "Netherlands", 52.2, 5.5),
    ("PJ2", "Curacao", 12.2, -69.0),
    ("PJ4", "Bonaire", 12.2, -68.3),
    ("PJ7", "Sint Maarten", 18.0, -63.1),
    ("PY", "Brazil", -10.8, -52.9),
    ("PY0F", "Fernando de Noronha", -3.85, -32.4),
    ("PZ", "Suriname", 4.0, -56.0),
    ("R", "European Russia", 55.8, 37.6),
    ("R0", "Asiatic Russia", 60.0, 100.0),
    ("S0", "Western Sahara", 24.2, -12.9),
    ("S2", "Bangladesh", 23.7, 90.4),
    ("S5", "Slovenia", 46.1, 14.8),
    ("S7", "Seychelles", -4.7, 55.5),
    ("S9", "Sao Tome & Principe", 0.2, 6.6),
    ("SM", "Sweden", 62.2, 14.8),
    ("SP", "Poland", 52.1, 19.4),
    ("ST", "Sudan", 15.6, 30.2),
    ("SU", "Egypt", 26.8, 30.8),
    ("SV", "Greece", 39.1, 22.9),
    ("SV5", "Dodecanese", 36.4, 27.2),
    ("SV9", "Crete", 35.2, 24.9),
    ("T3", "Kiribati", 1.9, -157.4),
    ("T5", "Somalia", 5.2, 46.2),
    ("T7", "San Marino", 43.9, 12.5),
    ("TA", "Turkey", 39.0, 35.2),
    ("TF", "Iceland", 64.9, -19.0),
    ("TG", "Guatemala", 15.8, -90.2),
    ("TI", "Costa Rica", 9.9, -84.2),
    ("TJ", "Cameroon", 5.7, 12.7),
    ("TK", "Corsica", 42.2, 9.1),
    ("TL", "Central African Republic", 6.6, 20.9),
    ("TN", "Congo", -0.7, 14.9),
    ("TR", "Gabon", -0.6, 11.6),
    ("TT", "Chad", 15.4, 18.7),
    ("TU", "Cote d'Ivoire", 7.5, -5.5),
    ("TY", "Benin", 9.3, 2.3),
    ("TZ", "Mali", 17.6, -4.0),
    ("UA", "European Russia", 55.8, 37.6),
    ("UA9", "Asiatic Russia", 60.0, 100.0),
    ("UK", "Uzbekistan", 41.4, 64.6),
    ("UN", "Kazakhstan", 48.0, 66.9),
    ("UR", "Ukraine", 49.0, 31.4),
    ("V2", "Antigua & Barbuda", 17.1, -61.8),
    ("V3", "Belize", 17.2, -88.7),
    ("V4", "St. Kitts & Nevis", 17.3, -62.7),
    ("V5", "Namibia", -22.1, 17.2),
    ("V6", "Micronesia", 6.9, 158.2),
    ("V7", "Marshall Islands", 7.1, 171.2),
    ("V8", "Brunei", 4.5, 114.7),
    ("VE", "Canada", 56.1, -106.3),
    ("VK", "Australia", -25.3, 133.8),
    ("VK9N", "Norfolk Island", -29.0, 168.0),
    ("VP2E", "Anguilla", 18.2, -63.1),
    ("VP8", "Falkland Islands", -51.8, -59.5),
    ("VP9", "Bermuda", 32.3, -64.8),
    ("VQ9", "Chagos Islands", -7.3, 72.4),
    ("VR", "Hong Kong", 22.3, 114.2),
    ("VU", "India", 21.8, 78.7),
    ("XE", "Mexico", 23.6, -102.6),
    ("XT", "Burkina Faso", 12.2, -1.6),
    ("XU", "Cambodia", 12.5, 104.9),
    ("XW", "Laos", 18.2, 103.9),
    ("XX9", "Macao", 22.2, 113.6),
    ("XZ", "Myanmar", 19.2, 96.7),
    ("YA", "Afghanistan", 33.9, 67.7),
    ("YB", "Indonesia", -2.5, 118.0),
    ("YI", "Iraq", 33.2, 43.7),
    ("YJ", "Vanuatu", -16.6, 168.2),
    ("YK", "Syria", 34.8, 38.5),
    ("YL", "Latvia", 56.9, 24.6),
    ("YN", "Nicaragua", 12.9, -85.2),
    ("YO", "Romania", 45.9, 25.0),
    ("YS", "El Salvador", 13.8, -88.9),
    ("YU", "Serbia", 44.2, 20.9),
    ("YV", "Venezuela", 6.4, -66.6),
    ("Z2", "Zimbabwe", -19.0, 29.9),
    ("Z3", "North Macedonia", 41.6, 21.7),
    ("Z6", "Kosovo", 42.6, 20.9),
    ("ZA", "Albania", 41.2, 20.2),
    ("ZB", "Gibraltar", 36.1, -5.35),
    ("ZD7", "St. Helena", -15.9, -5.7),
    ("ZD8", "Ascension Island", -7.9, -14.4),
    ("ZF", "Cayman Islands", 19.3, -81.3),
    ("ZL", "New Zealand", -41.8, 172.8),
    ("ZP", "Paraguay", -23.4, -58.4),
    ("ZS", "South Africa", -29.0, 25.1),
)

# search in descending prefix-length order → longest-prefix match
_BY_LENGTH = sorted(DXCC_TABLE, key=lambda row: -len(row[0]))


@dataclass(frozen=True)
class Country:
    prefix: str
    name: str
    lat: float
    lon: float

    @property
    def grid(self) -> str:
        return latlon_to_grid(self.lat, self.lon)


def callsign_prefix(callsign: str) -> str:
    """Strip portable designators (`W1AW/7`, `EA8/G4ABC`) down to the
    DX prefix portion actually used for entity lookup.

    Mirrors the reference's manual prefix entry (the operator types the
    prefix on the on-screen keyboard, `Bearing.cpp:674`); here we accept
    a full callsign and derive the prefix automatically.
    """
    c = callsign.strip().upper()
    if "/" in c:
        parts = c.split("/")
        # prefix-style portable (EA8/G4ABC): the shorter leading part
        # that is itself a valid prefix wins; else drop trailing /P /7 …
        if len(parts[0]) <= 4 and _lookup(parts[0]) is not None:
            c = parts[0] if len(parts[0]) < len(parts[1]) else parts[1]
        else:
            c = parts[0]
    return c


def _lookup(pfx: str) -> Country | None:
    for p, name, lat, lon in _BY_LENGTH:
        if pfx.startswith(p):
            return Country(p, name, lat, lon)
    return None


def find_country(callsign: str) -> Country | None:
    """Longest-prefix DXCC lookup (reference `FindCountry`
    `Bearing.cpp:974`); returns None when no entity matches."""
    return _lookup(callsign_prefix(callsign))


def dx_heading(home_grid: str, callsign: str
               ) -> tuple[Country, float, float] | None:
    """(country, bearing° true, distance km) from `home_grid` to the
    entity of `callsign` — the reference's bearing-map readout
    (`Bearing.cpp:932-947` lookup → haversine → azimuth)."""
    country = find_country(callsign)
    if country is None:
        return None
    dx = country.grid
    return country, bearing_deg(home_grid, dx), distance_km(home_grid, dx)
