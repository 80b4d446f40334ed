"""Geo-referencing: world coordinates -> geodetic lat/long.

The reference converts each segment's center to lat/long with proj4rs using a
user-editable proj string, default UTM zone 32 on GRS80
(treee/src/interactive/mod.rs:53,235-243), and formats degrees as D°M'S"
(mod.rs:1060-1066).  No proj library ships in this environment, so this module
implements the inverse projections directly from the published formulas:

- ``+proj=utm``    — inverse transverse Mercator via the 4th-order Krüger
  series (sub-millimeter over UTM extents), zone/+south handling;
- ``+proj=tmerc``  — the general form: arbitrary +lat_0/+lon_0/+k(_0)/
  +x_0/+y_0, lat_0 entering through the meridian arc;
- ``+proj=merc``   — ellipsoidal Mercator inverse (isometric -> conformal ->
  geodetic latitude via the same series), ``+lat_ts`` honored;
- ``+proj=webmerc`` — spherical ("web") Mercator on the ellipsoid's a;
- ``+proj=lcc``    — Lambert conformal conic, 1SP (+lat_1 [+k_0]) and 2SP
  (+lat_1 +lat_2), Snyder 15-1..15-11 inverted through the conformal series;
- ``+proj=stere``  — stereographic: exact ellipsoidal polar aspect
  (+lat_ts or +k_0) and the conformal-latitude oblique/equatorial form
  (Snyder 21-27..21-39), e.g. UPS / EPSG:3413 / EPSG:3031;
- ``+proj=sterea`` — oblique stereographic via the Gauss conformal sphere
  (EPSG 9809 double projection — Dutch RD New);
- ``+proj=somerc`` — Swiss oblique Mercator (EPSG 9815 — CH1903/LV03+LV95);
- ``+proj=aea``    — Albers equal-area conic (authalic-latitude series);
- ``+proj=laea``   — Lambert azimuthal equal-area, oblique + polar aspects
  (ETRS89-LAEA Europe, EPSG:3035);
- ``+proj=eqc``    — equidistant cylindrical / plate carrée;
- ``+proj=longlat``/``latlong``/``lonlat`` — identity (degrees in, radians out);
- ellipsoids by ``+ellps`` name (GRS80/WGS84/intl/bessel/clrk66/krass/sphere),
  by ``+datum`` alias (WGS84/NAD83/NAD27/potsdam/ch1903), explicit ``+a`` with
  ``+b``/``+f``/``+rf``, or a sphere radius ``+R``.

Together these are the projection families behind essentially every national
LiDAR CRS (UTM/Gauss-Krüger, US state planes, Lambert-93, RD New, LV95,
polar grids, LAEA Europe).

Datum shifts (``+towgs84``, grids) are accepted but ignored — the reference's
proj4rs pipeline applies them only between two full CRS definitions, and the
app's single-string use (projected -> longlat on the SAME datum) never
exercises them.  Unknown ``+proj`` families raise :class:`ProjError`, which
the callers surface as "proj string did not parse" (mod.rs:470-488 text box
semantics: bad strings simply show no coordinates).
"""

from __future__ import annotations

import math

# named ellipsoids (semi-major axis, flattening), proj4 table subset
_ELLIPSOIDS = {
    "GRS80": (6378137.0, 1.0 / 298.257222101),
    "WGS84": (6378137.0, 1.0 / 298.257223563),
    "intl": (6378388.0, 1.0 / 297.0),
    "bessel": (6377397.155, 1.0 / 299.1528128),
    "clrk66": (6378206.4, 1.0 / 294.9786982),
    "krass": (6378245.0, 1.0 / 298.3),
    "sphere": (6371000.0, 0.0),
}

UTM_SCALE = 0.9996
UTM_FALSE_EASTING = 500_000.0
UTM_FALSE_NORTHING_SOUTH = 10_000_000.0


class ProjError(ValueError):
    pass


def parse_proj(proj_string: str) -> dict:
    """Parse a proj string into a parameter dict (+k=v / +flag tokens)."""
    params: dict[str, str | bool] = {}
    for tok in proj_string.split():
        if not tok.startswith("+"):
            raise ProjError(f"bad proj token {tok!r}")
        body = tok[1:]
        if "=" in body:
            k, v = body.split("=", 1)
            params[k] = v
        else:
            params[body] = True
    if "proj" not in params:
        raise ProjError("proj string has no +proj")
    return params


# +datum implies an ellipsoid when neither +a nor +ellps is given
_DATUM_ELLPS = {
    "WGS84": "WGS84",
    "NAD83": "GRS80",
    "NAD27": "clrk66",
    "potsdam": "bessel",
    "ch1903": "bessel",
}


def _ellipsoid(params: dict) -> tuple[float, float]:
    """(a, f) from +ellps / +datum / explicit +a with +b/+f/+rf / +R."""
    if "a" in params:
        a = float(params["a"])
        if "rf" in params:
            f = 1.0 / float(params["rf"])
        elif "f" in params:
            f = float(params["f"])
        elif "b" in params:
            f = (a - float(params["b"])) / a
        else:
            f = 0.0  # sphere
        return a, f
    if "R" in params:
        return float(params["R"]), 0.0
    if "ellps" not in params and "datum" in params:
        datum = str(params["datum"])
        if datum not in _DATUM_ELLPS:
            raise ProjError(f"unsupported datum {datum!r}")
        return _ELLIPSOIDS[_DATUM_ELLPS[datum]]
    name = str(params.get("ellps", "GRS80"))
    if name not in _ELLIPSOIDS:
        raise ProjError(f"unsupported ellipsoid {name!r}")
    return _ELLIPSOIDS[name]


def _third_flattening(f: float) -> float:
    return f / (2.0 - f)


def _rectifying_radius(a: float, n: float) -> float:
    return a / (1.0 + n) * (1.0 + n**2 / 4.0 + n**4 / 64.0)


def _meridian_arc(lat: float, n: float, big_a: float) -> float:
    """Meridian arc length from the equator (rectifying-latitude series)."""
    mu = (
        lat
        - (3.0 * n / 2.0 - 9.0 * n**3 / 16.0) * math.sin(2.0 * lat)
        + (15.0 * n**2 / 16.0 - 15.0 * n**4 / 32.0) * math.sin(4.0 * lat)
        - (35.0 * n**3 / 48.0) * math.sin(6.0 * lat)
        + (315.0 * n**4 / 512.0) * math.sin(8.0 * lat)
    )
    return big_a * mu


def _conformal_to_geodetic(chi: float, n: float) -> float:
    delta = [
        2.0 * n - 2.0 * n**2 / 3.0 - 2.0 * n**3 + 116.0 * n**4 / 45.0,
        7.0 * n**2 / 3.0 - 8.0 * n**3 / 5.0 - 227.0 * n**4 / 45.0,
        56.0 * n**3 / 15.0 - 136.0 * n**4 / 35.0,
        4279.0 * n**4 / 630.0,
    ]
    lat = chi
    for j, dcoef in enumerate(delta, start=1):
        lat += dcoef * math.sin(2 * j * chi)
    return lat


def tmerc_to_latlong(
    easting: float, northing: float, a: float, f: float,
    k0: float = 1.0, lon0: float = 0.0, lat0: float = 0.0,
    x0: float = 0.0, y0: float = 0.0,
) -> tuple[float, float]:
    """General inverse transverse Mercator (Krüger 4th-order series).

    Angles in RADIANS (matching proj4's radian output the reference formats,
    mod.rs:619-620,1060).
    """
    n = _third_flattening(f)
    big_a = _rectifying_radius(a, n)
    m0 = _meridian_arc(lat0, n, big_a) if lat0 else 0.0

    # forward is northing = y0 + k0*(M(lat) - M(lat0)), so the recovered arc
    # is M = (northing - y0)/k0 + M0 — M0 must NOT be divided by k0
    x = (easting - x0) / (k0 * big_a)
    y = ((northing - y0) / k0 + m0) / big_a

    beta = [
        n / 2.0 - 2.0 * n**2 / 3.0 + 37.0 * n**3 / 96.0 - n**4 / 360.0,
        n**2 / 48.0 + n**3 / 15.0 - 437.0 * n**4 / 1440.0,
        17.0 * n**3 / 480.0 - 37.0 * n**4 / 840.0,
        4397.0 * n**4 / 161280.0,
    ]
    xi = y
    eta = x
    for j, b in enumerate(beta, start=1):
        xi -= b * math.sin(2 * j * y) * math.cosh(2 * j * x)
        eta -= b * math.cos(2 * j * y) * math.sinh(2 * j * x)

    chi = math.asin(math.sin(xi) / math.cosh(eta))
    lat = _conformal_to_geodetic(chi, n)
    lon = lon0 + math.atan2(math.sinh(eta), math.cos(xi))
    return lon, lat


def utm_to_latlong(easting: float, northing: float, zone: int,
                   south: bool = False, ellps: str = "GRS80") -> tuple[float, float]:
    """Inverse UTM -> (longitude, latitude) in radians."""
    a, f = _ELLIPSOIDS[ellps]
    return tmerc_to_latlong(
        easting, northing, a, f,
        k0=UTM_SCALE,
        lon0=math.radians(zone * 6.0 - 183.0),
        x0=UTM_FALSE_EASTING,
        y0=UTM_FALSE_NORTHING_SOUTH if south else 0.0,
    )


def merc_to_latlong(easting: float, northing: float, a: float, f: float,
                    k0: float = 1.0, lon0: float = 0.0,
                    x0: float = 0.0, y0: float = 0.0) -> tuple[float, float]:
    """Inverse ellipsoidal Mercator: isometric -> conformal -> geodetic."""
    n = _third_flattening(f)
    lon = lon0 + (easting - x0) / (a * k0)
    psi = (northing - y0) / (a * k0)
    chi = 2.0 * math.atan(math.exp(psi)) - math.pi / 2.0
    return lon, _conformal_to_geodetic(chi, n)


# ---------------------------------------------------------------------------
# Conic / azimuthal / double-projection building blocks (Snyder, "Map
# Projections — A Working Manual", USGS PP 1395; EPSG guidance note 7-2).
# All latitudes/longitudes in radians.

def _eccentricity(f: float) -> float:
    return math.sqrt(f * (2.0 - f))


def _conformal_t(lat: float, e: float) -> float:
    """Snyder 15-9: t = tan(pi/4 - lat/2) / ((1-e sin)/(1+e sin))^(e/2)."""
    s = e * math.sin(lat)
    return math.tan(math.pi / 4.0 - lat / 2.0) / ((1.0 - s) / (1.0 + s)) ** (e / 2.0)


def _m_parallel(lat: float, e: float) -> float:
    """Snyder 14-15: radius of the parallel / a = cos(lat)/sqrt(1-e²sin²)."""
    s = math.sin(lat)
    return math.cos(lat) / math.sqrt(1.0 - (e * s) ** 2)


def _phi_from_t(t: float, f: float) -> float:
    """Geodetic latitude from the conformal t, via the existing n-series."""
    chi = math.pi / 2.0 - 2.0 * math.atan(t)
    return _conformal_to_geodetic(chi, _third_flattening(f))


def _isometric_lat(lat: float, e: float) -> float:
    """psi = atanh(sin lat) - e atanh(e sin lat)."""
    s = math.sin(lat)
    return math.atanh(s) - e * math.atanh(e * s)


def _q_authalic(lat: float, e: float) -> float:
    """Snyder 3-12 authalic q; smooth sphere limit."""
    s = math.sin(lat)
    if e < 1e-12:
        return 2.0 * s
    es = e * s
    return (1.0 - e * e) * (
        s / (1.0 - es * es) - math.log((1.0 - es) / (1.0 + es)) / (2.0 * e)
    )


def _phi_from_authalic(beta: float, e: float) -> float:
    """Geodetic latitude from authalic latitude: Snyder 3-18 series start
    plus one Newton step on q(phi) (the series alone truncates at ~1e-10)."""
    e2 = e * e
    e4 = e2 * e2
    e6 = e4 * e2
    phi = (
        beta
        + (e2 / 3.0 + 31.0 * e4 / 180.0 + 517.0 * e6 / 5040.0) * math.sin(2.0 * beta)
        + (23.0 * e4 / 360.0 + 251.0 * e6 / 3780.0) * math.sin(4.0 * beta)
        + (761.0 * e6 / 45360.0) * math.sin(6.0 * beta)
    )
    if e < 1e-12 or abs(phi) > math.pi / 2.0 - 1e-9:
        return phi
    # Newton on q(phi) = q_p sin(beta);  dq/dphi = 2(1-e²)cos/(1-e²sin²)²
    qp = _q_authalic(math.pi / 2.0, e)
    q_want = qp * math.sin(beta)
    s = math.sin(phi)
    dq = 2.0 * (1.0 - e2) * math.cos(phi) / (1.0 - e2 * s * s) ** 2
    if dq > 1e-12:
        phi += (q_want - _q_authalic(phi, e)) / dq
    return phi


def _clamp1(v: float) -> float:
    return max(-1.0, min(1.0, v))


_POLAR_EPS = 1e-10


def lcc_to_latlong(easting: float, northing: float, a: float, f: float,
                   lat1: float, lat2: float, lat0: float, lon0: float,
                   k0: float = 1.0, x0: float = 0.0, y0: float = 0.0,
                   ) -> tuple[float, float]:
    """Inverse Lambert conformal conic (Snyder 15-1..11 inverted).

    ``lat1 == lat2`` (or lat2 omitted by the caller passing lat1) gives the
    1SP form where +k_0 applies; the 2SP form derives the cone constant from
    the two standard parallels.
    """
    e = _eccentricity(f)
    m1 = _m_parallel(lat1, e)
    t1 = _conformal_t(lat1, e)
    if abs(lat1 - lat2) < 1e-12:
        n = math.sin(lat1)
    else:
        m2 = _m_parallel(lat2, e)
        t2 = _conformal_t(lat2, e)
        n = (math.log(m1) - math.log(m2)) / (math.log(t1) - math.log(t2))
    if abs(n) < 1e-12:
        raise ProjError("lcc needs a non-equatorial +lat_1")
    big_f = m1 / (n * t1 ** n)
    rho0 = a * k0 * big_f * _conformal_t(lat0, e) ** n
    dx = easting - x0
    dy = rho0 - (northing - y0)
    rho = math.copysign(math.hypot(dx, dy), n)
    if abs(rho) < _POLAR_EPS:
        return lon0, math.copysign(math.pi / 2.0, n)
    if n < 0.0:
        dx, dy = -dx, -dy
    theta = math.atan2(dx, dy)
    t = (rho / (a * k0 * big_f)) ** (1.0 / n)
    return lon0 + theta / n, _phi_from_t(t, f)


def aea_to_latlong(easting: float, northing: float, a: float, f: float,
                   lat1: float, lat2: float, lat0: float, lon0: float,
                   x0: float = 0.0, y0: float = 0.0) -> tuple[float, float]:
    """Inverse Albers equal-area conic (Snyder 14-1..11 inverted)."""
    e = _eccentricity(f)
    m1 = _m_parallel(lat1, e)
    q1 = _q_authalic(lat1, e)
    if abs(lat1 - lat2) < 1e-12:
        n = math.sin(lat1)
    else:
        m2 = _m_parallel(lat2, e)
        q2 = _q_authalic(lat2, e)
        n = (m1 * m1 - m2 * m2) / (q2 - q1)
    if abs(n) < 1e-12:
        raise ProjError("aea needs a non-equatorial +lat_1")
    big_c = m1 * m1 + n * q1
    rho0 = a * math.sqrt(big_c - n * _q_authalic(lat0, e)) / n
    dx = easting - x0
    dy = rho0 - (northing - y0)
    if n < 0.0:
        dx, dy = -dx, -dy
    rho = math.hypot(dx, dy)
    theta = math.atan2(dx, dy)
    q = (big_c - (rho * n / a) ** 2) / n
    qp = _q_authalic(math.pi / 2.0, e)
    beta = math.asin(_clamp1(q / qp))
    return lon0 + theta / n, _phi_from_authalic(beta, e)


def laea_to_latlong(easting: float, northing: float, a: float, f: float,
                    lat0: float, lon0: float,
                    x0: float = 0.0, y0: float = 0.0) -> tuple[float, float]:
    """Inverse Lambert azimuthal equal-area (Snyder 24-26..31 + polar)."""
    e = _eccentricity(f)
    qp = _q_authalic(math.pi / 2.0, e)
    dx = easting - x0
    dy = northing - y0
    if abs(abs(lat0) - math.pi / 2.0) < 1e-9:  # polar aspects
        south = lat0 < 0.0
        rho = math.hypot(dx, dy)
        q = qp - (rho / a) ** 2
        beta = math.asin(_clamp1(q / qp))
        lat = _phi_from_authalic(beta, e)
        if south:
            return lon0 + math.atan2(dx, dy), -lat
        return lon0 + math.atan2(dx, -dy), lat
    rq = a * math.sqrt(qp / 2.0)
    beta1 = math.asin(_clamp1(_q_authalic(lat0, e) / qp))
    m1 = _m_parallel(lat0, e)
    d = a * m1 / (rq * math.cos(beta1))
    rho = math.hypot(dx / d, d * dy)
    if rho < _POLAR_EPS:
        return lon0, lat0
    ce = 2.0 * math.asin(_clamp1(rho / (2.0 * rq)))
    q = qp * (math.cos(ce) * math.sin(beta1)
              + d * dy * math.sin(ce) * math.cos(beta1) / rho)
    beta = math.asin(_clamp1(q / qp))
    lon = lon0 + math.atan2(
        dx * math.sin(ce),
        d * rho * math.cos(beta1) * math.cos(ce)
        - d * d * dy * math.sin(beta1) * math.sin(ce),
    )
    return lon, _phi_from_authalic(beta, e)


def stere_to_latlong(easting: float, northing: float, a: float, f: float,
                     lat0: float, lon0: float, k0: float = 1.0,
                     lat_ts: float | None = None,
                     x0: float = 0.0, y0: float = 0.0) -> tuple[float, float]:
    """Inverse stereographic.

    Polar aspect (|lat_0| = 90°) is the exact ellipsoidal form (Snyder
    21-39/40 + 15-11), scaled by +lat_ts when given, else +k_0 at the pole.
    Oblique/equatorial is Snyder's conformal-latitude form (21-27..38).
    """
    e = _eccentricity(f)
    dx = easting - x0
    dy = northing - y0
    rho = math.hypot(dx, dy)
    if abs(abs(lat0) - math.pi / 2.0) < 1e-9:  # polar
        south = lat0 < 0.0
        if south:
            dx, dy = dx, -dy  # mirror: reuse the north formulas
        if lat_ts is not None and abs(lat_ts) < math.pi / 2.0 - 1e-9:
            tsa = abs(lat_ts)
            t = rho * _conformal_t(tsa, e) / (a * _m_parallel(tsa, e))
        else:
            t = rho * math.sqrt((1.0 + e) ** (1.0 + e)
                                * (1.0 - e) ** (1.0 - e)) / (2.0 * a * k0)
        lat = _phi_from_t(t, f) if rho > _POLAR_EPS else math.pi / 2.0
        lon_rel = math.atan2(dx, -dy) if rho > _POLAR_EPS else 0.0
        return lon0 + lon_rel, -lat if south else lat
    chi1 = math.pi / 2.0 - 2.0 * math.atan(_conformal_t(lat0, e))
    m1 = _m_parallel(lat0, e)
    if rho < _POLAR_EPS:
        return lon0, lat0
    ce = 2.0 * math.atan2(rho * math.cos(chi1), 2.0 * a * k0 * m1)
    chi = math.asin(_clamp1(math.cos(ce) * math.sin(chi1)
                            + dy * math.sin(ce) * math.cos(chi1) / rho))
    lon = lon0 + math.atan2(
        dx * math.sin(ce),
        rho * math.cos(chi1) * math.cos(ce) - dy * math.sin(chi1) * math.sin(ce),
    )
    return lon, _conformal_to_geodetic(chi, _third_flattening(f))


def _gauss_sphere(lat0: float, e: float) -> tuple[float, float, float]:
    """Gauss conformal-sphere constants (EPSG 9809/9815 shared core).

    Returns (c_gauss, chi0, log_w_scale) where the sphere latitude chi of a
    geodetic lat satisfies  (1+sin chi)/(1-sin chi) = K * exp(2 c psi(lat)),
    anchored so that sin(chi0) = sin(lat0)/c_gauss at the origin.
    log_w_scale is ln(K).
    """
    s0 = math.sin(lat0)
    c0 = math.cos(lat0)
    e2 = e * e
    c_gauss = math.sqrt(1.0 + e2 * c0 ** 4 / (1.0 - e2))
    chi0 = math.asin(_clamp1(s0 / c_gauss))
    w0 = (1.0 + math.sin(chi0)) / (1.0 - math.sin(chi0))
    log_k = math.log(w0) - 2.0 * c_gauss * _isometric_lat(lat0, e)
    return c_gauss, chi0, log_k


def _gauss_sphere_radius(lat0: float, a: float, e: float) -> float:
    """R = sqrt(rho nu) at lat0: a sqrt(1-e²)/(1 - e² sin²lat0)."""
    s0 = math.sin(lat0)
    return a * math.sqrt(1.0 - e * e) / (1.0 - (e * s0) ** 2)


def _gauss_chi_to_phi(chi: float, c_gauss: float, log_k: float,
                      f: float) -> float:
    """Invert the Gauss sphere mapping: sphere latitude -> geodetic."""
    w = (1.0 + math.sin(chi)) / (1.0 - math.sin(chi))
    psi = (math.log(w) - log_k) / (2.0 * c_gauss)
    chi_std = 2.0 * math.atan(math.exp(psi)) - math.pi / 2.0
    return _conformal_to_geodetic(chi_std, _third_flattening(f))


def sterea_to_latlong(easting: float, northing: float, a: float, f: float,
                      lat0: float, lon0: float, k0: float = 1.0,
                      x0: float = 0.0, y0: float = 0.0) -> tuple[float, float]:
    """Inverse oblique stereographic via the Gauss conformal sphere
    (EPSG 9809 double projection — the Dutch RD New method)."""
    e = _eccentricity(f)
    c_gauss, chi0, log_k = _gauss_sphere(lat0, e)
    r = _gauss_sphere_radius(lat0, a, e)
    dx = easting - x0
    dy = northing - y0
    rho = math.hypot(dx, dy)
    if rho < _POLAR_EPS:
        return lon0, lat0
    ce = 2.0 * math.atan2(rho, 2.0 * r * k0)
    chi = math.asin(_clamp1(math.cos(ce) * math.sin(chi0)
                            + dy * math.sin(ce) * math.cos(chi0) / rho))
    dlam_sphere = math.atan2(
        dx * math.sin(ce),
        rho * math.cos(chi0) * math.cos(ce) - dy * math.sin(chi0) * math.sin(ce),
    )
    lon = lon0 + dlam_sphere / c_gauss
    return lon, _gauss_chi_to_phi(chi, c_gauss, log_k, f)


def somerc_to_latlong(easting: float, northing: float, a: float, f: float,
                      lat0: float, lon0: float, k0: float = 1.0,
                      x0: float = 0.0, y0: float = 0.0) -> tuple[float, float]:
    """Inverse Swiss oblique Mercator (EPSG 9815, CH1903/LV03 + LV95).

    Gauss conformal sphere at lat0, rotated so the origin's sphere latitude
    b0 moves to the pseudo-equator, then a plain sphere Mercator."""
    e = _eccentricity(f)
    c_gauss, b0, log_k = _gauss_sphere(lat0, e)
    r = _gauss_sphere_radius(lat0, a, e) * k0
    bbar = math.asin(_clamp1(math.tanh((northing - y0) / r)))
    lbar = (easting - x0) / r
    sb0, cb0 = math.sin(b0), math.cos(b0)
    b = math.asin(_clamp1(cb0 * math.sin(bbar)
                          + sb0 * math.cos(bbar) * math.cos(lbar)))
    ell = math.atan2(math.cos(bbar) * math.sin(lbar),
                     cb0 * math.cos(bbar) * math.cos(lbar)
                     - sb0 * math.sin(bbar))
    lon = lon0 + ell / c_gauss
    return lon, _gauss_chi_to_phi(b, c_gauss, log_k, f)


def eqc_to_latlong(easting: float, northing: float, a: float,
                   lat_ts: float = 0.0, lat0: float = 0.0, lon0: float = 0.0,
                   x0: float = 0.0, y0: float = 0.0) -> tuple[float, float]:
    """Inverse equidistant cylindrical (plate carrée; spherical, as in proj)."""
    lat = (northing - y0) / a + lat0
    lon = lon0 + (easting - x0) / (a * math.cos(lat_ts))
    return lon, lat


def transform_to_latlong(proj_string: str, x: float, y: float) -> tuple[float, float]:
    """World (easting, northing) -> (long, lat) radians via a proj string.

    Degenerate-but-parseable strings (out-of-range latitudes, polar lcc/
    sterea/somerc origins, non-numeric values) raise :class:`ProjError` like
    unknown ones do — callers rely on that single taxonomy (pipeline.
    segment_coords returns None on it, matching the reference's silent
    no-coordinates behavior for bad proj text, mod.rs:470-488)."""
    try:
        return _transform_to_latlong(proj_string, x, y)
    except ProjError:
        raise
    except (ValueError, ZeroDivisionError, OverflowError) as exc:
        raise ProjError(f"proj string did not evaluate: {exc}") from exc


def _transform_to_latlong(proj_string: str, x: float, y: float) -> tuple[float, float]:
    p = parse_proj(proj_string)
    proj = str(p["proj"])
    if proj in ("longlat", "latlong", "lonlat"):
        return math.radians(x), math.radians(y)

    a, f = _ellipsoid(p)
    k0 = float(p.get("k", p.get("k_0", 1.0)))
    x0 = float(p.get("x_0", 0.0))
    y0 = float(p.get("y_0", 0.0))
    lon0 = math.radians(float(p.get("lon_0", 0.0)))
    lat0 = math.radians(float(p.get("lat_0", 0.0)))
    if proj == "utm":
        zone = int(p.get("zone", 0))
        if not 1 <= zone <= 60:
            raise ProjError(f"utm zone {zone} out of range")
        # honor explicit +a/+b/+rf/+f like the other projections: (a, f)
        # above already resolved them (falling back to +ellps)
        return tmerc_to_latlong(
            x, y, a, f,
            k0=UTM_SCALE,
            lon0=math.radians(zone * 6.0 - 183.0),
            x0=UTM_FALSE_EASTING,
            y0=UTM_FALSE_NORTHING_SOUTH if p.get("south", False) else 0.0,
        )
    if proj == "tmerc":
        return tmerc_to_latlong(x, y, a, f, k0=k0, lon0=lon0, lat0=lat0,
                                x0=x0, y0=y0)
    if proj == "merc":
        if "lat_ts" in p:  # scale along the standard parallel (proj semantics)
            ts = math.radians(float(p["lat_ts"]))
            k0 = _m_parallel(ts, _eccentricity(f))
        return merc_to_latlong(x, y, a, f, k0=k0, lon0=lon0, x0=x0, y0=y0)
    if proj == "webmerc":
        # proj pins webmerc at k = 1 regardless of +k/+k_0
        return merc_to_latlong(x, y, a, 0.0, k0=1.0, lon0=lon0, x0=x0, y0=y0)
    if proj in ("lcc", "aea"):
        if "lat_1" not in p:
            raise ProjError(f"{proj} needs +lat_1")
        lat1 = math.radians(float(p["lat_1"]))
        lat2 = math.radians(float(p["lat_2"])) if "lat_2" in p else lat1
        if proj == "lcc":
            return lcc_to_latlong(x, y, a, f, lat1, lat2, lat0, lon0,
                                  k0=k0, x0=x0, y0=y0)
        return aea_to_latlong(x, y, a, f, lat1, lat2, lat0, lon0,
                              x0=x0, y0=y0)
    if proj == "laea":
        return laea_to_latlong(x, y, a, f, lat0, lon0, x0=x0, y0=y0)
    if proj in ("stere", "ups"):
        if proj == "ups":  # fixed UPS parameterization (proj ups semantics)
            lat0 = math.radians(-90.0 if p.get("south", False) else 90.0)
            k0, x0, y0 = 0.994, 2_000_000.0, 2_000_000.0
        lat_ts = (math.radians(float(p["lat_ts"]))
                  if "lat_ts" in p else None)
        return stere_to_latlong(x, y, a, f, lat0, lon0, k0=k0,
                                lat_ts=lat_ts, x0=x0, y0=y0)
    if proj == "sterea":
        return sterea_to_latlong(x, y, a, f, lat0, lon0, k0=k0, x0=x0, y0=y0)
    if proj == "somerc":
        return somerc_to_latlong(x, y, a, f, lat0, lon0, k0=k0, x0=x0, y0=y0)
    if proj == "eqc":
        ts = math.radians(float(p.get("lat_ts", 0.0)))
        return eqc_to_latlong(x, y, a, lat_ts=ts, lat0=lat0, lon0=lon0,
                              x0=x0, y0=y0)
    raise ProjError(f"unsupported projection {proj!r}")


def segment_coords(world_offset, lo, hi, proj_string: str) -> tuple[float, float]:
    """Lat/long of a segment's center, reproducing update_location
    (mod.rs:235-243): easting = offset.x + mid(x), northing = -(offset.z +
    mid(z)) — undoing the y-up swizzle's z = -northing."""
    easting = float(world_offset[0]) + (float(lo[0]) + float(hi[0])) / 2.0
    northing = -(float(world_offset[2]) + (float(lo[2]) + float(hi[2])) / 2.0)
    return transform_to_latlong(proj_string, easting, northing)


def format_degrees(val_radians: float) -> str:
    """D°M'S.s" formatting (mod.rs:1060-1066 semantics).

    The sign rides an explicit prefix so values in (-1°, 0°) — where the
    truncated degree part is 0 — keep their hemisphere."""
    deg = math.degrees(val_radians)
    mag = abs(deg)
    d = math.trunc(mag)
    minutes = (mag - d) * 60.0
    m = math.trunc(minutes)
    s = (minutes - m) * 60.0
    sign = "-" if deg < 0 else ""
    return f"{sign}{int(d):02d}°{int(m):02d}'{s:04.1f}\""
