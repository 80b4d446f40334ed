"""Exports: .ply points / hull meshes, .json segment info & traits, .txt landmarks.

Byte-compatible in spirit with the reference savers:
- point .ply with expansion/height/curve properties and the y-up -> LAS-axis
  unswizzle (x, -z, y) (treee/src/interactive/mod.rs:1069-1107)
- convex hull .ply with reindexed used vertices and flipped winding
  (treee/src/interactive/hull.rs:583-624)
- segment info .json (SegmentSave, calculations.rs:62-73)
- RBV distances .json + landmark .txt tab-separated rows (hull.rs:293-331)
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np


def save_points_ply(
    fh,
    pos: np.ndarray,
    expansion: np.ndarray,
    height: np.ndarray,
    curve: np.ndarray,
    keep: np.ndarray | None = None,
) -> None:
    """ASCII .ply of points + properties (mod.rs:1069-1107 layout)."""
    if keep is None:
        keep = np.ones(len(pos), bool)
    idx = np.flatnonzero(keep)
    w = fh.write
    w("ply\n")
    w("format ascii 1.0\n")
    w(f"element vertex {len(idx)}\n")
    for prop in ("x", "y", "z", "expansion", "height", "curve"):
        w(f"property float {prop}\n")
    w("end_header\n")
    # vectorized row formatting: a per-row Python f-string loop costs tens of
    # minutes for a full 15M-point cloud on this 1-CPU host
    cols = np.column_stack([
        pos[idx, 0], -pos[idx, 2], pos[idx, 1],
        np.asarray(expansion)[idx], np.asarray(height)[idx],
        np.asarray(curve)[idx],
    ]).astype(np.float32)
    np.savetxt(fh, cols, fmt="%.8g", delimiter=" ")


def save_hull_ply(fh, pos: np.ndarray, faces: np.ndarray) -> None:
    """ASCII .ply of a triangle hull; vertices reindexed to those used, winding
    flipped to match the unswizzle (hull.rs:583-624)."""
    used: dict[int, int] = {}
    order: list[int] = []
    for face in faces:
        for v in face:
            v = int(v)
            if v not in used:
                used[v] = len(order)
                order.append(v)
    w = fh.write
    w("ply\n")
    w("format ascii 1.0\n")
    w(f"element vertex {len(order)}\n")
    w("property float x\nproperty float y\nproperty float z\n")
    w(f"element face {len(faces)}\n")
    w("property list uchar uint vertex_indices\n")
    w("end_header\n")
    for v in order:
        p = pos[v]
        w(f"{p[0]} {-p[2]} {p[1]}\n")
    for face in faces:
        w(f"3 {used[int(face[0])]} {used[int(face[2])]} {used[int(face[1])]}\n")


def segment_info_json(
    info: dict,
    lo: np.ndarray,
    hi: np.ndarray,
    world_offset: np.ndarray,
    coords: tuple[float, float] | None = None,
) -> str:
    """SegmentSave-shaped JSON (calculations.rs:62-73; flattened info)."""
    out = {
        "trunk_height": float(info["trunk_height"]),
        "crown_height": float(info["crown_height"]),
        "ground_sep": float(info["ground_sep"]),
        "crown_sep": float(info["crown_sep"]),
        "min": [float(v) for v in lo],
        "max": [float(v) for v in hi],
        "offset": [float(v) for v in world_offset],
    }
    if coords is not None:
        out["longitude"] = float(np.degrees(coords[0]))
        out["latitude"] = float(np.degrees(coords[1]))
    return json.dumps(out, indent=2)


def landmarks_txt(values: np.ndarray) -> str:
    """Tab-separated landmark row with trailing newline (hull.rs:317-331)."""
    return "\t".join(repr(float(v)) for v in values) + "\n"


def rbv_distances_json(
    center: np.ndarray, height_min: float, distances: np.ndarray,
    slices: int, sectors: int,
) -> str:
    """RadialBoundingVolumeDistances JSON (hull.rs:293-306,908-916)."""
    return json.dumps(
        {
            "center_x": float(center[0]),
            "center_y": float(center[1]),
            "height_min": float(height_min),
            "slices": slices,
            "sectors": sectors,
            "distances": [float(d) for d in distances],
        },
        indent=2,
    )


def save_inventory_csv(fh, inv: dict) -> int:
    """Whole-forest inventory table (Session.inventory columns) as CSV.

    One row per tree; column order follows the dict (segment id first).
    CSV is the lingua franca of forestry inventory tools — the reference
    has no forest-level product at all (traits are one focused tree's JSON,
    hull.rs:293-306).  Returns the row count."""
    cols = list(inv)
    n = len(inv[cols[0]]) if cols else 0
    # map coordinates need fixed-point: %.6g would quantize UTM-scale
    # northings (~5.4e6 m) to 10 m and eastings to 1 m
    fixed = {"x", "z", "easting", "northing", "stem_easting",
             "stem_northing"}
    fh.write(",".join(cols) + "\n")
    for i in range(n):
        row = []
        for c in cols:
            v = inv[c][i]
            if isinstance(v, (bool, np.bool_)):
                row.append("1" if v else "0")
            elif isinstance(v, (int, np.integer)):
                row.append(str(int(v)))
            elif c in fixed:
                row.append(f"{float(v):.3f}")
            else:
                row.append(f"{float(v):.6g}")
        fh.write(",".join(row) + "\n")
    return n


def save_ascii_grid(fh, grid: np.ndarray, xll: float, yll: float,
                    cell: float, nodata: float = -9999.0) -> None:
    """ESRI ASCII grid (.asc) writer for the DTM/DSM/CHM rasters.

    ``grid`` rows are ascending world-z; world z = -(LAS northing) after the
    load swizzle (io/las.py:9-10), so row 0 is already the northernmost row
    the .asc layout wants — no flip.  ``xll``/``yll`` are the lower-left
    corner in LAS map coordinates (easting/northing).
    """
    h, w = grid.shape
    fh.write(f"ncols {w}\n")
    fh.write(f"nrows {h}\n")
    fh.write(f"xllcorner {xll:.6f}\n")
    fh.write(f"yllcorner {yll:.6f}\n")
    fh.write(f"cellsize {cell:.6f}\n")
    fh.write(f"NODATA_value {nodata:g}\n")
    np.savetxt(fh, grid, fmt="%.4f", delimiter=" ")


def png_encode(img: np.ndarray) -> bytes:
    """Minimal RGB8 PNG writer (stdlib zlib; no imaging dependency).

    The viewer page polls frames, so encode speed matters more than ratio:
    filter type 0 on every row + one zlib deflate (level 6).  The CLI's
    ``--frames`` and the REPL's ``render`` write their PNGs through it too.
    """
    h, w, c = img.shape
    assert c == 3 and img.dtype == np.uint8

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    raw = np.empty((h, 1 + w * 3), np.uint8)
    raw[:, 0] = 0  # per-row filter byte: None
    raw[:, 1:] = img.reshape(h, w * 3)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b"")
    )
