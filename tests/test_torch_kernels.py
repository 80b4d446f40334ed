"""The port's kernel wrappers on the CPU: their plain PyTorch versions against
the JAX package's Pallas kernels in interpret mode, bit for bit, and the
dispatch rules (plain path only for CPU tensors, no launches counted)."""

import ctypes
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from treee_tpu import characteristics as jch
from treee_tpu import rasters as jrs
from treee_tpu import segmentation as jsg
from treee_tpu.ops import pallas_kernels as pk
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.config import RenderConfig
from treee_tpu_torch.ops.kernels import build
from treee_tpu_torch.ops.f32 import full
from treee_tpu_torch.ops.kernels.dilate import DIRECTIONS, radius_from_key
from treee_tpu_torch.ops.kernels.eye_dome import (
    _constants as eye_dome_constants)
from treee_tpu_torch import rasters as trs
from treee_tpu_torch.ops.kernels.jump_flood import (
    CLUSTER_CTAS, INF, TILE_AXIS, TILE_CELLS, TILE_HALO, TILE_MAX_STEPS,
    cell_positions, tile_axis)
from treee_tpu_torch.ops.kernels.nearest_slot import INF as NEAREST_INF
from treee_tpu_torch.ops.kernels.nearest_slot import cell_centers
from treee_tpu_torch.render import Camera
from treee_tpu_torch.render import splat as tsplat

import torch_threads
import voronoi_cases

torch_threads.share_cores()

IBIG = 0x7FFFFFFF


def _blob_grid(b, g, n_blobs, seed):
    """Occupancy grids with connected blobs (random walks from seed cells),
    some touching the grid's edges."""
    rng = np.random.default_rng(seed)
    occ = np.zeros((b, g, g), bool)
    for bi in range(b):
        for _ in range(n_blobs):
            y, x = rng.integers(0, g, 2)
            for _ in range(60):
                occ[bi, y, x] = True
                dy, dx = rng.integers(-1, 2, 2)
                y, x = int(np.clip(y + dy, 0, g - 1)), int(np.clip(x + dx, 0, g - 1))
    return occ


def _labels(occ):
    b, g, _ = occ.shape
    idx = np.arange(g * g, dtype=np.int32).reshape(1, g, g)
    return np.where(occ, idx, IBIG).astype(np.int32)


@pytest.mark.parametrize("g,sweeps", [(64, 1), (64, 5), (64, 8), (48, 13),
                                      (40, 24), (7, 3), (9, 16)])
def test_cc_sweep_plain_matches_pallas(g, sweeps):
    lbl = _labels(_blob_grid(3, g, 6, seed=g + sweeps))
    ref = np.asarray(pk.cc_sweep_pallas(jnp.asarray(lbl), sweeps,
                                        interpret=True))
    got = kernels.cc_sweep(torch.from_numpy(lbl), sweeps)
    np.testing.assert_array_equal(got.numpy(), ref)


def _converging_bands(g):
    """Four bands that reach the sweeps' fixpoint at different counts:
    isolated 2x2 squares (one sweep), one long zigzag corridor whose minimum
    must travel its length, an empty band and a full one (the minimum
    crosses the diagonal)."""
    occ = np.zeros((4, g, g), bool)
    occ[0, 1::4, 1::4] = occ[0, 2::4, 1::4] = True
    occ[0, 1::4, 2::4] = occ[0, 2::4, 2::4] = True
    occ[1, ::4, :] = True            # every 4th row, joined at alternate ends
    for k, row in enumerate(range(0, g - 4, 4)):
        occ[1, row:row + 5, 0 if k % 2 == 0 else g - 1] = True
    occ[3] = True
    lbl = _labels(occ)
    # labels counting down, so the minimum starts at the corridor's far end
    lbl[1] = np.where(occ[1], g * g - 1 - lbl[1], IBIG)
    return lbl


@pytest.mark.parametrize("g", [12, 16, 24])
def test_cc_sweep_fixpoint_is_final(g):
    """The premise of the kernel's early exit: once one more sweep leaves a
    band unchanged, every further sweep does too, so stopping there gives
    the output of any larger sweep count.  The bands converge at different
    counts."""
    lbl = torch.from_numpy(_converging_bands(g))
    n = g * g // 2 + g                 # beyond the corridor's length
    states = [lbl]
    for _ in range(n):
        states.append(kernels.cc_sweep_plain(states[-1], 1))
    fix = []
    for b in range(lbl.shape[0]):
        k = next(k for k in range(n) if torch.equal(states[k][b],
                                                    states[k + 1][b]))
        assert all(torch.equal(states[k][b], states[m][b])
                   for m in range(k, n + 1))
        fix.append(k)
    assert fix[0] == 1 and fix[2] == 0, fix     # squares; empty
    assert g - 1 <= fix[3] < fix[1], fix        # full; corridor
    # one call of m sweeps is m single sweeps, before and after the fixpoints
    for m in sorted({1, fix[0] + 1, fix[3] + 1, n}):
        assert torch.equal(kernels.cc_sweep_plain(lbl, m), states[m])
    assert torch.equal(states[n] == IBIG, lbl == IBIG)


def _match_inputs(case, rng):
    if case == "recurring":
        # test_pallas.py's mix: clusters that recur across bands and new ones
        b, c_cap, t_cap, radius = 6, 32, 64, 1.5
        cents = rng.uniform(0, 50, (b, c_cap, 2)).astype(np.float32)
        cmask = rng.random((b, c_cap)) < 0.4
        cents[1:] = np.where(rng.random((b - 1, c_cap, 1)) < 0.5,
                             cents[:1] + rng.normal(0, 0.3, (b - 1, c_cap, 2)),
                             cents[1:]).astype(np.float32)
    else:
        # integer positions in a small box: many exactly equal distances in
        # rows and columns (first-index ties), and more new clusters than
        # free slots
        b, c_cap, t_cap, radius = 5, 16, 8, 2.0
        cents = rng.integers(0, 5, (b, c_cap, 2)).astype(np.float32)
        cmask = rng.random((b, c_cap)) < 0.7
    return cents, cmask, t_cap, radius


@pytest.mark.parametrize("case", ["recurring", "ties"])
def test_match_scan_plain_matches_pallas(case):
    rng = np.random.default_rng(13)
    cents, cmask, t_cap, radius = _match_inputs(case, rng)
    rounds = 4
    tp, act, nal = pk.match_scan_pallas(
        jnp.asarray(cents), jnp.asarray(cmask), jnp.float32(radius), rounds,
        t_cap, interpret=True)
    gp, ga, gn = kernels.match_scan(torch.from_numpy(cents),
                                    torch.from_numpy(cmask), radius, rounds,
                                    t_cap)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(act))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(tp))
    assert int(gn) == int(nal)
    if case == "ties":
        assert int(gn) == t_cap and ga.numpy()[-1].all()  # slots ran out


U64_NONE = np.uint64(0xFFFFFFFFFFFFFFFF)


def _match_scan_partitioned(cents, cmask, radius, rounds, t_cap, n_cta):
    """numpy model of the cluster kernel's partition of the band matching:
    the active slots (compacted in index order) split by count over n_cta
    CTAs; per CTA, packed (value bits << 32 | index) keys for each slot's
    nearest untaken cluster and a partial nearest slot per cluster; the
    partials reduced over the CTAs, the winning slot's row key read from its
    owner CTA; the active list rebuilt from the allocation's free-slot
    ranks."""
    b, c_cap, _ = cents.shape
    px = np.zeros(t_cap, np.float32)
    pz = np.zeros(t_cap, np.float32)
    act = np.zeros(t_cap, bool)
    alist = np.zeros(0, np.int64)
    out_pos = np.empty((b, t_cap, 2), np.float32)
    out_act = np.empty((b, t_cap), bool)
    n_alloc = 0
    r = np.float32(radius)
    for band in range(b):
        cx, cz = cents[band, :, 0], cents[band, :, 1]
        taken = ~cmask[band]
        ulist = np.flatnonzero(~taken)
        for _ in range(rounds):
            n_act, n_un = len(alist), len(ulist)
            if n_act == 0 or n_un == 0:
                break
            chunk = -(-n_act // n_cta)
            row_keys, col_parts = [], []
            for k in range(n_cta):
                ii = np.arange(min(k * chunk, n_act),
                               min(k * chunk + chunk, n_act))
                t = alist[ii]
                dx = px[t][:, None] - cx[ulist][None, :]
                dz = pz[t][:, None] - cz[ulist][None, :]
                d = np.sqrt(dx * dx + dz * dz)
                assert d.dtype == np.float32
                bits = d.view(np.uint32).astype(np.uint64) << np.uint64(32)
                row_keys.append((bits | ulist[None, :].astype(np.uint64))
                                .min(axis=1, initial=U64_NONE))
                col_parts.append((bits | ii[:, None].astype(np.uint64))
                                 .min(axis=0, initial=U64_NONE))
            col = np.minimum.reduce(col_parts)
            moves = []
            for u, c in enumerate(ulist):
                i = int(col[u] & np.uint64(0xFFFFFFFF))
                owner = i // chunk
                rk = row_keys[owner][i - owner * chunk]
                val = np.uint32(rk >> np.uint64(32)).view(np.float32)
                if int(rk & np.uint64(0xFFFFFFFF)) == c and val <= r:
                    moves.append((alist[i], c))
            for t, c in moves:
                px[t], pz[t], taken[c] = cx[c], cz[c], True
            ulist = np.flatnonzero(~taken)
        free = np.flatnonzero(~act)
        n_ok = min(len(ulist), len(free))
        frank = np.cumsum(~act) - ~act        # free slots before each slot
        px[free[:n_ok]], pz[free[:n_ok]] = cx[ulist[:n_ok]], cz[ulist[:n_ok]]
        act[free[:n_ok]] = True
        rank = np.arange(t_cap) - np.maximum(0, frank - n_ok)
        alist = np.zeros(act.sum(), np.int64)
        alist[rank[act]] = np.flatnonzero(act)
        assert np.array_equal(alist, np.flatnonzero(act))
        n_alloc += n_ok
        out_pos[band] = np.stack([px, pz], -1)
        out_act[band] = act
    return out_pos, out_act, n_alloc


@pytest.mark.parametrize("n_cta", [1, 3, 8, 16])
@pytest.mark.parametrize("case", ["recurring", "ties", "crowded"])
def test_match_scan_partition_model_matches_plain(case, n_cta):
    """The cluster kernel's partition and tie logic, rehearsed in numpy:
    splitting the active slots over CTAs and reducing packed keys gives the
    plain version's outputs bit for bit."""
    rng = np.random.default_rng(13)
    if case == "crowded":   # clusters on a coarse lattice, many equal sqrts
        b, c_cap, t_cap, radius = 8, 40, 96, 3.0
        cents = (rng.integers(0, 12, (b, c_cap, 2)) * 0.5).astype(np.float32)
        cmask = rng.random((b, c_cap)) < 0.8
    else:
        cents, cmask, t_cap, radius = _match_inputs(case, rng)
    rounds = 4
    gp, ga, gn = kernels.match_scan_plain(torch.from_numpy(cents),
                                          torch.from_numpy(cmask), radius,
                                          rounds, t_cap)
    mp, ma, mn = _match_scan_partitioned(cents, cmask, radius, rounds, t_cap,
                                         n_cta)
    np.testing.assert_array_equal(ma, ga.numpy())
    np.testing.assert_array_equal(mp.view(np.int32), gp.numpy().view(np.int32))
    assert mn == int(gn)


# the Mosaic gather probe's kernel bodies, as tools/probe_extract.py:109-131
# writes them
def _k_taa0(tab_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=0)


def _k_taa1(tab_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=1)


def _k_take(tab_ref, idx_ref, out_ref):
    out_ref[:] = tab_ref[0, idx_ref[:]]


@pytest.mark.parametrize("body,rows,hi,axis", [
    (_k_taa0, 8, 8, 0), (_k_taa0, 256, 256, 0), (_k_taa1, 8, 128, 1),
    (_k_take, 8, 128, None)])
def test_take_along_axis_plain_matches_pallas(body, rows, hi, axis):
    """At the probe's four shapes, through pl.pallas_call in interpret mode;
    the 1-D form takes row 0 of the table, as ``tab_ref[0, idx]`` does."""
    rng = np.random.default_rng(rows + hi)
    tab = rng.random((rows, 128)).astype(np.float32)
    idx = rng.integers(0, hi, (rows, 128)).astype(np.int32)
    ref = np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(idx.shape, jnp.float32),
        interpret=True)(jnp.asarray(tab), jnp.asarray(idx)))
    t = torch.from_numpy(tab[0] if axis is None else tab)
    got = kernels.take_along_axis(t, torch.from_numpy(idx), axis)
    assert got.dtype == torch.float32 and got.shape == idx.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.view(np.int32))


@pytest.mark.parametrize("n,c,block", [
    (1000, 1, 256),     # 1-D values, runs across blocks, padded tail
    (5000, 12, 512),    # full_bbox support-scan width
    (4096, 8, 1024),    # default support-scan width, exact multiple of block
    (300, 3, 512),      # one partial block
])
def test_segmented_cummax_plain_matches_pallas(n, c, block):
    rng = np.random.default_rng(n + c)
    key = np.sort(rng.integers(0, 37, n)).astype(np.int32)
    val = (rng.normal(size=(n, c)) * 100).astype(np.float32)
    v = val[:, 0] if c == 1 else val
    ref = np.asarray(pk.segmented_cummax_pallas(
        jnp.asarray(key), jnp.asarray(v), block=block, interpret=True))
    np.testing.assert_array_equal(
        np.asarray(jch._segmented_cummax(jnp.asarray(key), jnp.asarray(v))), ref)
    got = kernels.segmented_cummax(torch.from_numpy(key), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["one_run", "all_distinct", "runs_are_blocks",
                                  "large_keys"])
def test_segmented_cummax_plain_run_edges(kind):
    rng = np.random.default_rng(4)
    n, block = 1024, 256
    key = {
        "one_run": np.zeros(n, np.int32),
        "all_distinct": np.arange(n, dtype=np.int32),
        "runs_are_blocks": np.repeat(np.arange(4, dtype=np.int32), block),
        # keys beyond 2^24, which the Pallas kernel cannot compare in f32:
        # the XLA scan is the reference there
        "large_keys": np.sort(rng.integers(1 << 25, (1 << 25) + 40, n)
                              ).astype(np.int32),
    }[kind]
    val = (rng.normal(size=(n, 2)) * 10).astype(np.float32)
    ref = np.asarray(jch._segmented_cummax(jnp.asarray(key), jnp.asarray(val)))
    if kind != "large_keys":
        np.testing.assert_array_equal(np.asarray(pk.segmented_cummax_pallas(
            jnp.asarray(key), jnp.asarray(val), block=block, interpret=True)),
            ref)
    got = kernels.segmented_cummax(torch.from_numpy(key), torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy(), ref)


def _scan_keys(kind, n, period, rng):
    """Sorted i32[n] keys of one layout; ``edges``: runs of exactly ``period``
    rows, so that every run ends on a tile (or block) edge."""
    if kind == "one_run":
        return np.full(n, 3, np.int32)
    if kind == "distinct":
        return np.arange(n, dtype=np.int32)
    if kind == "edges":
        return (np.arange(n) // period).astype(np.int32)
    if kind == "long":      # a run over many tiles between short ones
        i = np.arange(n)
        return np.where(i < n // 10, i // 3,
                        np.where(i < n - n // 10, n, n + i // 5)).astype(np.int32)
    return np.sort(rng.integers(0, max(2, n // 9), n)).astype(np.int32)


def _order(bits):
    """csrc/seg_cummax.cu's order(): i32 bits of a float -> i32 in the
    floats' order, -0.0 below +0.0, every NaN at 0x7FC00000."""
    bits = bits.astype(np.int32)
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    return np.where(nan, np.int32(0x7FC00000),
                    bits ^ ((bits >> 31) & 0x7FFFFFFF)).astype(np.int32)


NONE = np.int32(-2 ** 31)


def _cummax_tiles_model(key, val, threads, warp, k_rows, rng):
    """numpy model of csrc/seg_cummax.cu's decomposition: tiles of
    ``threads * k_rows`` rows; per thread a serial scan of its rows from
    head flags and the max of its trailing run; a segmented scan of those
    over the lanes of a warp (segment start from the head lanes), warp
    totals combined in order; per tile a descriptor (AGGREGATE while the
    whole tile continues its predecessor's run, else INCLUSIVE) and a
    look-back over ``warp`` predecessors a step that stops at the nearest
    INCLUSIVE one.  A predecessor that has finished its own look-back is
    seen as AGGREGATE or as INCLUSIVE at random, as a running kernel may
    see it."""
    n, c = val.shape
    rows_per_tile = threads * k_rows
    x = _order(val.view(np.int32))
    head = np.r_[True, key[1:] != key[:-1]]
    out = np.empty_like(x)
    agg, incl, status = {}, {}, {}
    for tile in range(-(-n // rows_per_tile)):
        lo = tile * rows_per_tile
        rows = min(rows_per_tile, n - lo)
        v = np.full((threads, c), NONE)          # trailing-run max per thread
        has = np.zeros(threads, bool)
        local = np.empty((rows, c), np.int32)
        lead = np.full(threads, k_rows)
        for t in range(threads):
            for i in range(max(0, min(k_rows, rows - t * k_rows))):
                r = t * k_rows + i
                if head[lo + r]:
                    v[t] = x[lo + r]
                    if not has[t]:
                        lead[t] = i
                    has[t] = True
                else:
                    v[t] = np.maximum(v[t], x[lo + r])
                local[r] = v[t]
        # inclusive segmented scan over the lanes of each warp
        inc = v.copy()
        for w0 in range(0, threads, warp):
            # the doubling steps, as the kernel takes them: lane l joins
            # lane l - d while that is not before its segment's start
            cur = inc[w0:w0 + warp].copy()
            d = 1
            while d < warp:
                nxt = cur.copy()
                for lane in range(warp):
                    heads_le = [l for l in range(lane + 1) if has[w0 + l]]
                    seg_start = heads_le[-1] if heads_le else 0
                    if lane >= d and lane - d >= seg_start:
                        nxt[lane] = np.maximum(cur[lane], cur[lane - d])
                cur = nxt
                d *= 2
            inc[w0:w0 + warp] = cur
        e = np.full((threads, c), NONE)          # carried into each thread
        e_head = np.zeros(threads, bool)
        p, p_head = np.full(c, NONE), False
        for w0 in range(0, threads, warp):
            for lane in range(warp):
                t = w0 + lane
                before = has[w0:t].any()
                if lane == 0:
                    e[t] = p
                else:
                    e[t] = inc[t - 1] if before else np.maximum(p, inc[t - 1])
                e_head[t] = before or p_head
            wf = has[w0:w0 + warp].any()
            last = inc[w0 + warp - 1]
            p = last if wf else np.maximum(p, last)
            p_head = p_head or wf
        tile_agg, tile_has_head = p, p_head
        continues = not head[lo]
        # publish, look back, publish again
        if tile_has_head:
            incl[tile], status[tile] = tile_agg, "I"
        else:
            agg[tile], status[tile] = tile_agg, "A"
        carry = np.full(c, NONE)
        if continues:
            base, done = tile - 1, False
            while not done:
                seen = []
                for lane in range(warp):
                    q = base - lane
                    if q < 0:
                        seen.append("I")
                    elif status[q] == "A" or (q in agg and rng.random() < 0.5):
                        seen.append("A")
                    else:
                        seen.append("I")
                first = seen.index("I") if "I" in seen else warp
                for lane in range(min(first + 1, warp)):
                    q = base - lane
                    assert q >= 0
                    carry = np.maximum(carry, agg[q] if lane < first
                                       else incl[q])
                done = first < warp
                base -= warp
        if not tile_has_head:
            incl[tile] = np.maximum(tile_agg, carry)
            status[tile] = "I"
        for t in range(threads):
            cv = e[t] if e_head[t] else np.maximum(e[t], carry)
            for i in range(max(0, min(k_rows, rows - t * k_rows))):
                r = t * k_rows + i
                out[lo + r] = (np.maximum(local[r], cv) if i < lead[t]
                               else local[r])
    return (out ^ ((out >> 31) & 0x7FFFFFFF)).astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "one_run", "distinct", "edges",
                                  "long"])
@pytest.mark.parametrize("c", [1, 2, 3, 6, 8, 12, 16])
def test_segmented_cummax_tile_model_matches_plain(c, kind):
    """The CUDA kernel's decomposition (tiles, per-thread and per-warp
    aggregates, descriptors and the look-back's stopping rule), rehearsed in
    numpy at a small geometry, gives the plain version's bits: for N just
    below, at and above a tile and over many tiles, each width's rows per
    thread, one run over everything, all keys distinct, runs that end
    exactly on tile edges, signed zeros and NaNs among the values."""
    rng = np.random.default_rng(c * 7 + len(kind))
    threads, warp = 8, 4
    k_rows = 16 if c <= 2 else 8 if c <= 4 else 4     # the kernel's K
    tile = threads * k_rows
    for n in (tile - 1, tile, tile + 1, 9 * tile + 5):
        key = _scan_keys(kind, n, tile, rng)
        val = (rng.normal(size=(n, c)) * 10).astype(np.float32)
        special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf], np.float32)
        pick = rng.random((n, c))
        val = np.where(pick < 0.1, special[rng.integers(0, 2, (n, c))], val)
        val = np.where(pick > 0.995, special[rng.integers(2, 5, (n, c))], val)
        val = val.astype(np.float32)
        ref = kernels.segmented_cummax_plain(torch.from_numpy(key),
                                             torch.from_numpy(val)).numpy()
        got = _cummax_tiles_model(key, val, threads, warp, k_rows, rng)
        np.testing.assert_array_equal(got, ref.view(np.int32))


@pytest.mark.parametrize("c", [1, 2, 8])
def test_segmented_cummax_zero_and_nan_rule_matches_pallas(c):
    """The stated tie rule against the Pallas kernel in interpret mode, bit
    for bit: the max of +0.0 and -0.0 is +0.0 whichever comes first, and from
    a run's first NaN on the result is the NaN 0x7FC00000.  (No -inf: the
    Pallas kernel's neutral element is -3e38, which a lone -inf turns into.)"""
    rng = np.random.default_rng(c)
    n, block = 1500, 256
    key = np.sort(rng.integers(0, 60, n)).astype(np.int32)
    special = np.array([0.0, -0.0, 0.0, -0.0, np.nan, np.inf], np.float32)
    val = np.where(rng.random((n, c)) < 0.7,
                   -1.0 - rng.random((n, c)),
                   special[rng.integers(0, 5, (n, c))]).astype(np.float32)
    val[rng.random((n, c)) < 0.003] = np.inf
    v = val[:, 0] if c == 1 else val
    ref = np.asarray(pk.segmented_cummax_pallas(
        jnp.asarray(key), jnp.asarray(v), block=block, interpret=True))
    got = kernels.segmented_cummax(torch.from_numpy(key),
                                   torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    bits = got.view(np.int32)
    assert (bits == 0).any() and (bits == np.int32(-2 ** 31)).any()
    assert (bits == 0x7FC00000).any()


def _cumsum_groups(w):
    """csrc/seg_cumsum.cu's scan_from<>: the register groups (first channel,
    size, floats an access) that cover a tile of w floats a row."""
    vw = 4 if w % 4 == 0 else 2 if w % 2 == 0 else 1
    g0, plan = 0, []
    while g0 < w:
        left = w - g0
        g = (4 if vw == 4 else (4 if left >= 4 else 2) if vw == 2
             else 2 if left == 4 else 3 if left >= 3 else left)
        plan.append((g0, g, vw))
        g0 += g
    return plan


def _cumsum_blocks_model(key, val, threads, items, rng, warp=4, in_flight=5):
    """numpy model of csrc/seg_cumsum.cu's decomposition: blocks of
    ``threads * items`` rows loaded as one flat span; thread t owns rows t,
    t + T, ...; start(r) from the rows' head flags, inside a warp's rows
    and across the (item, warp) segments before them (rows past the end
    keyed INT32_MAX); steps s < T through the shared tile, steps
    s >= T pairing a thread's own rows from the last down; channels in the
    register groups of ``_cumsum_groups``.  The carry of a block that
    continues a run: walk back to the nearest block whose inc is known (one
    that holds a run start, or one that has published its inc; of the
    ``in_flight`` blocks just before, an open one has published it or not,
    at random, as a running kernel may find it), then forward again adding
    each last row in the chain's order; folded into the leading run before
    the block's one write."""
    n, c = val.shape
    block = threads * items
    nb = -(-n // block)
    out = np.empty((n, c), np.float32)
    last_val = np.empty((nb, c), np.float32)
    inc_val = {}
    zero = np.float32(0.0)

    def last_key(q):
        return key[min(n, (q + 1) * block) - 1]

    def closed(q):
        return q == 0 or key[q * block - 1] != last_key(q)

    for b in range(nb):
        lo = b * block
        rows = min(block, n - lo)
        flat = np.zeros(block * c, np.float32)
        flat[:rows * c] = val[lo:lo + rows].reshape(-1)       # one flat copy
        tile = flat.reshape(block, c)
        keys = np.full(block, np.iinfo(np.int32).max, np.int32)
        keys[:rows] = key[lo:lo + rows]
        # start(r): the last head at or before r inside its warp's rows,
        # else the last head of the (item, warp) segments before
        head = np.r_[True, keys[1:] != keys[:-1]]
        dist = np.empty((items, threads), np.int64)
        seg_last, before = [], -1
        for j in range(items):
            for w0 in range(0, threads, warp):
                r0 = j * threads + w0
                for lane in range(warp):
                    at = np.flatnonzero(head[r0:r0 + lane + 1])
                    start = r0 + at[-1] if len(at) else before
                    dist[j, w0 + lane] = r0 + lane - start
                at = np.flatnonzero(head[r0:r0 + warp])
                seg_last.append(r0 + at[-1] if len(at) else -1)
                before = max(before, seg_last[-1])
        assert (dist >= 0).all()
        covered = []
        for g0, g, vw in _cumsum_groups(c):
            assert g0 % vw == 0 and g % vw == 0
            covered += list(range(g0, g0 + g))
            v = np.stack([tile[j * threads:(j + 1) * threads, g0:g0 + g]
                          for j in range(items)]).copy()       # [items, T, g]
            s = 1
            while s < min(threads, block):
                for j in range(items):
                    for t in range(threads):
                        r = j * threads + t
                        p = tile[r - s, g0:g0 + g] if dist[j, t] >= s else zero
                        v[j, t] = v[j, t] + p
                for j in range(items):
                    tile[j * threads:(j + 1) * threads, g0:g0 + g] = v[j]
                s *= 2
            q = 1
            while q < items:
                for j in range(items - 1, -1, -1):
                    ok = (dist[j] >= q * threads) & (j >= q)
                    v[j] = v[j] + np.where(ok[:, None], v[max(j - q, 0)], zero)
                q *= 2
            for j in range(items):
                tile[j * threads:(j + 1) * threads, g0:g0 + g] = v[j]
        assert covered == list(range(c))
        last_val[b] = tile[rows - 1]
        if b > 0 and key[lo - 1] == keys[0]:
            anchor = b - 1
            while not (closed(anchor) or (
                    anchor in inc_val
                    and (b - anchor > in_flight or rng.random() < 0.5))):
                anchor -= 1
            inc = last_val[anchor] if closed(anchor) else inc_val[anchor]
            for k in range(anchor + 1, b):
                assert not closed(k)
                inc = last_val[k] + inc
            if keys[rows - 1] == keys[0]:        # no run start in this block
                assert not closed(b)
                inc_val[b] = last_val[b] + inc
            lead = int(np.searchsorted(keys[:rows], keys[0], side="right"))
            tile[:lead] = tile[:lead] + inc
        else:
            assert closed(b)
        out[lo:lo + rows] = tile[:rows]
    return out


@pytest.mark.parametrize("kind", ["random", "one_run", "distinct", "edges",
                                  "long"])
@pytest.mark.parametrize("c", [1, 2, 3, 6, 8, 12, 16])
def test_segmented_cumsum_block_model_matches_plain(c, kind):
    """The CUDA kernel's decomposition (flat tile, row ownership, run-start
    index, shared and in-thread steps, register groups, the carry's walk back
    to a known inc and forward in the chain's order), rehearsed in numpy at
    a small geometry, gives the plain version's bits, signs of zeros
    included."""
    rng = np.random.default_rng(c * 11 + len(kind))
    for threads, items in ((8, 1), (4, 8)):
        block = threads * items
        for n in (block - 1, block, block + 1, 7 * block + 3):
            key = _scan_keys(kind, n, block, rng)
            val = (rng.normal(size=(n, c)) * 100).astype(np.float32)
            val[rng.random((n, c)) < 0.2] = -0.0
            ref = kernels.segmented_cumsum_plain(
                torch.from_numpy(key), torch.from_numpy(val),
                block=block).numpy()
            got = _cumsum_blocks_model(key, val, threads, items, rng)
            np.testing.assert_array_equal(got.view(np.int32),
                                          ref.view(np.int32))


def _cumsum_case(kind, rng):
    """(keys, values, block) of one segmented-cumsum case."""
    block = 256
    if kind == "one_d":            # f32[N], runs across blocks, padded tail
        key = np.sort(rng.integers(0, 37, 1000))
        val = rng.normal(size=1000) * 100
    elif kind == "three_channels":  # the inventory's width, ragged tail
        key = np.sort(rng.integers(0, 23, 1500))
        val = rng.normal(size=(1500, 3)) * 100
    elif kind == "long_runs":      # runs spanning several whole blocks
        key = np.repeat(np.arange(3), [700, 1100, 300])
        val = rng.normal(size=(2100, 2)) * 10 + 50
    elif kind == "one_run":
        key = np.zeros(3000)
        val = rng.normal(size=(3000, 3))
    elif kind == "all_distinct":
        key = np.arange(777)
        val = rng.normal(size=(777, 3))
    elif kind == "signed_zeros":   # -0.0 rounds to +0.0 through "+ where(.., 0)"
        key = np.sort(rng.integers(0, 9, 600))
        val = np.where(rng.random((600, 2)) < 0.5, -0.0,
                       rng.normal(size=(600, 2)))
    else:                          # the default block, exact multiple of it
        block = 8192
        key = np.sort(rng.integers(0, 5, 2 * 8192))
        val = rng.normal(size=(2 * 8192, 3)) * 1e3
    return key.astype(np.int32), val.astype(np.float32), block


@pytest.mark.parametrize("kind", ["one_d", "three_channels", "long_runs",
                                  "one_run", "all_distinct", "signed_zeros",
                                  "default_block"])
def test_segmented_cumsum_plain_matches_pallas(kind):
    """Bit for bit, signs of zeros included: the plain version adds in the
    Pallas kernel's order (blocks, doubling steps, chained carry)."""
    key, val, block = _cumsum_case(kind, np.random.default_rng(len(kind)))
    ref = np.asarray(pk.segmented_cumsum_pallas(
        jnp.asarray(key), jnp.asarray(val), block=block, interpret=True))
    got = kernels.segmented_cumsum(torch.from_numpy(key),
                                   torch.from_numpy(val), block=block).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    # each run's last row holds the run total, to f32 rounding
    ends = np.flatnonzero(np.r_[key[1:] != key[:-1], True])
    tot = np.zeros((key.max() + 1,) + val.shape[1:])
    np.add.at(tot, key, val.astype(np.float64))
    scale = np.zeros_like(tot)
    np.add.at(scale, key, np.abs(val).astype(np.float64))
    assert (np.abs(got[ends] - tot[key[ends]])
            <= 64 * np.finfo(np.float32).eps * scale[key[ends]] + 1e-30).all()


def _flood_case(kind, rng):
    """(seed_slot i32[B,G,G], seed_pos f32[B,G,G,2], cell_center f32[G,G,2])
    of one jump-flood case, on a unit grid from 0."""
    g, b, n_seeds, integer = {
        "g16": (16, 2, 6, False), "g48": (48, 3, 25, False),
        "g64": (64, 2, 40, False), "no_seed": (16, 2, 0, False),
        "one_seed": (64, 1, 1, False), "edges": (48, 2, 12, False),
        "integer_ties": (48, 2, 30, True)}[kind]
    slot = np.full((b, g, g), -1, np.int32)
    pos = np.zeros((b, g, g, 2), np.float32)
    for bi in range(b):
        cells = rng.choice(g * g, n_seeds, replace=False)
        ij = np.stack(np.divmod(cells, g), -1)
        if kind == "edges":   # seeds on the border rows and columns
            ij[::2, 0] = rng.choice([0, g - 1], len(ij[::2]))
            ij[1::2, 1] = rng.choice([0, g - 1], len(ij[1::2]))
            ij = np.unique(ij, axis=0)
        for k, (i, j) in enumerate(ij):
            slot[bi, i, j] = k
            off = 0.5 if integer else rng.random(2)
            pos[bi, i, j] = (np.array([i, j]) + off).astype(np.float32)
    centre = np.arange(g, dtype=np.float32) + 0.5
    cc = np.stack(np.meshgrid(centre, centre, indexing="ij"), -1)
    return slot, pos, cc.astype(np.float32)


@pytest.mark.parametrize("kind", ["g16", "g48", "g64", "no_seed", "one_seed",
                                  "edges", "integer_ties"])
def test_jump_flood_plain_matches_pallas(kind):
    """Bit for bit against the Pallas kernel in interpret mode (one band per
    call) and, at one grid size, against the JAX package's batched jnp flood
    run op by op (slow: every op compiles).  Seeds on the edges win wrapped
    cells; integer positions make exact distance ties, which only a strict
    < resolves the same way."""
    slot, pos, cc = _flood_case(kind, np.random.default_rng(len(kind)))
    got = kernels.jump_flood(torch.from_numpy(slot), torch.from_numpy(pos),
                             torch.from_numpy(cc)).numpy()
    ref = np.stack([np.asarray(pk.jump_flood_pallas(
        jnp.asarray(slot[i]), jnp.asarray(pos[i]), jnp.asarray(cc),
        interpret=True)) for i in range(len(slot))])
    np.testing.assert_array_equal(got, ref)
    if kind in ("edges", "integer_ties"):
        with jax.disable_jit():
            ref_jnp = np.asarray(jsg._jump_flood(
                jnp.asarray(slot), jnp.asarray(pos), jnp.asarray(cc)))
        np.testing.assert_array_equal(got, ref_jnp)
    seeded = (slot >= 0).any(axis=(1, 2))
    assert ((got >= 0).all(axis=(1, 2)) == seeded).all()
    if kind == "edges":
        g = slot.shape[-1]
        # some cell is won by a seed reached only across the wrap: its seed
        # is nearer the far edge than the cell itself
        seed_i = {(b, k): i for b, i, _ in zip(*np.nonzero(slot >= 0))
                  for k in [slot[b, i, _]]}
        wrapped = [abs(i - seed_i[b, got[b, i, j]]) > g // 2
                   for b, i, j in zip(*np.nonzero(got >= 0))]
        assert any(wrapped)


def _flood_cluster_model(slot, pos, cc):
    """The cluster kernel's flood in plain torch: one origin (the seed's
    cell index in its band, or -1) per cell, the rows split over
    ``CLUSTER_CTAS`` blocks as the kernel's CTAs hold them, each block's
    origins double-buffered, a candidate's row read from whichever block
    holds it (wrapped), its distance recomputed from ``seed_pos`` only where
    it differs from the cell's own origin, strict <, and every block
    swapping its buffers after each direction.  Output: the origin's slot,
    or the cell's own seed slot where no seed reached it."""
    b, g, _ = slot.shape
    ctas = CLUSTER_CTAS
    rows_per = -(-g // ctas)
    r0s = [min(r * rows_per, g) for r in range(ctas)]
    hs = [min(r0 + rows_per, g) - r0 for r0 in r0s]
    cxz = cc.reshape(-1, 2)
    out = torch.empty_like(slot)

    def dist(p, c):
        ex = p[..., 0] - c[..., 0]
        ez = p[..., 1] - c[..., 1]
        return ex * ex + ez * ez

    for bi in range(b):
        s_b, p_b = slot[bi].reshape(-1), pos[bi].reshape(-1, 2)
        cur = torch.full((ctas, rows_per, g), -7, dtype=torch.int32)
        for r, (r0, h) in enumerate(zip(r0s, hs)):
            cells = torch.arange(r0 * g, (r0 + h) * g, dtype=torch.int32)
            cur[r, :h] = torch.where(s_b[cells.long()] >= 0, cells,
                                     -1).view(h, g)
        if not any(bool((cur[r, :h] >= 0).any()) for r, h in enumerate(hs)):
            out[bi] = slot[bi]          # a band without a seed
            continue
        for s in kernels.jump_flood_steps(g):
            for dy in (-s, 0, s):
                for dx in (-s, 0, s):
                    if dy == 0 and dx == 0:
                        continue
                    nxt = torch.full_like(cur, -7)
                    for r, (r0, h) in enumerate(zip(r0s, hs)):
                        if h == 0:
                            continue
                        si = torch.arange(r0, r0 + h) - dy
                        si = torch.where(si < 0, si + g,
                                         torch.where(si >= g, si - g, si))
                        owner = si // rows_per
                        assert bool((torch.tensor(hs)[owner]
                                     > si - torch.tensor(r0s)[owner]).all())
                        sj = torch.arange(g) - dx
                        sj = torch.where(sj < 0, sj + g,
                                         torch.where(sj >= g, sj - g, sj))
                        co = cur[owner, si - owner * rows_per][:, sj]
                        o = cur[r, :h]
                        c = cxz[r0 * g:(r0 + h) * g].view(h, g, 2)
                        need = (co >= 0) & (co != o)
                        cd = dist(p_b[co.clamp(min=0).long()], c)
                        d = torch.where(o >= 0,
                                        dist(p_b[o.clamp(min=0).long()], c),
                                        INF)
                        nxt[r, :h] = torch.where(need & (cd < d), co, o)
                    cur = nxt               # cluster.sync(), then swap
        for r, (r0, h) in enumerate(zip(r0s, hs)):
            o = cur[r, :h].reshape(-1)
            own = torch.arange(r0 * g, (r0 + h) * g)
            out[bi].view(-1)[r0 * g:(r0 + h) * g] = s_b[
                torch.where(o >= 0, o.long(), own)]
    return out


def _flood_model_case(g, kind, rng):
    """Two bands of one jump-flood case: band 0 seeded as ``kind`` says,
    band 1 without a seed.  ``dups``: few slot ids, each on several seeds
    at positions anywhere in the grid (not in their cells), and unseeded
    cells of -1 and -5; ``ties``: positions on cell centres, so that many
    distances tie exactly; ``wrap``: seeds on the border rows and
    columns."""
    slot = np.full((2, g, g), -1, np.int32)
    pos = np.zeros((2, g, g, 2), np.float32)
    n = min(g * g, max(3, g * g // 40))
    cells = rng.choice(g * g, n, replace=False)
    ij = np.stack(np.divmod(cells, g), -1)
    if kind == "wrap":
        ij[::2, 0] = rng.choice([0, g - 1], len(ij[::2]))
        ij[1::2, 1] = rng.choice([0, g - 1], len(ij[1::2]))
    if kind == "dups":
        slot[0, ij[:, 0], ij[:, 1]] = rng.integers(0, 3, len(ij))
        pos[0, ij[:, 0], ij[:, 1]] = rng.uniform(0, g, (len(ij), 2))
        slot[1, ::3, ::2] = -5
    else:
        slot[0, ij[:, 0], ij[:, 1]] = np.arange(len(ij))
        off = 0.5 if kind == "ties" else rng.random((len(ij), 2))
        pos[0, ij[:, 0], ij[:, 1]] = ij + off
    centre = np.arange(g, dtype=np.float32) + 0.5
    cc = np.stack(np.meshgrid(centre, centre, indexing="ij"), -1)
    return (torch.from_numpy(slot), torch.from_numpy(pos),
            torch.from_numpy(cc.astype(np.float32)))


@pytest.mark.parametrize("g,kind", [
    (1, "dups"), (3, "ties"), (4, "ties"), (17, "dups"), (17, "ties"),
    (17, "wrap"), (383, "dups"), (385, "ties"), (385, "wrap")])
def test_jump_flood_cluster_model_matches_plain(g, kind):
    """The cluster kernel's design (origins in place of (slot, x, z),
    ragged row blocks, wrapped sources in other blocks, the skip where a
    candidate is the cell's own origin) gives the plain flood's slots bit
    for bit, a band without a seed included."""
    slot, pos, cc = _flood_model_case(g, kind, np.random.default_rng(g))
    got = _flood_cluster_model(slot, pos, cc)
    np.testing.assert_array_equal(got.numpy(),
                                  kernels.jump_flood_plain(slot, pos,
                                                           cc).numpy())
    assert torch.equal(got[1], slot[1])
    if g == 4:                          # and the Pallas kernel, once
        ref = pk.jump_flood_pallas(jnp.asarray(slot[0].numpy()),
                                   jnp.asarray(pos[0].numpy()),
                                   jnp.asarray(cc.numpy()), interpret=True)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))


def test_jump_flood_route_by_grid_size():
    """Up to G=480 a band's origins fit its cluster's shared memory,
    double-buffered; above, the kernel keeps them in device memory."""
    assert CLUSTER_CTAS == 8
    route = kernels.jump_flood_route
    assert [route(g) for g in (1, 383, 384, 385, 480)] == ["shared"] * 5
    assert [route(g) for g in (481, 512, 640, 1024)] == ["device"] * 4


def test_jump_flood_steps():
    assert kernels.jump_flood_steps(384) == [192, 96, 48, 24, 12, 6, 3, 1]
    assert kernels.jump_flood_steps(1) == []
    assert kernels.jump_flood_steps(3) == [1]


def _nearest_slot_design():
    """(threads, rows a thread, staged slots a pass) of
    ``csrc/nearest_slot.cu``."""
    text = (build.CSRC / "nearest_slot.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               text).group(1))
                 for name in ("kThreads", "kRows", "kStageSlots"))


def _nearest_slot_model(occ_idx, occ_valid, pos, act, lo, s, n_bands, g,
                        threads, rows, stage, warp=32):
    """The nearest_slot kernel's design in numpy f32: the -1 fill, then
    tiles of ``threads * rows`` consecutive rows (thread t's rows t,
    t + threads, ...); a tile of padding alone returns; the tile's bands in
    ascending order; each band's active slots staged in passes of at most
    ``stage``, round by round of ``threads`` slots, each round compacted by
    warp ballots (a lane's place: the live lanes below it) and a prefix of
    the warps' counts; each row walks the staged slots with strict <, the
    rows of another band with NaN centres; a pass's winners read their slot
    ids from the stage.  Returns (i32[B,G,G], each tile's [(band, passes)])."""
    f32 = np.float32
    occ_idx, occ_valid = occ_idx.numpy(), occ_valid.numpy()
    pos, act = pos.numpy(), act.numpy()
    t_cap = act.shape[1]
    gg, cells = g * g, n_bands * g * g
    out = np.full(cells, -1, np.int32)
    lo_x, lo_z, step = f32(lo[0]), f32(lo[2]), f32(s)
    tile = threads * rows
    visits = []
    for t0 in range(0, len(occ_idx), tile):
        row = (t0 + np.arange(rows)[:, None] * threads
               + np.arange(threads)[None, :]).reshape(-1)
        inside = row < len(occ_idx)
        q = occ_idx[np.minimum(row, len(occ_idx) - 1)]
        live = inside & occ_valid[np.minimum(row, len(occ_idx) - 1)]
        live &= (q >= 0) & (q < cells)
        visits.append([])
        if not live.any():
            continue
        band = np.where(live, q // gg, -1)
        c = q - (q // gg) * gg
        i, j = c // g, c % g
        cx = np.where(live, lo_x + (i.astype(f32) + f32(0.5)) * step, np.nan)
        cz = np.where(live, lo_z + (j.astype(f32) + f32(0.5)) * step, np.nan)
        best_d = np.full(len(row), NEAREST_INF, f32)
        best = np.full(len(row), -1, np.int32)
        for b in np.unique(band[live]):
            px = np.where(band == b, cx, np.nan).astype(f32)
            pz = np.where(band == b, cz, np.nan).astype(f32)
            j0, passes = 0, 0
            while j0 < t_cap:
                count = 0
                spos = np.zeros((stage, 2), f32)
                sid = np.full(stage, -1, np.int64)
                while j0 < t_cap and count + threads <= stage:
                    jj = j0 + np.arange(threads)
                    lv = (jj < t_cap) & act[b, np.minimum(jj, t_cap - 1)]
                    lanes = lv.reshape(-1, warp)
                    warp_count = lanes.sum(1)
                    off = count + np.concatenate([[0],
                                                  np.cumsum(warp_count)[:-1]])
                    k = (off[:, None] + np.cumsum(lanes, 1)
                         - lanes).reshape(-1)
                    spos[k[lv]] = pos[b, jj[lv]]
                    sid[k[lv]] = jj[lv]
                    count += int(warp_count.sum())
                    j0 += threads
                passes += 1
                # the compaction keeps the slots' order
                assert (np.diff(sid[:count]) > 0).all()
                hit = np.full(len(row), -1, np.int64)
                for k in range(count):
                    ex = px - spos[k, 0]
                    ez = pz - spos[k, 1]
                    d = ex * ex + ez * ez
                    upd = d < best_d
                    best_d = np.where(upd, d, best_d)
                    hit = np.where(upd, k, hit)
                best = np.where(hit >= 0, sid[hit], best).astype(np.int32)
            visits[-1].append((int(b), passes))
        out[q[live]] = best[live]
    return torch.from_numpy(out.reshape(n_bands, g, g)), visits


VORONOI_KINDS = sorted(voronoi_cases.CASES)


@pytest.mark.parametrize("design", ["kernel", "small"])
@pytest.mark.parametrize("kind", VORONOI_KINDS)
def test_nearest_slot_tile_model_matches_plain(kind, design):
    """The kernel's partition (row tiles across bands, staged passes of
    ballot-compacted active slots, NaN centres for other bands' rows, ids
    read back from the stage) gives the plain version's slots bit for bit,
    with the kernel's constants and with a small design that restages
    every band several times."""
    args = voronoi_cases.case(kind)
    ref = kernels.nearest_slot_plain(*args, 256)
    threads, rows, stage = (_nearest_slot_design() if design == "kernel"
                            else (64, 2, 128))
    got, visits = _nearest_slot_model(*args, threads, rows, stage)
    assert torch.equal(got, ref)
    if design == "small" and kind != "no_active_band":
        assert max(p for v in visits for _, p in v) > 1     # restaged
    if kind == "t_over_stage" and design == "kernel":
        assert {p for v in visits for _, p in v} == {2}


def test_nearest_slot_tile_model_partition():
    """With the kernel's constants the mixed case's tiles take 1, 2 and 3
    bands, its last tile none (padding alone); every band of a tile is
    visited once, in ascending order."""
    got, visits = _nearest_slot_model(*voronoi_cases.case("mixed"),
                                      *_nearest_slot_design())
    assert {len(v) for v in visits} >= {0, 1, 2, 3}
    assert visits[-1] == []
    for v in visits:
        bands = [b for b, _ in v]
        assert bands == sorted(set(bands))
    assert _nearest_slot_design()[2] % _nearest_slot_design()[0] == 0


def _nearest_ties(occ_idx, occ_valid, pos, act, lo, s, n_bands, g):
    """Valid rows whose band has two or more active slots at the least
    distance (f64, from the f32 centres)."""
    cx, cz = (v.double().numpy() for v in
              cell_centers(occ_idx, lo, s, g))
    band = (occ_idx // (g * g)).numpy()
    n = 0
    for r in np.flatnonzero(occ_valid.numpy()):
        p = pos[band[r]].double().numpy()[act[band[r]].numpy()]
        if len(p) > 1:
            d = (cx[r] - p[:, 0]) ** 2 + (cz[r] - p[:, 1]) ** 2
            n += int((d == d.min()).sum() > 1)
    return n


@pytest.mark.parametrize("kind", VORONOI_KINDS)
def test_nearest_slot_on_cpu_equals_jax_bruteforce(kind):
    """On CPU tensors the wrapper is the plain chunked brute force, which
    equals the JAX package's ``_bruteforce_voronoi`` op by op and gives the
    same slots at any chunk; the lowest slot wins a tie, -1 where a band
    has no active slot, cells past the rows stay -1."""
    args = voronoi_cases.case(kind)
    occ_idx, occ_valid, pos, act, lo, s, n_bands, g = args
    kernels.reset_launches()
    got = kernels.nearest_slot(*args, 256)
    assert kernels.nearest_slot.launches == 0
    with jax.disable_jit():
        ref = jsg._bruteforce_voronoi(
            *(jnp.asarray(t.numpy()) for t in (occ_idx, occ_valid, pos, act,
                                               lo, s)), n_bands, g, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for chunk in (1, 7, pos.shape[1]):
        if chunk == 1 and pos.shape[1] * int(occ_valid.sum()) > 4e6:
            continue
        assert torch.equal(kernels.nearest_slot_plain(*args, chunk), got)
    occupied = torch.zeros(n_bands * g * g, dtype=torch.bool)
    occupied[occ_idx[occ_valid].long()] = True
    assert bool((got.view(-1)[~occupied] == -1).all())
    if kind in ("ties", "dups"):
        assert _nearest_ties(*args) > 0
    if kind == "no_active_band":
        assert bool((got[1:3] == -1).all()) and bool((got[0] >= 0).any())
    if kind == "cap":
        assert int((got >= 0).sum()) == len(occ_idx)


def _bad_voronoi_inputs():
    occ_idx, occ_valid, pos, act, lo, s, n_bands, g = (
        voronoi_cases.case("mixed"))
    good = dict(occ_idx=occ_idx, occ_valid=occ_valid, tracked_pos_b=pos,
                active_b=act, lo=lo, s=s, n_bands=n_bands, g=g, chunk=256)
    return good, {
        "i64 indices": dict(occ_idx=occ_idx.long()),
        "2-D indices": dict(occ_idx=occ_idx[:, None]),
        "u8 flags": dict(occ_valid=occ_valid.to(torch.uint8)),
        "short flags": dict(occ_valid=occ_valid[1:]),
        "f64 positions": dict(tracked_pos_b=pos.double()),
        "3 coordinates": dict(tracked_pos_b=torch.zeros(n_bands, 300, 3)),
        "bands differ": dict(n_bands=n_bands + 1),
        "i32 slot flags": dict(active_b=act.int()),
        "slot flags short": dict(active_b=act[:, 1:]),
        "f64 lo": dict(lo=lo.double()),
        "lo of 2": dict(lo=lo[:2]),
        "f64 cell size": dict(s=s.double()),
        "two cell sizes": dict(s=torch.ones(2)),
        "no grid": dict(g=0),
        "grid past i32": dict(g=1 << 15),
        "chunk 0": dict(chunk=0),
        "meta device": dict(occ_idx=occ_idx.to("meta"),
                            occ_valid=occ_valid.to("meta"),
                            tracked_pos_b=pos.to("meta"),
                            active_b=act.to("meta"), lo=lo.to("meta"),
                            s=s.to("meta")),
        "mixed devices": dict(lo=lo.to("meta")),
    }


@pytest.mark.parametrize("bad", sorted(_bad_voronoi_inputs()[1]))
def test_nearest_slot_checks_its_inputs(bad):
    good, bads = _bad_voronoi_inputs()
    kernels.reset_launches()
    with pytest.raises(ValueError,
                       match="device" if "device" in bad else "nearest_slot"):
        kernels.nearest_slot(**{**good, **bads[bad]})
    assert kernels.nearest_slot.launches == 0


def _grid_design():
    """The grid flood's constants in ``csrc/jump_flood.cu``."""
    text = (build.CSRC / "jump_flood.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                text).group(1))
            for name in ("kTileHalo", "kTileMaxSteps", "kTileCells",
                         "kTileAxis")}


def _magic_div(x, d):
    """x // d as the kernel's Divider takes it: (umulhi(x, m) + x) >>
    shift, with m and shift as ``csrc/jump_flood.cu``'s Divider::make makes
    them (x an int64 tensor in [0, 2^31))."""
    shift = 0
    while (1 << shift) < d:
        shift += 1
    m = ((1 << 32) * ((1 << shift) - d)) // d + 1
    assert 0 < m < 1 << 32
    return (((x * m) >> 32) + x) >> shift


def _biased(x):
    """x + 2^23 as f32, from the integer bits (0 <= x < 2^23)."""
    return (x.int() | 0x4B000000).view(torch.float32)


def _grid_origin(pos, w, i, j):
    """The origin of seed cell (i, j) as the grid kernel holds it: in the
    rasters' form (``pos`` None) (i << 16 | j), as CellPos packs it; else
    the flat index, as GivenPos."""
    return (i << 16 | j) if pos is None else i * w + j


def _grid_flat(pos, w, o):
    """The flat cell index of origin ``o`` (CellPos::flat / GivenPos)."""
    return (o >> 16) * w + (o & 0xFFFF) if pos is None else o


def _grid_dist(pos, cc, o, i, j):
    """Squared distance of origin ``o``'s seed from the centre of cell
    (i, j), as the grid kernel forms it: with ``pos`` None the seed at the
    (row, col) packed in ``o`` and the centre at (i, j), each difference
    taken between f32 values 2^23 + x (exact), as ``csrc/jump_flood.cu``'s
    CellPos; else from ``pos`` and ``cc``."""
    x = o.clamp(min=0).long()
    if pos is None:
        ex = _biased(x >> 16) - _biased(i)
        ez = _biased(x & 0xFFFF) - _biased(j)
    else:
        p = pos.reshape(-1, 2)[x]
        c = cc[i.clamp(min=0).long(), j.clamp(min=0).long()]
        ex = p[..., 0] - c[..., 0]
        ez = p[..., 1] - c[..., 1]
    return ex * ex + ez * ez


def _axis_cells(a, tile):
    """Tile ``tile``'s cell along axis ``a`` at each local index (-1 past
    the last cycle) and whether it is in the core, as the kernel's
    axis_cells with its multiply-high dividers: local index l is cycle
    c0 + l % q at position k0 + l // q - halo, wrapped along the cycle."""
    l = torch.arange(a["len"], dtype=torch.int64)
    m = _magic_div(l, a["q"])
    cycle = tile // a["wins"] * a["q"] + l - m * a["q"]
    k = tile % a["wins"] * a["t"] + m - a["halo"]
    x = k + TILE_HALO * a["p"]
    kk = x - _magic_div(x, a["p"]) * a["p"]
    ok = cycle < a["g"]
    y = cycle + kk * a["s"]
    if a["p"] * a["n"] + a["g"] < 2**31:
        at = y - _magic_div(y, a["n"]) * a["n"]
    else:
        at = y % a["n"]
    cell = torch.where(ok, at, -1)
    core = ok & (m >= a["halo"]) & (m < a["halo"] + a["t"]) & (k < a["p"])
    return cell, core


def _grid_tile_model(slot, pos, cc, steps, plan):
    """The tile route in plain torch: a pass a step; each tile loads its
    origins (from the seeds in the first pass) at the cells
    :func:`_axis_cells` names, runs the 8 directions on its own planes
    with local rolls of q cells (wrapped modulo the tile's length, as the
    kernel wraps them), and writes its core; every cell must be written by
    exactly one core.  Output: the origin's slot, or the cell's own."""
    h, w = slot.shape
    design = _grid_design()
    flat = slot.reshape(-1)
    idx = torch.arange(h * w, dtype=torch.int32)
    ii, jj = torch.meshgrid(torch.arange(h, dtype=torch.int32),
                            torch.arange(w, dtype=torch.int32), indexing="ij")
    state = torch.where(flat >= 0, _grid_origin(pos, w, ii, jj).reshape(-1),
                        -1)
    for s, (qr, tr, qc, tc) in zip(steps, plan):
        ar = tile_axis(h, s, qr, tr)
        ac = tile_axis(w, s, qc, tc)
        assert max(ar["len"], ac["len"]) <= design["kTileAxis"]
        assert ar["len"] * ac["len"] <= design["kTileCells"]
        assert {ar["halo"], ac["halo"]} <= {0, design["kTileHalo"]}
        new = torch.full_like(state, -7)
        written = torch.zeros_like(state)
        for t_r in range(ar["tiles"]):
            rows, r_core = _axis_cells(ar, t_r)
            for t_c in range(ac["tiles"]):
                cols, c_core = _axis_cells(ac, t_c)
                i = rows[:, None].expand(ar["len"], ac["len"])
                j = cols[None, :].expand(ar["len"], ac["len"])
                ok = (i >= 0) & (j >= 0)
                k = (i * w + j).clamp(min=0)
                cur = torch.where(ok, state[k], -1)
                # each cell's own distance, kept as it changes; in the
                # rasters' form a seed cell (distance 0) is skipped
                dist = torch.where(cur >= 0,
                                   _grid_dist(pos, cc, cur, i, j), INF)
                settled = (dist == 0) if pos is None else torch.zeros_like(
                    ok)
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if dy == 0 and dx == 0:
                            continue
                        co = torch.roll(cur, (dy * ar["q"], dx * ac["q"]),
                                        (0, 1))
                        cd = _grid_dist(pos, cc, co, i, j)
                        take = ((co >= 0) & (co != cur) & (cd < dist)
                                & ~settled)
                        cur = torch.where(take, co, cur)
                        dist = torch.where(take, cd, dist)
                core = r_core[:, None] & c_core[None, :]
                new[k[core]] = cur[core]
                written[k[core]] += 1
        assert bool((written == 1).all())
        state = new
    return flat[torch.where(state >= 0, _grid_flat(pos, w, state),
                            idx).long()].view(h, w)


def _grid_case(h, w, kind, seed=0):
    """(seed_slot i32[h,w], positions) of a raster flood: ``sparse`` one
    cell in a hundred and one more, ``far_edge`` seeds on the last row and
    column only, ``empty``, ``full``; each seed its cell's flat index.
    ``scattered``: the given form instead, slots 0-2 repeated, positions
    anywhere in the grid and centres jittered off (row, col)."""
    rng = np.random.default_rng(h * 7919 + w + seed)
    if kind == "far_edge":
        have = np.zeros((h, w), bool)
        have[-1, rng.integers(w, size=3)] = True
        have[rng.integers(h, size=3), -1] = True
    elif kind in ("sparse", "scattered"):
        have = rng.random((h, w)) < 0.01
        have[rng.integers(h), rng.integers(w)] = True
    else:
        have = np.full((h, w), kind == "full")
    slot = np.where(have, np.arange(h * w).reshape(h, w), -1)
    if kind != "scattered":
        return torch.from_numpy(slot.astype(np.int32)), None, None
    slot = np.where(have, rng.integers(0, 3, (h, w)), -1)
    pos = rng.uniform(-1, [h, w], (h, w, 2)).astype(np.float32)
    ij = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1)
    cc = (ij + rng.uniform(-0.4, 0.4, (h, w, 2))).astype(np.float32)
    return (torch.from_numpy(slot.astype(np.int32)), torch.from_numpy(pos),
            torch.from_numpy(cc))


GRID_SHAPES = [(1, 1), (1, 129), (129, 1), (5, 300), (127, 129), (37, 211),
               (300, 5), (48, 36), (17, 33)]


@pytest.mark.parametrize("h,w", GRID_SHAPES)
@pytest.mark.parametrize("kind", ["sparse", "far_edge", "empty", "full",
                                  "scattered"])
def test_grid_flood_tile_model_matches_plain(h, w, kind):
    """The tile route's design (cycles of each step along each axis, tiles
    of q cycles by t positions with a wrapped 3-position halo or whole
    cycles, a pass a step, the seeds' positions from their origins in the
    rasters' form) gives the plain flood's slots bit for bit with the
    wrapper's plan and with small tiles that force windows, halos wider
    than an axis and ragged cycle groups."""
    slot, pos, cc = _grid_case(h, w, kind)
    steps = trs.jfa_steps(h, w)
    ref = kernels.jump_flood_grid_plain(slot, pos, cc, steps)
    plan = kernels.jump_flood_grid_plan(h, w, tuple(steps))
    assert torch.equal(_grid_tile_model(slot, pos, cc, steps, plan), ref)
    small = kernels.jump_flood_grid_plan(h, w, tuple(steps), 256, 32)
    # the small tiles take windows with a halo wherever an axis is longer
    assert any(tile_axis(h, s, qr, tr)["halo"] or tile_axis(w, s, qc, tc)[
        "halo"] for s, (qr, tr, qc, tc) in zip(steps, small)) == (
        max(h, w) > 32)
    assert torch.equal(_grid_tile_model(slot, pos, cc, steps, small), ref)
    if kind == "full":
        assert torch.equal(ref, slot)
    assert bool((ref >= 0).all()) == (kind != "empty")


def test_grid_flood_tile_model_takes_any_steps():
    """Steps longer than an axis, of one and of no cycle (s a multiple of
    the axis), repeated and unsorted, through both models."""
    slot, pos, cc = _grid_case(37, 211, "sparse")
    for steps in ([1], [3, 5, 1000], [4096, 2, 1], [211, 37, 74], []):
        ref = kernels.jump_flood_grid_plain(slot, pos, cc, steps)
        for plan in (kernels.jump_flood_grid_plan(37, 211, tuple(steps)),
                     kernels.jump_flood_grid_plan(37, 211, tuple(steps),
                                                  256, 32)):
            assert torch.equal(_grid_tile_model(slot, pos, cc, steps, plan),
                               ref)


def _exact_flood(slot, steps):
    """The rasters' flood with exact int64 distances: what the f32 sums
    must NOT be replaced by."""
    h, w = slot.shape
    ii, jj = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    org = torch.where(slot >= 0, (ii * w + jj), -1).long()

    def dist(o):
        r, c = o.clamp(min=0) // w, o.clamp(min=0) % w
        return torch.where(o >= 0, (r - ii) ** 2 + (c - jj) ** 2, 2**62)
    for s in steps:
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                co = torch.roll(org, (dy, dx), (0, 1))
                org = torch.where(dist(co) < dist(org), co, org)
    return org.int()


@pytest.mark.parametrize("w,seeds", [
    (4096, ((0, 5), (1, 3011), (2, 1915), (0, 2990), (2, 404))),
    (8300, ((0, 0), (1, 8206)))])
def test_grid_flood_f32_sums_decide_ties(w, seeds):
    """3 x w grids.  At w = 4096, seeds ~3000 cells apart: every distance
    is below 2^24 (4095^2 + 2^2 < 2^24), so the f32 sums are exact and an
    exact integer flood agrees.  At w = 8300 two seeds ~8200 apart leave
    cells ~4100 from both: the squares pass 2^24, f32 rounds distances
    that differ by one to a tie, and the strict < keeps the seed that came
    first, so the exact flood takes another seed somewhere.  Both models
    follow the plain flood bit for bit."""
    h = 3
    slot = torch.full((h, w), -1, dtype=torch.int32)
    for r, c in seeds:
        slot[r, c] = r * w + c
    steps = trs.jfa_steps(h, w)
    ref = kernels.jump_flood_grid_plain(slot, None, None, steps)
    plan = kernels.jump_flood_grid_plan(h, w, tuple(steps))
    assert torch.equal(_grid_tile_model(slot, None, None, steps, plan), ref)
    exact = _exact_flood(slot, steps)
    assert bool((exact != ref).any()) == (w > 4096)


def _divider_cases(use):
    """(divisor, int64 x) pairs over the whole range that the tile
    arithmetic of ``csrc/jump_flood.cu`` feeds its Divider ``use``: by_q
    (l < len, q <= len <= kTileAxis) and by_len (f < kTileCells, a tile's
    column length <= kTileAxis) exhaustively; by_p (x = k + 3p with k from
    -3 to below p + t + 3, t <= p) exhaustively for p up to 4096, at the
    quotients' edges beyond; by_n (y = cycle + kk s < g + p n <= n + n^2,
    where that fits an int) at the quotients' edges and at random."""
    design = _grid_design()
    rng = np.random.default_rng(0)
    if use in ("q", "len"):
        top = design["kTileAxis"] if use == "q" else design["kTileCells"]
        x = torch.arange(top, dtype=torch.int64)
        return [(d, x) for d in range(1, design["kTileAxis"] + 1)]
    out = []
    if use == "p":
        for d in list(range(1, 4097)) + [4099, 65535, (1 << 24) - 1,
                                         (1 << 31) // 5 - 1]:
            lo, hi = 3 * d - TILE_HALO, 5 * d + TILE_HALO
            if d <= 4096:
                x = np.arange(max(lo, 0), hi)
            else:
                x = np.array([j * d + e for j in (3, 4, 5)
                              for e in (-3, -1, 0, 1, d - 1)])
                x = np.concatenate([x, rng.integers(max(lo, 0), hi, 64)])
            out.append((d, torch.from_numpy(x[(x >= 0) & (x < hi)])))
        return out
    for d in list(range(1, 4101)) + [6144, 46339, 46340]:
        hi = min(d + d * d, 1 << 31)
        j = rng.integers(0, hi // d + 1, 32)
        x = np.concatenate([j * d, j * d - 1, j * d + d - 1,
                            rng.integers(0, hi, 32), [0, hi - 1]])
        out.append((d, torch.from_numpy(x[(x >= 0) & (x < hi)])))
    return out


@pytest.mark.parametrize("use", ["q", "len", "p", "n"])
def test_grid_flood_magic_division(use):
    """The tile arithmetic's divisions by a multiply-high (Divider) equal
    the integer quotients over every range each of its four dividers is
    given."""
    for d, x in _divider_cases(use):
        assert torch.equal(_magic_div(x, d), x // d), (use, d)


def test_grid_flood_model_matches_jax_jfa_fill():
    """Once against the JAX package's jfa_fill run op by op: the tile
    model in the rasters' form fills the same values."""
    grid, have = _raster_seeds(37, 211)
    slot = torch.from_numpy(np.where(have, np.arange(37 * 211).reshape(
        37, 211), -1).astype(np.int32))
    steps = trs.jfa_steps(37, 211)
    origin = _grid_tile_model(slot, None, None, steps,
                              kernels.jump_flood_grid_plan(37, 211,
                                                           tuple(steps)))
    with jax.disable_jit():
        j_val, j_ok = jrs.jfa_fill(jnp.asarray(grid), jnp.asarray(have))
    ok = (origin >= 0).numpy()
    val = np.where(ok, grid.reshape(-1)[origin.clamp(min=0).numpy()], 0.0)
    assert (ok == np.asarray(j_ok)).all() and ok.all()
    assert val.astype(np.float32).tobytes() == np.asarray(j_val).tobytes()


def _raster_seeds(h, w):
    rng = np.random.default_rng(h + w)
    grid = rng.normal(0.0, 3.0, (h, w)).astype(np.float32)
    have = rng.random((h, w)) < 0.2
    have[h // 4: h // 2, w // 3: w // 2] = False    # one large hole
    return grid, have


@pytest.mark.parametrize("h,w", [(1, 1), (5, 300), (37, 211), (128, 256)])
@pytest.mark.parametrize("kind", ["sparse", "far_edge", "empty", "full"])
def test_grid_flood_cell_form_equals_given_form(h, w, kind):
    """Seeds at their cells (no position planes) give what the explicit
    (row, col) planes give, through the wrapper on the CPU."""
    slot, _, _ = _grid_case(h, w, kind)
    at = cell_positions(h, w, "cpu")
    steps = trs.jfa_steps(h, w)
    kernels.reset_launches()
    got = kernels.jump_flood_grid(slot, None, None, steps)
    assert torch.equal(got, kernels.jump_flood_grid(slot, at, at, steps))
    assert torch.equal(got, kernels.jump_flood_grid_plain(slot, None, None,
                                                          steps))
    assert sum(kernels.launches().values()) == 0
    with pytest.raises(ValueError):
        kernels.jump_flood_grid(slot, at, None, steps)
    with pytest.raises(ValueError):
        kernels.jump_flood_grid(slot.long(), None, None, steps)
    # the rasters' form packs (row << 16 | col) into an i32 origin
    with pytest.raises(ValueError, match="columns"):
        kernels.jump_flood_grid(torch.full((1, 1 << 16), -1,
                                           dtype=torch.int32), None, None, [1])


def test_grid_flood_route_by_grid_size():
    """One route takes every grid size, the tiles: the wrapper's constants
    are the kernel's, and a call is one cooperative launch a 16 steps at
    every size (the rasters' schedules have at most 14), so a whole raster
    flood is one CUDA launch from 1 x 1 to the 4096 x 4096 cap."""
    design = _grid_design()
    assert (design["kTileHalo"], design["kTileMaxSteps"],
            design["kTileCells"], design["kTileAxis"]) == (
        TILE_HALO, TILE_MAX_STEPS, TILE_CELLS, TILE_AXIS)
    launches = kernels.jump_flood_grid_launches
    for g in (1, 256, 512, 640, 675, 676, 2304, 4096):
        assert len(trs.jfa_steps(g, g)) <= TILE_MAX_STEPS
        assert launches(g, g, trs.jfa_steps(g, g)) == 1
    assert launches(3, 4096, trs.jfa_steps(3, 4096)) == 1
    assert launches(2304, 2304, []) == 1
    assert launches(8, 8, [1] * 16) == 1 and launches(8, 8, [1] * 17) == 2
    assert launches(0, 8, [1]) == 0


def test_grid_flood_plan_fits_its_tiles():
    """Every step of the rasters' grids gets a tile that the kernel takes
    (at most kTileCells cells, kTileAxis a side), columns of at least 8
    adjacent cycles where a step has them, and, at the 2304² and 4096²
    rasters, a core of at least half the tile's cells."""
    for h, w in ((2304, 2304), (4096, 4096), (4096, 129), (1, 4096),
                 (640, 1152), (3, 5)):
        steps = tuple(trs.jfa_steps(h, w))
        plan = kernels.jump_flood_grid_plan(h, w, steps)
        assert len(plan) == len(steps)
        for s, (qr, tr, qc, tc) in zip(steps, plan):
            ar, ac = tile_axis(h, s, qr, tr), tile_axis(w, s, qc, tc)
            assert ar["len"] * ac["len"] <= TILE_CELLS
            assert max(ar["len"], ac["len"]) <= TILE_AXIS
            assert ac["q"] >= min(8, ac["g"])
            if h == w and h >= 2304:
                assert ar["t"] * ar["q"] * ac["t"] * ac["q"] >= (
                    ar["len"] * ac["len"] // 2), (s, ar, ac)


def _dilate_design():
    """(core rows, core columns, passes a launch) of ``csrc/dilate.cu``."""
    text = (build.CSRC / "dilate.cu").read_text()

    def num(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    return num("kCoreH"), num("kCoreW"), num("kPasses")


def _dilate_tile_model(kimg, radius, p22, p23, coef, short=0):
    """The dilation kernel's design in plain torch: launches of up to
    kPasses passes; in each, tiles of a core plus a halo of 3 pixels a pass
    held as one flat span with a row and a pixel of empty keys before and
    after it, a step reading pixel p's source at p - (dy * span width + dx)
    (a source beyond the span's side is the next or previous row's pixel,
    as in the kernel), sources outside the image holding the empty key and
    targets outside it the least int, r^2 computed once a pixel from its key
    and carried with it, a tile with no key in its span written empty at
    once, a tile stopped after a pass that changed nothing; between launches
    keys and offsets (left unwritten by an empty tile), the last launch keys
    only.  ``short`` takes that many pixels off the halo, as a broken
    kernel would.  Returns (keys, {"tiles", "empty", "stopped", "passes"}).
    """
    ch, cw, per = _dilate_design()
    halo = 3 * per - short
    sh, sw = ch + 2 * halo, cw + 2 * halo
    area, pad = sh * sw, sw + 1
    h, w = kimg.shape
    key, off = kimg.clone(), torch.zeros((2, h, w), dtype=torch.int32)
    stats = dict.fromkeys(("tiles", "empty", "stopped", "passes"), 0)
    n_launch = -(-radius // per)
    for launch in range(n_launch):
        passes = radius - per * launch if launch == n_launch - 1 else per
        new_key = torch.full_like(key, -1)
        # an empty tile leaves its offsets as they were: never read
        new_off = torch.full_like(off, 0x5A5A5A5A)
        for r0 in range(-halo, h - halo, ch):
            for c0 in range(-halo, w - halo, cw):
                rows = torch.arange(r0, r0 + sh)
                cols = torch.arange(c0, c0 + sw)
                live = (((rows >= 0) & (rows < h))[:, None]
                        & ((cols >= 0) & (cols < w))[None, :]).reshape(-1)
                rr, cc = rows.clamp(0, h - 1), cols.clamp(0, w - 1)

                def flat(plane, fill):
                    v = torch.where(live, plane[rr][:, cc].reshape(-1), fill)
                    return torch.cat([torch.full((pad,), fill, dtype=v.dtype),
                                      v, torch.full((pad,), fill,
                                                    dtype=v.dtype)])
                k, sdx, sdy = flat(key, IBIG), flat(off[0], 0), flat(off[1], 0)
                rd = radius_from_key(k, p22, p23, coef)
                r2 = torch.where(k != IBIG, rd * rd, 0.0)
                span = slice(pad, pad + area)
                own = torch.where(live, k[span], -IBIG - 1)
                busy = bool((k != IBIG).any())
                stats["tiles"] += 1
                stats["empty"] += not busy
                for p in range(passes if busy else 0):
                    changed = False
                    for dy, dx in DIRECTIONS:
                        s0 = pad - (dy * sw + dx)
                        src = slice(s0, s0 + area)
                        # every source read before any write, as the
                        # kernel's barrier orders them
                        ck, cr2 = k[src].clone(), r2[src].clone()
                        cdx, cdy = sdx[src] + dx, sdy[src] + dy
                        fx, fy = cdx.float(), cdy.float()
                        better = (ck < own) & (fx * fx + fy * fy <= cr2)
                        own = torch.where(better, ck, own)
                        k[span] = torch.where(better, ck, k[span])
                        r2[span] = torch.where(better, cr2, r2[span])
                        sdx[span] = torch.where(better, cdx, sdx[span])
                        sdy[span] = torch.where(better, cdy, sdy[span])
                        changed |= bool(better.any())
                    stats["passes"] += 1
                    if not changed:
                        stats["stopped"] += p < passes - 1
                        break
                ro, co = r0 + halo, c0 + halo
                hh, ww = min(ch, h - ro), min(cw, w - co)
                core = (slice(halo, halo + hh), slice(halo, halo + ww))
                new_key[ro:ro + hh, co:co + ww] = own.reshape(sh, sw)[core]
                if busy:
                    for i, d in enumerate((sdx, sdy)):
                        new_off[i, ro:ro + hh, co:co + ww] = \
                            d[span].reshape(sh, sw)[core]
        assert bool((new_key != -1).all())          # every pixel written
        key, off = new_key, new_off
    return key, stats


def _tile_edge_keys(h, w, seed):
    """Raw keys at the render defaults: far points (splat radius under 1
    px) everywhere, near ones (9-29 px) on the image's border rows and
    columns and within a halo's width of the dilation tiles' edges."""
    ch, cw, per = _dilate_design()
    rng = np.random.default_rng(seed)
    kimg = np.full((h, w), IBIG, np.int64)
    band = np.arange(-3 * per - 1, 3 * per + 1)     # a halo either side

    def put(r, c, near):
        depth = (rng.uniform(3, 10, len(r)) if near
                 else rng.uniform(60, 150, len(r)))
        zq = ((1.00001 - 0.1 / depth) * ((1 << 23) - 1)).astype(np.int64)
        np.minimum.at(kimg, (r, c), (zq << 8) | rng.integers(0, 256, len(r)))

    n = max(1, h * w // 30)
    put(rng.integers(0, h, n), rng.integers(0, w, n), False)
    edge_r = np.unique(np.clip(np.r_[0, h - 1, ch + band], 0, h - 1))
    edge_c = np.unique(np.clip(np.r_[0, w - 1, cw + band], 0, w - 1))
    m = max(1, n // 8)
    put(rng.choice(edge_r, m), rng.integers(0, w, m), True)
    put(rng.integers(0, h, m), rng.choice(edge_c, m), True)
    return torch.from_numpy(kimg.astype(np.int32))


def _dilate_cpu_params():
    return tsplat.dilate_params(Camera.orbital(device="cpu"), RenderConfig())


@pytest.mark.parametrize("radius", [1, 3, 4, 8])
@pytest.mark.parametrize("h,w", [(1, 1), (37, 53), (63, 63), (64, 64),
                                 (65, 65), (63, 127), (64, 128), (65, 129),
                                 (129, 65)])
def test_dilate_tile_model_matches_plain(h, w, radius):
    """The tile decomposition (core, halo, carried r^2, both shortcuts, one
    to three launches) gives the plain dilation's keys bit for bit, with
    near splats on the image's borders and the tiles' edges."""
    params = _dilate_cpu_params()
    kimg = _tile_edge_keys(h, w, seed=h * w + radius)
    got, stats = _dilate_tile_model(kimg, radius, *params)
    ref = kernels.dilate_plain(kimg, radius, *params)
    assert torch.equal(got, ref)
    ch, cw, per = _dilate_design()
    assert (ch, cw, per) == (64, 64, 3)
    assert stats["tiles"] == -(-radius // per) * -(-h // ch) * -(-w // cw)
    if h * w > 1:
        assert int((ref != IBIG).sum()) > int((kimg != IBIG).sum())


@pytest.mark.parametrize("h,w", [(65, 129), (129, 65)])
def test_dilate_tile_model_needs_the_whole_halo(h, w):
    """With a halo one pixel short of 3 a pass, the stale ring (and the
    wrong reads of sources beyond the span's side) reaches the core, and
    the model no longer equals the plain dilation: the equality above
    rests on the halo arithmetic."""
    params = _dilate_cpu_params()
    kimg = _tile_edge_keys(h, w, seed=h * w + 3)
    ref = kernels.dilate_plain(kimg, 3, *params)
    assert torch.equal(_dilate_tile_model(kimg, 3, *params)[0], ref)
    assert not torch.equal(_dilate_tile_model(kimg, 3, *params, short=1)[0],
                           ref)


def test_dilate_tile_model_takes_both_shortcuts():
    """On a 2x2-tile image with near splats in one tile, far ones (radius
    under 1 px: nothing grows) in another and nothing in the other two, a
    tile with no key in its span is written empty at once and the far
    tile stops after its first pass; both equal the plain dilation."""
    params = _dilate_cpu_params()
    ch, cw, _ = _dilate_design()
    kimg = torch.full((2 * ch, 2 * cw), IBIG, dtype=torch.int32)
    kimg[:ch // 2, :cw // 2] = _tile_edge_keys(ch // 2, cw // 2, seed=3)
    rng = np.random.default_rng(4)
    zq = int((1.00001 - 0.1 / 120.0) * ((1 << 23) - 1))
    r = rng.integers(ch + ch // 4, ch + 3 * ch // 4, 40)
    c = rng.integers(cw // 4, 3 * cw // 4, 40)
    kimg[r, c] = torch.from_numpy((zq << 8) | rng.integers(0, 256, 40)
                                  ).to(torch.int32)
    for radius in (3, 4):
        got, stats = _dilate_tile_model(kimg, radius, *params)
        ref = kernels.dilate_plain(kimg, radius, *params)
        assert torch.equal(got, ref)
        assert stats["empty"] >= 2 and stats["stopped"] >= 1
        # the far splats' radius is under 1 px: they never grow
        assert torch.equal(ref[ch:, :cw], kimg[ch:, :cw])
    # one near splat in the last pixel grows up and left only, so the last
    # direction of each pass, (1, 1), changes nothing: no stop before 3
    corner = torch.full((ch, cw), IBIG, dtype=torch.int32)
    corner[-1, -1] = int(kimg[kimg != IBIG].min())
    got, stats = _dilate_tile_model(corner, 3, *params)
    ref = kernels.dilate_plain(corner, 3, *params)
    assert torch.equal(got, ref) and int((ref != IBIG).sum()) > 9
    assert stats == {"tiles": 1, "empty": 0, "stopped": 0, "passes": 3}


def _eye_dome_strip_rows():
    """Rows a warp walks in ``csrc/eye_dome.cu``."""
    text = (build.CSRC / "eye_dome.cu").read_text()
    return int(re.search(r"constexpr int kStripRows = (\d+);", text).group(1))


def _eye_dome_strip_model(color, z01, near, far, strength, ed):
    """The eye-dome kernel's design in plain torch: strips of 128 columns by
    kStripRows rows; each strip linearizes its depths and those of the rows
    above and below it and of the columns left and right of it (reads
    clamped to the image); a thread takes 4 neighbouring pixels of a row, as
    16-byte accesses where the group starts on a 16-byte boundary and W
    holds all 4, else pixel by pixel.  Returns (output, groups taken by
    vector, groups taken by scalar)."""
    rows = _eye_dome_strip_rows()
    n2, fpn, fmn, s = eye_dome_constants(near, far, strength)
    h, w = z01.shape
    out = torch.full_like(color, float("nan"))
    edv = torch.tensor(ed, dtype=torch.float32)
    n_vec = n_scalar = 0
    for row0 in range(0, h, rows):
        for col0 in range(0, w, 128):
            rr = torch.arange(row0 - 1, row0 + rows + 1).clamp(0, h - 1)
            cc = torch.arange(col0 - 1, col0 + 129).clamp(0, w - 1)
            zt = z01[rr][:, cc]
            lin = torch.where(zt >= 1.0, 1.0,
                              torch.div(full(n2, zt), fpn - zt * fmn))
            own = lin[1:-1, 1:-1]
            m = torch.maximum(torch.maximum(lin[:-2, 1:-1], lin[2:, 1:-1]),
                              torch.maximum(lin[1:-1, :-2], lin[1:-1, 2:]))
            m = torch.minimum(torch.maximum(m, own), own + s)
            zo = zt[1:-1, 1:-1]
            alpha = torch.where(zo < 1.0, torch.div(m - own, full(s, zo)),
                                0.0)[..., None]
            res = color[rr[1:-1]][:, cc[1:-1]] * (1.0 - alpha) + edv * alpha
            for r in range(row0, min(row0 + rows, h)):
                for c in range(col0, min(col0 + 128, w), 4):
                    if c + 4 <= w and (r * w + c) % 4 == 0:
                        n_vec += 1
                    else:
                        n_scalar += 1
                    k = min(4, w - c)
                    assert bool(torch.isnan(out[r, c:c + k]).all())
                    out[r, c:c + k] = res[r - row0, c - col0:c - col0 + k]
    assert not bool(torch.isnan(out).any())      # every pixel written once
    return out, n_vec, n_scalar


@pytest.mark.parametrize("w", [1, 3, 5, 7, 131, 260])
def test_eye_dome_strip_model_matches_plain(w):
    """Four pixels a thread, 16-byte groups and scalar ragged tails, strips
    of 128 columns with the clamped rows and columns around them: the plain
    eye-dome bit for bit."""
    h = 19
    rng = np.random.default_rng(w)
    z01 = (0.999 + 0.001 * rng.random((h, w))).astype(np.float32)
    z01[rng.random((h, w)) < 0.3] = 1.0
    color = rng.random((h, w, 3)).astype(np.float32)
    z01, color = torch.from_numpy(z01), torch.from_numpy(color)
    args = (0.1, 1e4, 0.3 ** 6, (0.2, 0.4, 0.9))
    got, n_vec, n_scalar = _eye_dome_strip_model(color, z01, *args)
    ref = kernels.eye_dome_plain(color, z01, *args)
    assert torch.equal(got, ref)
    assert bool((ref != color).any())
    assert _eye_dome_strip_rows() == 2
    assert n_vec == sum(c + 4 <= w and (r * w + c) % 4 == 0
                        for r in range(h) for c in range(0, w, 4))
    assert (n_scalar > 0) == (w % 4 != 0)


def _cpu_inputs():
    rng = np.random.default_rng(0)
    lbl = torch.from_numpy(_labels(_blob_grid(2, 32, 3, seed=1)))
    cents = torch.from_numpy(rng.uniform(0, 9, (3, 8, 2)).astype(np.float32))
    cmask = torch.from_numpy(rng.random((3, 8)) < 0.5)
    key = torch.from_numpy(np.sort(rng.integers(0, 9, 100)).astype(np.int32))
    val = torch.from_numpy(rng.normal(size=(100, 4)).astype(np.float32))
    return lbl, cents, cmask, key, val


def test_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    lbl, cents, cmask, key, val = _cpu_inputs()
    kernels.reset_launches()
    assert torch.equal(kernels.cc_sweep(lbl, 3), kernels.cc_sweep_plain(lbl, 3))
    for a, b in zip(kernels.match_scan(cents, cmask, 1.0, 2, 16),
                    kernels.match_scan_plain(cents, cmask, 1.0, 2, 16)):
        assert torch.equal(a, b)
    assert torch.equal(kernels.segmented_cummax(key, val),
                       kernels.segmented_cummax_plain(key, val))
    assert torch.equal(kernels.segmented_cumsum(key, val, block=32),
                       kernels.segmented_cumsum_plain(key, val, block=32))
    slot, pos, cc = (torch.from_numpy(a) for a in
                     _flood_case("g16", np.random.default_rng(0)))
    assert torch.equal(kernels.jump_flood(slot, pos, cc),
                       kernels.jump_flood_plain(slot, pos, cc))
    assert torch.equal(kernels.jump_flood_grid(slot[0], pos[0], cc, [4, 2, 1]),
                       kernels.jump_flood_grid_plain(slot[0], pos[0], cc,
                                                     [4, 2, 1]))
    cols = key[:, None] % 4                                  # i32[100,1]
    assert torch.equal(kernels.take_along_axis(val, cols, 1),
                       kernels.take_along_axis_plain(val, cols, 1))
    rows = (key[:8, None] % 9).expand(8, 4).contiguous()     # i32[8,4]
    assert torch.equal(kernels.take_along_axis(val, rows, 0),
                       kernels.take_along_axis_plain(val, rows, 0))
    flat = val[:, 0].contiguous()
    assert torch.equal(kernels.take_along_axis(flat, key, None),
                       flat[key.long()])
    vor = voronoi_cases.case("mixed")
    assert torch.equal(kernels.nearest_slot(*vor, 256),
                       kernels.nearest_slot_plain(*vor, 256))
    pts = val[:, :3].contiguous()
    for a, b in zip(kernels.knn_select(pts, key > 2, 5, 16),
                    kernels.knn_select_plain(pts, key > 2, 5, 16)):
        assert torch.equal(a, b)
    assert kernels.launches() == {"cc_sweep": 0, "match_scan": 0,
                                  "segmented_cummax": 0, "dilate": 0,
                                  "eye_dome": 0, "segmented_cumsum": 0,
                                  "jump_flood": 0, "take_along_axis": 0,
                                  "jump_flood_grid": 0, "nearest_slot": 0,
                                  "knn_select": 0}


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU (plain) and CUDA (kernel) tensors are taken; nothing falls
    back for another device."""
    lbl, cents, cmask, key, val = _cpu_inputs()
    meta = [t.to("meta") for t in (lbl, cents, cmask, key, val)]
    with pytest.raises(ValueError, match="device"):
        kernels.cc_sweep(meta[0], 3)
    with pytest.raises(ValueError, match="device"):
        kernels.match_scan(meta[1], meta[2], 1.0, 2, 16)
    with pytest.raises(ValueError, match="device"):
        kernels.segmented_cummax(meta[3], meta[4])
    with pytest.raises(ValueError, match="device"):
        kernels.segmented_cumsum(meta[3], meta[4])
    slot, pos, cc = (torch.from_numpy(a).to("meta") for a in
                     _flood_case("g16", np.random.default_rng(0)))
    with pytest.raises(ValueError, match="device"):
        kernels.jump_flood(slot, pos, cc)
    with pytest.raises(ValueError, match="device"):
        kernels.jump_flood_grid(slot[0], pos[0], cc, [1])
    with pytest.raises(ValueError, match="device"):
        kernels.take_along_axis(meta[4], meta[3][:, None] % 4, 1)
    vor = voronoi_cases.case("mixed")
    with pytest.raises(ValueError, match="device"):
        kernels.nearest_slot(*(a.to("meta") for a in vor[:6]), *vor[6:],
                             256)
    with pytest.raises(ValueError, match="device"):
        kernels.knn_select(meta[4][:, :3].contiguous(), meta[3] > 2, 5, 16)
    assert sum(kernels.launches().values()) == 0


def test_wrappers_check_their_inputs():
    lbl, cents, cmask, key, val = _cpu_inputs()
    with pytest.raises(ValueError):
        kernels.cc_sweep(lbl.float(), 3)
    with pytest.raises(ValueError):
        kernels.cc_sweep(lbl, 0)
    with pytest.raises(ValueError):
        kernels.match_scan(cents, cmask[:, :4], 1.0, 2, 16)
    with pytest.raises(ValueError, match="radius"):
        kernels.match_scan(cents, cmask, 3.0e38, 2, 16)
    with pytest.raises(ValueError, match="radius"):
        kernels.match_scan(cents, cmask, float("nan"), 2, 16)
    with pytest.raises(ValueError):
        kernels.segmented_cummax(key.long(), val)
    with pytest.raises(ValueError):
        kernels.segmented_cummax(key, torch.zeros(100, 17))
    with pytest.raises(ValueError):
        kernels.segmented_cumsum(key, val, block=100)  # not a power of two
    with pytest.raises(ValueError):
        kernels.segmented_cumsum(key, val, block=16384)
    with pytest.raises(ValueError):
        kernels.segmented_cumsum(key, val.double())
    slot, pos, cc = (torch.from_numpy(a) for a in
                     _flood_case("g16", np.random.default_rng(0)))
    with pytest.raises(ValueError):
        kernels.jump_flood(slot[:, :, :8], pos, cc)
    with pytest.raises(ValueError):
        kernels.jump_flood(slot, pos[..., :1], cc)
    with pytest.raises(ValueError):
        kernels.jump_flood(slot.long(), pos, cc)
    for bad in [(val, key[:, None].long() % 4, 1),     # i64 indices
                (val.double(), key[:, None] % 4, 1),   # f64 table
                (val, key[:8, None] % 4, 1),           # rows differ
                (val, key[:, None] % 4, 0),            # columns differ
                (val, key[:, None] % 4, 2),            # no such axis
                (val, key, None)]:                     # 2-D table, no axis
        with pytest.raises(ValueError):
            kernels.take_along_axis(*bad)


def test_build_targets_hopper_without_fma_contraction(monkeypatch, tmp_path):
    flags = build.NVCC_FLAGS
    assert "-gencode=arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert not any("fast_math" in f for f in flags)
    names = {p.name for p in build.sources()}
    assert {"cc_sweep.cu", "match_scan.cu", "seg_cummax.cu", "dilate.cu",
            "eye_dome.cu", "seg_cumsum.cu", "jump_flood.cu",
            "take_along.cu", "nearest_slot.cu", "knn_select.cu"} <= names
    assert "tools/probe_extract.py::try_kernel" in (
        build.CSRC / "take_along.cu").read_text()
    # the two step kernels and the flood run as one thread-block cluster
    # launch each
    for src in ("cc_sweep.cu", "match_scan.cu", "jump_flood.cu"):
        text = (build.CSRC / src).read_text()
        assert "cudaLaunchAttributeClusterDimension" in text
        assert "map_shared_rank" in text and "cudaLaunchKernelEx" in text
    # every kernel source names the TPU kernel it replaces
    for src, tpu in [("cc_sweep.cu", "_cc_sweep_kernel"),
                     ("match_scan.cu", "_match_kernel"),
                     ("seg_cummax.cu", "_seg_cummax_kernel"),
                     ("dilate.cu", "_dilate_kernel"),
                     ("eye_dome.cu", "_eye_dome_kernel"),
                     ("seg_cumsum.cu", "_seg_cumsum_kernel"),
                     ("jump_flood.cu", "_jfa_kernel")]:
        assert f"pallas_kernels.py::{tpu}" in (build.CSRC / src).read_text()
    cmd = build.nvcc_command(tmp_path / "lib.so")
    assert cmd[0] == "nvcc" and str(tmp_path / "lib.so") in cmd
    # without a CUDA toolkit the build raises instead of falling back
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os, "access", lambda p, m: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


def _c_entry_points():
    """``{name: [parameter type, ...]}`` of every ``extern "C" int treee_*``
    function in the kernel sources."""
    out = {}
    for src in build.sources():
        for name, params in re.findall(r'extern "C" int (treee_\w+)\(([^)]*)\)',
                                       src.read_text()):
            out[name] = [" ".join(p.split()[:-1]) for p in params.split(",")
                         if p.strip()]
    return out


def test_packed_launchers_match_their_c_signatures():
    """``build.launch`` packs each launching entry point's arguments by the
    ctypes types of ``build.LAUNCHERS``; those must be the C parameters' in
    order, every entry point that takes a stream must be listed, and each
    must have its ``_packed`` twin."""
    codes = {"int": "i", "float": "f", "long long": "q"}
    entries = {n: t for n, t in _c_entry_points().items()
               if t and t[-1] == "cudaStream_t"}
    assert set(entries) == set(build.LAUNCHERS)
    text = "".join(s.read_text() for s in build.sources())
    for name, types in entries.items():
        want = "".join("P" if "*" in t or t == "cudaStream_t" else codes[t]
                       for t in types)
        got = "".join(build._STRUCT_CODES[t] for t in build.LAUNCHERS[name])
        assert got == want, name
        assert f"TREEE_PACKED({name})" in text, name


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_packed_call_reads_what_launch_packs(tmp_path):
    """``csrc/packed.cuh`` unpacks a buffer from ``build.packer`` into the
    typed call, across the alignment gaps between 4- and 8-byte members."""
    src = tmp_path / "probe.cc"
    src.write_text(f'#include "{build.CSRC / "packed.cuh"}"\n' + r"""
#include <cstdint>
#include <cstring>
extern "C" int treee_probe(long long* out, const uint8_t* p, int a,
                           float f, long long n, void* q) {
  out[0] = reinterpret_cast<long long>(p);
  out[1] = a;
  std::memcpy(out + 2, &f, sizeof f);
  out[3] = n;
  out[4] = reinterpret_cast<long long>(q);
  return a + 1;
}
TREEE_PACKED(treee_probe)
""")
    lib_path = tmp_path / "libprobe.so"
    subprocess.run(["g++", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    out = np.zeros(5, np.int64)
    args = (out.ctypes.data, 0x7F00_1234_5678, -7, 0.1, 15_000_576_123,
            0x7F00_0000_0010)
    assert lib.treee_probe_packed(build.packer([p, p, i, f, ll, p])(*args)) == -6
    assert out[0] == args[1] and out[1] == -7 and out[3] == args[4]
    assert out[2:3].view(np.float32)[0] == np.float32(0.1)
    assert out[4] == args[5]
