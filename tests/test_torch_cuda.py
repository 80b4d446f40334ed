"""The port's CUDA kernels against their plain versions, on a CUDA card.

Edge shapes that the main path's own shapes do not reach: CC grids ragged
over the cluster's 8 CTAs, grids beyond G=480 whose rows the kernel sweeps in
device memory, more bands than the card holds clusters at once, bands at
their fixpoint, still changing at the last sweep, empty or full; match
capacities that are no multiple of the cluster's CTAs or threads, exact
distance ties between slots in different CTAs, no active slot, one cluster,
more new clusters than free slots; gathers at the Mosaic probe's shapes and
from tables larger than shared memory; cummax lengths around its
tile sizes, every width, runs over hundreds of tiles and runs that end on tile
edges, signed zeros and NaNs, repeated calls, a side stream and unaligned
views (for the scans and both frame kernels), key images at and around the
dilation's 64x64 cores, dense and sparse 720p images, dilation radii across
the kernel's pass groups and over hundreds of launches, splats on the
image edges and empty images, the dilation's two shortcuts, eye-dome widths
that are no multiple of 4, cumsum lengths around the block size, runs across hundreds
of blocks, every block size class and widths beyond shared memory, jump-flood grids of 1 to 384 cells a side with
no seed or a seed in every cell, and 64 busy bands on both sides of its
shared-memory route's edge with duplicate slots and exact ties; the
rasters' grid flood at H != W, H or W of 1, 127, 129 and 4096, wrapped
sources on the far edge, empty and full grids and steps longer than an
axis, with the wrapper's plan and with small tiles, with seeds at their
cells and with given positions, and the CUDA launches a call it makes; the
occupied-cell Voronoi with exact ties, duplicate slots, bands without an
active slot, slots past one stage, G of 64 to 480, padding rows, rows in
no order, and on the bench stand's step; the brute-force k-NN's selection
at row counts ragged over its tiles and chunks, a snug buffer with an
invalid tail and exact copies across tiles, at k of 1 to 64, and its
refusal of k past 64; a launch that CUDA refuses.  Each
output must equal the plain
version's bit for bit, and each call must count the launches its design
makes: one, or ceil(radius / passes per launch) for the dilation.  The
segmentation and the inventory must repeat bit for bit on the card, and
the card's frame must match the CPU's; the rasters and the height above
ground must repeat and equal the CPU's bit for bit.  The point-sharded
step over four shards of the card, three of them all padding, must equal
the card's one-device step bit for bit, and a tile of one point must go
through the tiles with and without a mesh alike.  The LOD and adaptive cuts
over 2 and 8 shards of the card (nodes across shard edges, a shard of
padding) and a pick tie across a shard edge must equal the card's
one-device results.

Needs a card, so it skips on a machine without one.  On the card, where JAX
is absent, run it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes
import time

import numpy as np
import pytest
import torch

from treee_tpu_torch import characteristics as tch
from treee_tpu_torch import config as tconfig
from treee_tpu_torch import pipeline as tpl
from treee_tpu_torch import rasters as trs
from treee_tpu_torch import segmentation as tsg
from treee_tpu_torch.io import las as tlas
from treee_tpu_torch.ops import eigen as teig
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.ops import neighbors as tnb
from treee_tpu_torch.ops import octree as toctree
from treee_tpu_torch.ops.kernels import build
from treee_tpu_torch.ops.kernels.jump_flood import cell_positions
from treee_tpu_torch.parallel import sharding as tsh
from treee_tpu_torch.parallel import tiles as ttiles
from treee_tpu_torch.render import Camera
from treee_tpu_torch.render import splat

import torch_threads
import voronoi_cases

torch_threads.share_cores()

pytestmark = pytest.mark.cuda
IBIG = 0x7FFFFFFF
# segments of the bench stand (937 trees, seed 0) at 0.75 m
NEAREST_SLOT_STAND_SEGMENTS = 1005


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.reset_launches()
    return torch.device("cuda")


def _same(got, ref):
    got, ref = (got if isinstance(got, tuple) else (got,),
                ref if isinstance(ref, tuple) else (ref,))
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)


@pytest.mark.parametrize("b,g,sweeps,fill", [
    (3, 64, 8, 0.3), (2, 100, 13, 0.5), (1, 7, 1, 0.9), (4, 130, 64, 0.2),
    (2, 384, 17, 1.0), (2, 1, 1, 1.0), (3, 7, 13, 0.7), (2, 100, 64, 0.6),
    (2, 383, 1, 0.6), (2, 383, 64, 0.6), (3, 384, 13, 0.55),
    (200, 384, 64, 0.6), (2, 480, 64, 0.6), (2, 481, 13, 0.6),
    (1, 675, 5, 0.6), (2, 676, 64, 0.6), (3, 1024, 13, 1.0),
    (40, 768, 64, 0.6),
])
def test_cc_sweep_kernel_equals_plain(dev, b, g, sweeps, fill):
    rng = np.random.default_rng(g + sweeps)
    occ = rng.random((b, g, g)) < fill
    lbl = np.where(occ, np.arange(g * g, dtype=np.int32).reshape(1, g, g), IBIG)
    lbl = torch.from_numpy(lbl.astype(np.int32)).to(dev)
    _same(kernels.cc_sweep(lbl, sweeps), kernels.cc_sweep_plain(lbl, sweeps))
    assert kernels.cc_sweep.launches == 1


@pytest.mark.parametrize("g,sweeps", [(7, 1), (100, 13), (384, 64),
                                     (700, 64)])
def test_cc_sweep_kernel_stops_exactly(dev, g, sweeps):
    """Bands at their fixpoint from the start, still changing at the last
    sweep (a corridor longer than the sweeps), empty and full: the early
    exit must give exactly the output of `sweeps` sweeps."""
    occ = torch.zeros((4, g, g), dtype=torch.bool)
    occ[1, ::4] = True
    for k, row in enumerate(range(0, g - 4, 4)):
        occ[1, row:row + 5, 0 if k % 2 == 0 else g - 1] = True
    occ[3] = True
    idx = torch.arange(g * g, dtype=torch.int32).view(g, g)
    lbl = torch.where(occ, g * g - 1 - idx, IBIG).to(torch.int32)
    rng = np.random.default_rng(g)
    blobs = torch.from_numpy(rng.random((g, g)) < 0.3)  # no percolation
    lbl[0] = kernels.cc_sweep_plain(torch.where(blobs, idx, IBIG)[None],
                                    4 * g)[0]       # a fixpoint already
    lbl = lbl.to(dev)
    assert torch.equal(kernels.cc_sweep_plain(lbl[:1], 1), lbl[:1])
    _same(kernels.cc_sweep(lbl, sweeps), kernels.cc_sweep_plain(lbl, sweeps))
    assert kernels.cc_sweep.launches == 1


@pytest.mark.parametrize("b,c_cap,t_cap,rounds,box", [
    (6, 32, 64, 4, 50.0), (5, 16, 8, 4, 4.0), (64, 256, 2048, 4, 200.0),
    (3, 300, 1500, 2, 8.0), (2, 1, 1, 0, 1.0), (5, 40, 1, 4, 3.0),
    (5, 40, 7, 4, 3.0), (8, 256, 2049, 4, 60.0), (4, 1, 16, 4, 2.0),
    (3, 64, 40, 4, 6.0),
])
def test_match_scan_kernel_equals_plain(dev, b, c_cap, t_cap, rounds, box):
    rng = np.random.default_rng(c_cap + t_cap)
    # integer positions in small boxes give exact distance ties
    cents = rng.integers(0, int(box), (b, c_cap, 2)).astype(np.float32)
    cents += (rng.random((b, c_cap, 1)) < 0.5) * rng.normal(0, 0.3, (b, c_cap, 2)
                                                            ).astype(np.float32)
    cmask = rng.random((b, c_cap)) < 0.6
    cents = torch.from_numpy(cents.astype(np.float32)).to(dev)
    cmask = torch.from_numpy(cmask).to(dev)
    _same(kernels.match_scan(cents, cmask, 1.5, rounds, t_cap),
          kernels.match_scan_plain(cents, cmask, 1.5, rounds, t_cap))
    assert kernels.match_scan.launches == 1


def test_match_scan_kernel_ties_across_ctas(dev):
    """Band 0 puts 256 clusters on slots 0-255, among them twins: slot 3 and
    slot 250 at one point, slot 5 and slot 240 mirrored about another.  The
    active slots are split over the cluster's CTAs by count, so each twin
    pair lies in two CTAs.  Band 1's clusters sit at the twins' common point
    and at the mirror's centre: exact ties in distance, which the lower slot
    must win.  No active slot in band 0's matching, nothing at all in band
    2, and band 3 holds more new clusters than there are free slots."""
    t_cap, c_cap = 300, 256
    cents = np.zeros((4, c_cap, 2), np.float32)
    cmask = np.zeros((4, c_cap), bool)
    cents[0] = np.stack([np.arange(c_cap) * 10.0, np.zeros(c_cap)], -1)
    cents[0, 250] = cents[0, 3]
    cents[0, 5] = (1000.0, 500.0)
    cents[0, 240] = (1002.0, 500.0)
    cmask[0] = True
    cents[1, 0] = cents[0, 3] + (0.5, 0.0)
    cents[1, 1] = (1001.0, 500.0)
    cmask[1, :2] = True
    cents[3] = np.stack([np.arange(c_cap) * 10.0 + 5000.0,
                         np.ones(c_cap)], -1)
    cmask[3] = True
    cents, cmask = torch.from_numpy(cents).to(dev), torch.from_numpy(cmask).to(dev)
    got = kernels.match_scan(cents, cmask, 1.5, 4, t_cap)
    ref = kernels.match_scan_plain(cents, cmask, 1.5, 4, t_cap)
    _same(got, ref)
    pos = got[0][1].cpu()
    assert tuple(pos[3].tolist()) == (30.5, 0.0)      # slot 3 beat slot 250
    assert tuple(pos[250].tolist()) == (30.0, 0.0)
    assert tuple(pos[5].tolist()) == (1001.0, 500.0)  # slot 5 beat slot 240
    assert int(got[2]) == t_cap and bool(got[1][3].all())
    assert kernels.match_scan.launches == 1


@pytest.mark.parametrize("shape,hi,axis", [
    ((8, 128), 8, 0), ((256, 128), 256, 0), ((8, 128), 128, 1),
    ((128,), 128, None),                       # the probe's four shapes
    ((100_000,), 100_000, None),               # tables beyond 48 KB of
    ((3, 5000), 5000, 1), ((2000, 50), 2000, 0),   # shared memory
    ((1, 1), 1, 0), ((1,), 1, None),
])
def test_take_along_axis_kernel_equals_plain(dev, shape, hi, axis):
    gen = torch.Generator(device=dev).manual_seed(hi)
    tab = torch.rand(shape, device=dev, generator=gen)
    if axis is None:
        ishape = (8, 128) if shape == (128,) else (1000, 37)
    elif axis == 0:
        ishape = (shape[0] if shape[0] <= 256 else 300, shape[1])
    else:
        ishape = (shape[0], 128 if shape[1] == 128 else 700)
    idx = torch.randint(0, hi, ishape, device=dev, generator=gen,
                        dtype=torch.int32)
    _same(kernels.take_along_axis(tab, idx, axis),
          kernels.take_along_axis_plain(tab, idx, axis))
    assert kernels.take_along_axis.launches == 1


def _cummax_rows(c):
    """Rows of one tile of the cummax kernel at width c."""
    return 256 * (16 if c <= 2 else 8 if c <= 4 else 4)


def _scan_keys(kind, n, period, dev, gen):
    """Sorted i32[n] keys: ``kind`` an int (that many random keys, from -5
    up), "one_run", "distinct", "edges" (runs of exactly ``period`` rows, so
    every run ends on a tile or block edge) or "long" (a run over the middle
    80% of the rows between short ones)."""
    if kind == "one_run":
        return torch.full((n,), 7, device=dev, dtype=torch.int32)
    i = torch.arange(n, device=dev, dtype=torch.int32)
    if kind == "distinct":
        return i - 5
    if kind == "edges":
        return torch.div(i, period, rounding_mode="floor").to(torch.int32)
    if kind == "long":
        return torch.where(i < n // 10, i // 3,
                           torch.where(i < n - n // 10, n, n + i // 5)
                           ).to(torch.int32)
    return torch.sort(torch.randint(-5, kind - 5, (n,), device=dev,
                                    generator=gen, dtype=torch.int32)).values


@pytest.mark.parametrize("n,c,kind", [
    (1, 1, 1), (4095, 8, 3), (4097, 1, 4097), (100_000, 12, 37),
    (5_000_000, 3, 1), (3_000_000, 16, 200_000), (20_000_000, 1, 9),
    (1023, 5, 2), (1024, 8, "one_run"), (1025, 8, "distinct"),
    (2047, 3, 4), (2048, 4, "edges"), (2049, 4, 7), (4096, 2, "edges"),
    (8191, 1, "distinct"), (8193, 2, "one_run"), (3, 7, 2), (5, 16, "distinct"),
    (40_960, 6, "edges"), (40_961, 9, "edges"), (1_000_001, 7, 1000),
    (1_000_003, 10, "long"), (1_000_000, 11, 50), (999_999, 13, 3),
    (500_000, 14, "distinct"), (500_001, 15, "one_run"),
    (400 * 1024 + 17, 8, "one_run"), (400 * 1024 + 17, 12, "long"),
    (400 * 4096 + 5, 1, "long"), (350 * 2048, 4, "one_run"),
    (2_000_000, 8, "distinct"), (2_000_000, 2, "distinct"),
])
def test_segmented_cummax_kernel_equals_plain(dev, n, c, kind):
    """Lengths around the tile size (1024, 2048 or 4096 rows by width),
    every width, one run over everything and over 300 tiles and more, all
    keys distinct, runs that end exactly on tile edges."""
    gen = torch.Generator(device=dev).manual_seed(n + c)
    key = _scan_keys(kind, n, _cummax_rows(c), dev, gen)
    shape = (n,) if c == 1 else (n, c)
    val = torch.randn(shape, device=dev, generator=gen) * 100
    _same(kernels.segmented_cummax(key, val),
          kernels.segmented_cummax_plain(key, val))
    assert kernels.segmented_cummax.launches == 1


@pytest.mark.parametrize("c", [1, 3, 8])
def test_segmented_cummax_kernel_zeros_and_nans(dev, c):
    """Mixed +0.0, -0.0, NaNs of several payloads and infinities: the bits
    must be the plain version's, whose max does not depend on the order of
    combination (+0.0 over -0.0; the NaN 0x7FC00000 from a run's first NaN
    on)."""
    n = 300_000
    gen = torch.Generator(device=dev).manual_seed(c)
    key = _scan_keys(2000, n, 0, dev, gen)
    pick = torch.randint(0, 8, (n, c), device=dev, generator=gen)
    bits = torch.tensor([0, -0x80000000, 0x7FC00000, -0x400000 + 2,
                         0x7F800001, -0x800000, 0x7F800000, 0x3F800000],
                        dtype=torch.int32, device=dev)
    special = bits[pick].view(torch.float32)
    below = -1.0 - torch.rand((n, c), device=dev, generator=gen)
    val = torch.where(torch.rand((n, c), device=dev, generator=gen) < 0.02,
                      special, below)
    if c == 1:
        val = val[:, 0].contiguous()
    got = kernels.segmented_cummax(key, val)
    ref = kernels.segmented_cummax_plain(key, val)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    g = got.view(torch.int32)
    assert bool((g == 0).any()) and bool((g == 0x7FC00000).any())
    assert bool((g == -0x80000000).any())
    # a NaN comes out as 0x7FC00000 and nothing else
    assert bool((g[torch.isnan(got)] == 0x7FC00000).all())


def test_scans_repeat_on_any_stream_and_view(dev):
    """Two calls in a row on one stream (each must clear its own tile
    counter and statuses), a non-default stream, and inputs that are views
    starting off a 16-byte boundary."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 1_500_000
    key = _scan_keys("long", n + 1, 0, dev, gen)
    val = torch.randn((n + 1, 6), device=dev, generator=gen)
    ref_max = kernels.segmented_cummax_plain(key, val)
    ref_sum = kernels.segmented_cumsum_plain(key, val)
    for _ in range(3):
        got = (kernels.segmented_cummax(key, val),
               kernels.segmented_cumsum(key, val))
    _same(got, (ref_max, ref_sum))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [(kernels.segmented_cummax(key, val),
                kernels.segmented_cumsum(key, val)) for _ in range(2)][-1]
    side.synchronize()
    _same(got, (ref_max, ref_sum))
    k1, v1 = key[1:], val[1:, 0]                 # 4 bytes past a boundary
    assert k1.data_ptr() % 16 and k1.is_contiguous()
    _same(kernels.segmented_cummax(k1, v1),
          kernels.segmented_cummax_plain(k1, v1))
    _same(kernels.segmented_cumsum(k1, v1),
          kernels.segmented_cumsum_plain(k1, v1))
    assert kernels.segmented_cummax.launches == 6
    assert kernels.segmented_cumsum.launches == 6


@pytest.mark.parametrize("n,c,block,kind", [
    (0, 3, 8192, 1), (1, 1, 8192, 1), (8191, 3, 8192, 4), (8192, 2, 8192, 4),
    (8193, 3, 8192, 4), (255, 1, 256, 3), (257, 2, 256, 3),
    (3_000_000, 3, 8192, 1), (1_000_000, 1, 256, 1), (500_000, 2, 256, 9000),
    (2_000_000, 6, 8192, 300), (1_000_000, 16, 8192, 50),
    (8192, 6, 8192, "one_run"), (8193, 6, 8192, "distinct"),
    (16_384, 3, 8192, "edges"), (16_385, 2, 8192, "edges"),
    (24_577, 6, 8192, "one_run"), (100_000, 4, 8192, "distinct"),
    (100_000, 5, 8192, 11), (100_001, 7, 8192, "long"),
    (100_000, 8, 8192, "one_run"), (50_000, 12, 8192, 20),
    (310 * 8192 + 3, 3, 8192, "one_run"), (310 * 8192 + 3, 6, 8192, "long"),
    (3_000_000, 2, 8192, "long"), (1_000_000, 3, 8192, "distinct"),
    (200_000, 3, 1024, "long"), (200_001, 6, 2048, "edges"),
    (300_000, 2, 4096, "one_run"), (65_537, 3, 512, "long"),
    (10_000, 16, 64, 30), (5_000, 3, 16, "long"), (1_000, 2, 4, "one_run"),
    (1_000, 3, 2, 40), (777, 5, 1, 40), (4_000, 1, 32, "edges"),
])
def test_segmented_cumsum_kernel_equals_plain(dev, n, c, block, kind):
    """Lengths around the block size, every block size class (one row a
    thread, several, fewer rows than a warp), widths that fit shared memory
    whole and widths that go in windows, one run over 300 blocks and more,
    all keys distinct, runs that end exactly on block edges."""
    gen = torch.Generator(device=dev).manual_seed(n + c + block)
    key = _scan_keys(kind, n, block, dev, gen)
    if isinstance(kind, int):
        key = key + 5
    shape = (n,) if c == 1 else (n, c)
    val = torch.randn(shape, device=dev, generator=gen) * 100
    val[::7] = -0.0
    got = kernels.segmented_cumsum(key, val, block=block)
    _same(got, kernels.segmented_cumsum_plain(key, val, block=block))
    assert got.view(torch.int32).equal(
        kernels.segmented_cumsum_plain(key, val, block=block).view(torch.int32))
    assert kernels.segmented_cumsum.launches == (1 if n else 0)


@pytest.mark.parametrize("b,g,fill", [
    (1, 1, 1.0), (2, 2, 0.5), (1, 3, 0.0), (3, 17, 0.1), (1, 17, 1.0),
    (2, 384, 0.001), (64, 384, 0.0005), (1, 64, 0.0),
])
def test_jump_flood_kernel_equals_plain(dev, b, g, fill):
    gen = torch.Generator(device=dev).manual_seed(b * g)
    seeded = torch.rand((b, g, g), device=dev, generator=gen) < fill
    slot = torch.where(seeded, torch.randint(0, 2048, (b, g, g), device=dev,
                                             generator=gen, dtype=torch.int32),
                       -1).to(torch.int32)
    ij = torch.stack(torch.meshgrid(torch.arange(g, device=dev),
                                    torch.arange(g, device=dev),
                                    indexing="ij"), -1).float()
    pos = (ij + torch.rand((b, g, g, 2), device=dev, generator=gen)) * 0.75
    centre = (torch.arange(g, device=dev).float() + 0.5) * 0.75
    cc = torch.stack([centre[:, None].expand(g, g),
                      centre[None, :].expand(g, g)], -1)
    got = kernels.jump_flood(slot, pos, cc)
    _same(got, kernels.jump_flood_plain(slot, pos, cc))
    assert kernels.jump_flood.launches == 1
    if fill > 0.0:
        assert bool((got >= 0).all())
    else:
        assert bool((got == -1).all())


@pytest.mark.parametrize("kind", sorted(voronoi_cases.CASES))
def test_nearest_slot_kernel_equals_plain(dev, kind):
    """Equidistant and duplicate slots, bands without an active slot, all
    2048 slots active, slots no multiple of 256 or past one stage, G of 64,
    384 and 480, padding rows among the valid ones, fewer rows than
    occupied cells: the kernel gives the plain version's slots bit for bit,
    in one launch."""
    occ_idx, occ_valid, pos, act, lo, s, b, g = voronoi_cases.case(kind)
    args = tuple(t.to(dev) for t in (occ_idx, occ_valid, pos, act, lo, s))
    got = kernels.nearest_slot(*args, b, g, 256)
    assert kernels.nearest_slot.launches == 1
    _same(got, kernels.nearest_slot_plain(*args, b, g, 256))
    # and the CPU's plain version
    assert torch.equal(got.cpu(), kernels.nearest_slot_plain(
        occ_idx, occ_valid, pos, act, lo, s, b, g, 256))


def test_nearest_slot_kernel_any_row_order_stream_and_view(dev):
    """Rows in no order (each band one more pass of a tile), positions as
    a view off a 16-byte boundary, and a side stream: the same slots."""
    occ_idx, occ_valid, pos, act, lo, s, b, g = voronoi_cases.case("mixed")
    args = [t.to(dev) for t in (occ_idx, occ_valid, pos, act, lo, s)]
    ref = kernels.nearest_slot_plain(*args, b, g, 256)
    perm = torch.randperm(len(occ_idx),
                          generator=torch.Generator().manual_seed(0)).to(dev)
    shuffled = [args[0][perm], args[1][perm], *args[2:]]
    _same(kernels.nearest_slot(*shuffled, b, g, 256), ref)
    wide = torch.zeros((b, pos.shape[1] * 2 + 1, 2), device=dev)
    view = wide[:, 1:pos.shape[1] + 1]
    view.copy_(args[2])
    assert view.data_ptr() % 16 and not view.is_contiguous()
    _same(kernels.nearest_slot(args[0], args[1], view, *args[3:], b, g, 256),
          ref)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernels.nearest_slot(*args, b, g, 256)
    torch.cuda.current_stream().wait_stream(side)
    _same(got, ref)
    assert kernels.nearest_slot.launches == 3


def test_nearest_slot_kernel_on_the_15m_stand(dev, monkeypatch):
    """The bench stand (15M points, 937 trees, seed 0): the step through
    the kernel gives every point the id the plain version gives."""
    pts = tlas.synthetic_forest(n_trees=937, spacing=7.0,
                                points_per_tree=12_000,
                                ground_points=15_000_000 - 937 * 12_000,
                                seed=0)
    s = tpl.Session.from_points(pts, device=dev)
    res = s.segment(0.75)
    assert kernels.nearest_slot.launches == 1
    got = s.cloud.segment.clone()
    n_got = int(res.n_segments)
    monkeypatch.setattr(kernels, "nearest_slot", kernels.nearest_slot_plain)
    res = s.segment(0.75)
    assert int(res.n_segments) == n_got == NEAREST_SLOT_STAND_SEGMENTS
    assert torch.equal(s.cloud.segment, got)


def _busy_flood(b, g, kind, dev):
    """b bands of G=g, every band seeded: ``dups`` puts few slot ids on many
    seeds at positions anywhere in the grid; ``ties`` puts each seed on its
    cell's centre, so that distances tie exactly; ``scattered`` moves every
    cell's centre off the grid (no row shares an x), which the kernel reads
    from device memory instead of keeping a column's z."""
    rng = np.random.default_rng(g)
    n = g * g // 500
    slot = np.full((b, g, g), -1, np.int32)
    pos = np.zeros((b, g, g, 2), np.float32)
    for bi in range(b):
        cells = rng.choice(g * g, n, replace=False)
        i, j = np.divmod(cells, g)
        if kind == "dups":
            slot[bi, i, j] = rng.integers(0, 5, n)
            pos[bi, i, j] = rng.uniform(0, g * 0.75, (n, 2))
        else:
            slot[bi, i, j] = rng.permutation(2048)[:n]
            pos[bi, i, j] = np.stack([i, j], -1) * 0.75 + 0.375
    centre = (np.arange(g, dtype=np.float32) + 0.5) * np.float32(0.75)
    cc = np.stack(np.meshgrid(centre, centre, indexing="ij"), -1)
    if kind == "scattered":
        cc = cc + rng.uniform(-0.3, 0.3, cc.shape)
    return (torch.from_numpy(slot).to(dev), torch.from_numpy(pos).to(dev),
            torch.from_numpy(cc.astype(np.float32)).to(dev))


@pytest.mark.parametrize("g", [383, 384, 385, 480, 481, 512, 640])
@pytest.mark.parametrize("kind", ["dups", "ties", "scattered"])
def test_jump_flood_kernel_busy_bands_both_routes(dev, g, kind):
    """64 busy bands on either side of the shared-memory route's edge
    (G=480): one launch a call, the plain version's slots bit for bit."""
    slot, pos, cc = _busy_flood(64, g, kind, dev)
    got = kernels.jump_flood(slot, pos, cc)
    _same(got, kernels.jump_flood_plain(slot, pos, cc))
    assert kernels.jump_flood.launches == 1
    assert bool((got >= 0).all())
    assert kernels.jump_flood_route(g) == ("shared" if g <= 480 else "device")
    assert kernels.jump_flood_clusters(g) > 0


def _raster_flood(h, w, kind, dev):
    """The rasters' flood input at h x w (each seed its cell's flat index,
    seeds and centres at (row, col)) with the rasters' step list:
    ``sparse`` one cell in a hundred and one more, ``far_edge`` seeds on
    the last row and column only (each cell's nearest seed also arrives
    through the wrapped sources), ``empty`` no seed, ``full`` every cell."""
    rng = np.random.default_rng(h * 7919 + w)
    if kind == "sparse":
        have = rng.random((h, w)) < 0.01
        have[rng.integers(h), rng.integers(w)] = True
    elif kind == "far_edge":
        have = np.zeros((h, w), bool)
        have[-1, rng.integers(w, size=3)] = True
        have[rng.integers(h, size=3), -1] = True
    else:
        have = np.full((h, w), kind == "full")
    slot = np.where(have, np.arange(h * w).reshape(h, w), -1).astype(np.int32)
    ij = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1)
    at = torch.from_numpy(ij.astype(np.float32)).to(dev)
    return torch.from_numpy(slot).to(dev), at, trs.jfa_steps(h, w)


@pytest.mark.parametrize("h,w", [
    (1, 1), (1, 127), (127, 1), (1, 129), (129, 1), (127, 129), (129, 127),
    (128, 384), (512, 512), (1, 4096), (4096, 1), (4096, 129)])
@pytest.mark.parametrize("kind", ["sparse", "far_edge", "empty", "full"])
def test_jump_flood_grid_kernel_equals_plain(dev, h, w, kind):
    """The grid flood at H != W, H or W of 1, 127, 129 and 4096, wrapped
    sources on the far edge, an empty and a fully seeded grid: one call of
    the entry a flood, the plain version's slots bit for bit."""
    slot, at, steps = _raster_flood(h, w, kind, dev)
    got = kernels.jump_flood_grid(slot, at, at, steps)
    _same(got, kernels.jump_flood_grid_plain(slot, at, at, steps))
    assert kernels.jump_flood_grid.launches == 1
    assert bool((got >= 0).all()) == (kind != "empty")
    if kind == "full":
        assert torch.equal(got, slot)


@pytest.mark.parametrize("steps", [[1], [3, 5, 1000], [4096, 2, 1], []])
def test_jump_flood_grid_kernel_takes_any_steps(dev, steps):
    """Steps longer than an axis wrap modulo its size; no step leaves the
    seeds as they are.  Also 4096x4096, the largest raster, once."""
    slot, at, _ = _raster_flood(37, 211, "sparse", dev)
    _same(kernels.jump_flood_grid(slot, at, at, steps),
          kernels.jump_flood_grid_plain(slot, at, at, steps))
    if not steps:
        slot, at, steps = _raster_flood(4096, 4096, "sparse", dev)
        _same(kernels.jump_flood_grid(slot, at, at, steps),
              kernels.jump_flood_grid_plain(slot, at, at, steps))


def _grid_entry(slot, pos, cc, steps, plan=None):
    """The grid flood's C entry with ``plan`` (the wrapper's by default)."""
    h, w = slot.shape
    out = torch.empty_like(slot)
    tmp = torch.empty_like(slot)
    host_steps = (ctypes.c_int * max(1, len(steps)))(*steps)
    if plan is None:
        plan = kernels.jump_flood_grid_plan(h, w, tuple(steps))
    flat = [v for entry in plan for v in entry]
    host_tiles = (ctypes.c_int * max(1, len(flat)))(*flat)
    build.launch(build.library().treee_jump_flood_grid, "jump_flood_grid",
                 slot, slot.data_ptr(), 0 if pos is None else pos.data_ptr(),
                 0 if cc is None else cc.data_ptr(), out.data_ptr(),
                 tmp.data_ptr(), ctypes.addressof(host_steps),
                 ctypes.addressof(host_tiles), len(steps), h, w)
    return out


def _grid_kernel_launches(fn) -> int:
    """CUDA kernel launches of one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if any(k in e.key for k in ("grid_tiles<", "grid_copy")))


def _grid_form(slot, form, dev):
    """Positions of a grid flood: None (seeds at their cells), their
    (row, col) planes, or scattered positions and jittered centres."""
    h, w = slot.shape
    if form == "cells":
        return None, None
    at = cell_positions(h, w, dev)
    if form == "planes":
        return at, at
    gen = torch.Generator(device=dev).manual_seed(h * 31 + w)
    pos = at + torch.rand(at.shape, device=dev, generator=gen) * 7.0 - 3.0
    cc = at + torch.rand(at.shape, device=dev, generator=gen) * 0.8 - 0.4
    return pos, cc


@pytest.mark.parametrize("h,w", [
    (675, 675), (676, 676), (640, 726), (640, 727), (1, 29056), (1, 29057),
    (512, 512), (256, 256), (2304, 2304)])
@pytest.mark.parametrize("form", ["cells", "planes", "scattered"])
def test_jump_flood_grid_routes_at_their_edges(dev, h, w, form):
    """About the largest grids one 16-CTA cluster's shared memory would
    hold (both i32 planes, ~670 x 670 cells) and one cell past them, and
    the rasters' 256², 512² and 2304², in both forms: the wrapper gives the
    plain flood's slots bit for bit in one CUDA launch a call a 16 steps
    (two for the 17 steps of 1 x 29056), counted by torch.profiler."""
    slot, _, steps = _raster_flood(h, w, "sparse", dev)
    pos, cc = _grid_form(slot, form, dev)
    ref = kernels.jump_flood_grid_plain(slot, pos, cc, steps)
    kernels.reset_launches()
    got = kernels.jump_flood_grid(slot, pos, cc, steps)
    _same(got, ref)
    assert kernels.jump_flood_grid.launches == 1
    n = _grid_kernel_launches(lambda: kernels.jump_flood_grid(slot, pos, cc,
                                                              steps))
    assert n == kernels.jump_flood_grid_launches(h, w, steps)
    assert n == -(-len(steps) // 16)


@pytest.mark.parametrize("h,w", [
    (1, 1), (1, 129), (129, 1), (5, 300), (300, 5), (127, 129), (37, 211),
    (17, 33), (3, 4096), (3, 8300), (4096, 3)])
@pytest.mark.parametrize("kind", ["sparse", "far_edge", "empty", "full"])
@pytest.mark.parametrize("form", ["cells", "scattered"])
def test_jump_flood_grid_every_route_equals_plain(dev, h, w, kind, form):
    """Rectangular grids, axes of 1, halos wider than an axis, empty and
    full grids, in both forms, through the entry with the wrapper's plan
    and with small tiles (windows, ragged cycle groups): the plain flood's
    slots bit for bit."""
    slot, _, steps = _raster_flood(h, w, kind, dev)
    pos, cc = _grid_form(slot, form, dev)
    ref = kernels.jump_flood_grid_plain(slot, pos, cc, steps)
    _same(_grid_entry(slot, pos, cc, steps), ref)
    small = kernels.jump_flood_grid_plan(h, w, tuple(steps), 512, 64)
    _same(_grid_entry(slot, pos, cc, steps, small), ref)
    if kind == "full" and form == "cells":
        _same(ref, slot)


@pytest.mark.parametrize("steps", [[1], [3, 5, 1000], [4096, 2, 1],
                                   [211, 37, 74], [], [2, 1] * 9])
def test_jump_flood_grid_routes_take_any_steps(dev, steps):
    """Steps longer than an axis, of no cycle (a multiple of the axis),
    unsorted, none, and more than one launch takes, in both forms, each
    call in the CUDA launches its design makes (torch.profiler); and the
    4096² raster once in the cell form through the wrapper."""
    slot, _, _ = _raster_flood(37, 211, "sparse", dev)
    for form in ("cells", "scattered"):
        pos, cc = _grid_form(slot, form, dev)
        ref = kernels.jump_flood_grid_plain(slot, pos, cc, steps)
        _same(_grid_entry(slot, pos, cc, steps), ref)
        _same(kernels.jump_flood_grid(slot, pos, cc, steps), ref)
        n = _grid_kernel_launches(lambda: kernels.jump_flood_grid(
            slot, pos, cc, steps))
        assert n == kernels.jump_flood_grid_launches(37, 211, steps)
    if not steps:
        slot, _, steps = _raster_flood(4096, 4096, "sparse", dev)
        _same(kernels.jump_flood_grid(slot, None, None, steps),
              kernels.jump_flood_grid_plain(slot, None, None, steps))


def test_jump_flood_grid_entry_refuses_what_it_cannot_take(dev):
    """A plan whose tile is too large, a plan missing, one form's planes
    alone, the cell form past 2^15 rows: each raises, and the next flood
    runs as usual."""
    small, _, steps = _raster_flood(16, 24, "sparse", dev)
    with pytest.raises(RuntimeError, match="jump_flood_grid: CUDA error"):
        _grid_entry(small, None, None, steps, [(1, 16, 1, 24)] * len(steps))
    out, tmp = torch.empty_like(small), torch.empty_like(small)
    one = (ctypes.c_int * 1)(1)
    with pytest.raises(RuntimeError, match="jump_flood_grid: CUDA error"):
        build.launch(build.library().treee_jump_flood_grid,
                     "jump_flood_grid", small, small.data_ptr(), 0, 0,
                     out.data_ptr(), tmp.data_ptr(), ctypes.addressof(one),
                     0, 1, 16, 24)
    at = cell_positions(16, 24, dev)
    with pytest.raises(RuntimeError, match="jump_flood_grid: CUDA error"):
        _grid_entry(small, at, None, steps)
    tall = torch.full((1 << 15, 1), -1, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="jump_flood_grid: CUDA error"):
        _grid_entry(tall, None, None, [1], [(1, 1, 1, 1)])
    _same(kernels.jump_flood_grid(small, None, None, steps),
          kernels.jump_flood_grid_plain(small, None, None, steps))


def test_rasters_repeat_on_the_card(dev):
    """The DTM, DSM and CHM and the height above ground of a small scene:
    two card runs give the same bits, and they equal the port's CPU run
    bit for bit (integer min/max, an exact flood, elementwise f32)."""
    pts = tlas.synthetic_forest(n_trees=16, points_per_tree=2000,
                                ground_points=8000, seed=1)
    ref = tpl.Session.from_points(pts, SMALL_CFG, device="cpu")
    ref.segment(0.75)
    runs = []
    for device in ("cpu", dev, dev):
        s = tpl.Session.from_points(pts, SMALL_CFG, device=device)
        s.cloud = s.cloud.replace(
            segment=ref.cloud.segment.to(device),
            classification=ref.cloud.classification.to(device))
        kernels.reset_launches()
        grids, ll, cell = s.rasters(0.25)
        hag = s.height_above_ground().cpu()
        if device != "cpu":
            assert kernels.jump_flood_grid.launches == 2
        runs.append((grids, ll, cell, hag))
    for grids, ll, cell, hag in runs[1:]:
        assert (ll, cell) == runs[0][1:3]
        assert hag.view(torch.int32).equal(runs[0][3].view(torch.int32))
        for k, g in grids.items():
            assert g.tobytes() == runs[0][0][k].tobytes(), k


def test_wrappers_raise_on_bad_input_on_the_card(dev):
    lbl = torch.zeros(1, 8, 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.cc_sweep(lbl.float(), 2)
    with pytest.raises(ValueError):
        kernels.segmented_cummax(torch.zeros(4, dtype=torch.int32, device=dev),
                                 torch.zeros(4, 17, device=dev))
    with pytest.raises(ValueError):
        kernels.segmented_cumsum(torch.zeros(4, dtype=torch.int32, device=dev),
                                 torch.zeros(4, 3, device=dev), block=100)
    with pytest.raises(ValueError):
        kernels.jump_flood(lbl, torch.zeros(1, 8, 8, 2, device=dev),
                           torch.zeros(8, 8, 1, device=dev))
    with pytest.raises(ValueError):
        kernels.jump_flood_grid(lbl[0], torch.zeros(8, 8, 2, device=dev),
                                torch.zeros(8, 8, 2, device=dev), [2, 0])
    occ_idx, occ_valid, pos, act, lo, s, b, g = voronoi_cases.case("mixed")
    on = [t.to(dev) for t in (occ_idx, occ_valid, pos, act)]
    with pytest.raises(ValueError, match="devices"):
        kernels.nearest_slot(*on, lo, s.to(dev), b, g, 256)
    with pytest.raises(ValueError):
        kernels.nearest_slot(on[0].long(), *on[1:], lo.to(dev), s.to(dev), b,
                             g, 256)
    assert sum(kernels.launches().values()) == 0


def test_launch_helper_raises_on_a_refused_launch(dev):
    """``build.launch`` raises where CUDA refuses a launch (the flood's
    shared-memory route asked for at G=1024, which needs more shared memory
    than a block may have), and the next launch runs as usual."""
    g = 1024
    slot = torch.full((1, g, g), -1, dtype=torch.int32, device=dev)
    pos = torch.zeros((1, g, g, 2), device=dev)
    out = torch.empty_like(slot)
    with pytest.raises(RuntimeError, match="jump_flood: CUDA error"):
        build.launch(build.library().treee_jump_flood, "jump_flood", slot,
                     slot.data_ptr(), pos.data_ptr(), pos[0].data_ptr(),
                     out.data_ptr(), 0, 1, g, 1)
    slot, pos, cc = _busy_flood(2, 96, "ties", dev)
    _same(kernels.jump_flood(slot, pos, cc),
          kernels.jump_flood_plain(slot, pos, cc))
    # the grid flood's entry refuses steps without its scratch plane
    slot, at, steps = _raster_flood(16, 24, "sparse", dev)
    out = torch.empty_like(slot)
    host = (ctypes.c_int * 2)(2, 1)
    tiles = (ctypes.c_int * 8)(*[v for e in kernels.jump_flood_grid_plan(
        16, 24, (2, 1)) for v in e])
    with pytest.raises(RuntimeError, match="jump_flood_grid: CUDA error"):
        build.launch(build.library().treee_jump_flood_grid,
                     "jump_flood_grid", slot, slot.data_ptr(), at.data_ptr(),
                     at.data_ptr(), out.data_ptr(), 0, ctypes.addressof(host),
                     ctypes.addressof(tiles), 2, 16, 24)
    _same(kernels.jump_flood_grid(slot, at, at, steps),
          kernels.jump_flood_grid_plain(slot, at, at, steps))
    # the Voronoi refuses slot positions off an 8-byte boundary
    args = [a.to(dev) for a in voronoi_cases.case("mixed")[:6]]
    b, g = voronoi_cases.CASES["mixed"][:2]
    out = torch.empty((b, g, g), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="nearest_slot: CUDA error"):
        build.launch(build.library().treee_nearest_slot, "nearest_slot",
                     args[0], args[0].data_ptr(), args[1].data_ptr(),
                     args[2].data_ptr() + 4, args[3].data_ptr(),
                     args[4].data_ptr(), args[5].data_ptr(), out.data_ptr(),
                     len(args[0]), b, args[3].shape[1], g)
    _same(kernels.nearest_slot(*args, b, g, 256),
          kernels.nearest_slot_plain(*args, b, g, 256))
    tab = torch.rand(8, 128, device=dev)
    idx = torch.randint(0, 8, (8, 128), dtype=torch.int32, device=dev)
    _same(kernels.take_along_axis(tab, idx, 0),
          kernels.take_along_axis_plain(tab, idx, 0))
    # the dilation refuses 2 launches without scratch for their offsets,
    # the eye-dome a colour off a 16-byte boundary
    kimg = torch.zeros((8, 8), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="dilate: CUDA error"):
        build.launch(build.library().treee_dilate, "dilate", kimg,
                     kimg.data_ptr(), kimg.data_ptr(), 0, 0, 0, 8, 8, 4,
                     *DILATE_PARAMS, 0.5, 0)
    z = torch.zeros((8, 9), device=dev)
    with pytest.raises(RuntimeError, match="eye_dome: CUDA error"):
        build.launch(build.library().treee_eye_dome, "eye_dome", z,
                     z.data_ptr() + 4, z.data_ptr(), z.data_ptr(), 2, 2,
                     1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0)


# the dilation's constants at 720p with the default camera and point size:
# a splat's pixel radius is ~87 / its view depth in metres
DILATE_PARAMS = splat.dilate_params(Camera.orbital(device="cpu"),
                                    tconfig.RenderConfig())


def _key_image(h, w, kind, seed):
    """Raw keys: far points (radius < 1 px) and near ones (up to ~29 px);
    ``edges`` puts the near ones on the image's border rows and columns,
    ``dense`` keys every pixel, ``far`` has points 100-150 m away only
    (under 0.9 px: nothing grows), ``empty`` no key at all."""
    rng = np.random.default_rng(seed)
    kimg = np.full((h, w), IBIG, np.int64)
    if kind == "empty":
        return torch.from_numpy(kimg.astype(np.int32))
    if kind == "dense":
        depth = np.where(rng.random((h, w)) < 0.1, rng.uniform(3, 10, (h, w)),
                         rng.uniform(60, 150, (h, w)))
        zq = ((1.00001 - 0.1 / depth) * ((1 << 23) - 1)).astype(np.int64)
        return torch.from_numpy(((zq << 8) | rng.integers(0, 256, (h, w)))
                                .astype(np.int32))
    n = max(1, h * w // 20)
    depth = (rng.uniform(100, 150, n) if kind == "far" else
             np.where(rng.random(n) < 0.1, rng.uniform(3, 10, n),
                      rng.uniform(60, 150, n)))
    zq = ((1.00001 - 0.1 / depth) * ((1 << 23) - 1)).astype(np.int64)
    key = (zq << 8) | rng.integers(0, 256, n)
    r, c = rng.integers(0, h, n), rng.integers(0, w, n)
    if kind == "edges":
        side = rng.integers(0, 4, n)
        r = np.where(side == 0, 0, np.where(side == 1, h - 1, r))
        c = np.where(side == 2, 0, np.where(side == 3, w - 1, c))
    np.minimum.at(kimg, (r, c), key)
    return torch.from_numpy(kimg.astype(np.int32))


@pytest.mark.parametrize("radius", [1, 3, 8, 13])
@pytest.mark.parametrize("h,w,kind", [
    (97, 131, "mixed"), (1, 1, "mixed"), (1, 1, "empty"), (33, 65, "edges"),
    (64, 64, "edges"), (97, 131, "empty"), (720, 1280, "mixed"),
    (720, 1280, "dense"), (63, 63, "edges"), (65, 65, "edges"),
    (63, 127, "edges"), (64, 128, "edges"), (65, 129, "edges"),
    (127, 255, "mixed"), (128, 256, "edges"), (129, 257, "edges"),
    (82, 82, "mixed"), (82, 146, "mixed"), (719, 1281, "far"),
])
def test_dilate_kernel_equals_plain(dev, h, w, kind, radius):
    """Sizes at and around the kernel's 64x64 cores (and its 82x82 spans),
    the frame's 720p sparse and dense; 1 to 5 launches."""
    kimg = _key_image(h, w, kind, seed=h * w + radius).to(dev)
    got = kernels.dilate(kimg, radius, *DILATE_PARAMS)
    _same(got, kernels.dilate_plain(kimg, radius, *DILATE_PARAMS))
    per = build.library().treee_dilate_passes_per_launch()
    assert per == 3
    assert (build.library().treee_dilate_core_rows(),
            build.library().treee_dilate_core_cols()) == (64, 64)
    assert kernels.dilate.launches == -(-radius // per)
    if kind in ("mixed", "edges") and h * w > 1:
        assert int((got != IBIG).sum()) > int((kimg != IBIG).sum())


@pytest.mark.parametrize("radius", [965, 966, 1000])
def test_dilate_kernel_large_radius(dev, radius):
    """Hundreds of launches (322 to 334), keys and offsets carried from
    one to the next long after every splat has stopped growing."""
    kimg = _key_image(33, 65, "edges", seed=radius).to(dev)
    _same(kernels.dilate(kimg, radius, *DILATE_PARAMS),
          kernels.dilate_plain(kimg, radius, *DILATE_PARAMS))
    assert kernels.dilate.launches == -(-radius // 3)


def test_dilate_kernel_shortcuts(dev):
    """Both exact shortcuts on the card: an empty image's tiles all take
    the empty-tile exit; far splats (under 1 px: nothing grows) stop every
    tile after its first pass; a dense image has no empty tile."""
    from treee_tpu_torch.ops.kernels.dilate import tile_stats
    for kind, radius in (("empty", 3), ("far", 3), ("far", 8),
                         ("dense", 3)):
        kimg = _key_image(720, 1280, kind, seed=1).to(dev)
        stats = tile_stats(kimg, radius, *DILATE_PARAMS)
        launches = -(-radius // 3)
        assert stats["tiles"] == launches * 12 * 20, (kind, stats)
        if kind == "empty":
            assert stats["empty"] == stats["tiles"] and stats["passes"] == 0
        elif kind == "far":
            assert stats["empty"] == 0 and stats["passes"] == stats["tiles"]
            assert stats["stopped"] == stats["tiles"]
        else:
            assert stats["empty"] == 0
        _same(kernels.dilate(kimg, radius, *DILATE_PARAMS),
              kernels.dilate_plain(kimg, radius, *DILATE_PARAMS))


def test_frame_kernels_repeat_on_any_stream_and_view(dev):
    """Both frame kernels: repeated calls, a non-default stream, and
    inputs that are views starting off a 16-byte boundary (the eye-dome
    moves 16 bytes an access)."""
    kimg = _key_image(721, 1283, "mixed", seed=9).to(dev)
    ref_k = kernels.dilate_plain(kimg, 4, *DILATE_PARAMS)
    gen = torch.Generator(device=dev).manual_seed(9)
    z01 = torch.rand((721, 1283), device=dev, generator=gen)
    color = torch.rand((721, 1283, 3), device=dev, generator=gen)
    ed_args = (0.1, 1e4, 0.3 ** 6, (0.2, 0.4, 0.9))
    ref_e = kernels.eye_dome_plain(color, z01, *ed_args)
    for _ in range(3):
        got = (kernels.dilate(kimg, 4, *DILATE_PARAMS),
               kernels.eye_dome(color, z01, *ed_args))
    _same(got, (ref_k, ref_e))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [(kernels.dilate(kimg, 4, *DILATE_PARAMS),
                kernels.eye_dome(color, z01, *ed_args)) for _ in range(2)][-1]
    side.synchronize()
    _same(got, (ref_k, ref_e))
    flat_k = kimg.flatten()[1:][:720 * 1283].view(720, 1283)
    flat_z = z01.flatten()[1:][:720 * 1283].view(720, 1283)
    flat_c = color.flatten()[3:][:720 * 1283 * 3].view(720, 1283, 3)
    assert flat_z.data_ptr() % 16 and flat_c.data_ptr() % 16
    _same(kernels.dilate(flat_k, 4, *DILATE_PARAMS),
          kernels.dilate_plain(flat_k, 4, *DILATE_PARAMS))
    _same(kernels.eye_dome(flat_c, flat_z, *ed_args),
          kernels.eye_dome_plain(flat_c, flat_z, *ed_args))
    assert kernels.dilate.launches == 6 * 2
    assert kernels.eye_dome.launches == 6


@pytest.mark.parametrize("h,w", [(1, 1), (2, 1), (1, 7), (97, 131),
                                 (720, 1280), (3, 5), (17, 3), (16, 128),
                                 (17, 129), (33, 257), (720, 1281),
                                 (719, 1282), (720, 1284)])
def test_eye_dome_kernel_equals_plain(dev, h, w):
    gen = torch.Generator(device=dev).manual_seed(h * w)
    z01 = torch.rand((h, w), device=dev, generator=gen)
    z01 = torch.where(torch.rand((h, w), device=dev, generator=gen) < 0.3,
                      1.0, z01)
    z01[: max(1, h // 4)] = 0.999 + 0.0009 * z01[: max(1, h // 4)]
    color = torch.rand((h, w, 3), device=dev, generator=gen)
    s = 0.3 ** 6
    for ed in ((0.0, 0.0, 0.0), (0.2, 0.4, 0.9)):
        _same(kernels.eye_dome(color, z01, 0.1, 1e4, s, ed),
              kernels.eye_dome_plain(color, z01, 0.1, 1e4, s, ed))
    assert kernels.eye_dome.launches == 2


SMALL_CFG = tconfig.Config(
    segmentation=tconfig.SegmentationConfig(
        grid_size=128, max_bands=32, cc_occupied_cap=1 << 14),
    characteristics=tconfig.CharacteristicsConfig(max_slices=64),
    render=tconfig.RenderConfig(width=320, height=240))


def test_segment_ids_repeat_on_the_card(dev):
    """The centroid sums take a fixed order on the card: two runs give the
    same ids and centroids bit for bit."""
    pts = tlas.synthetic_forest(n_trees=16, points_per_tree=2000,
                                ground_points=8000, seed=1)
    runs = []
    for _ in range(2):
        s = tpl.Session.from_points(pts, SMALL_CFG, device=dev)
        runs.append(s.segment(0.75))
    a, b = runs
    assert torch.equal(a.segment, b.segment)
    assert torch.equal(a.tracked_pos, b.tracked_pos)
    # many rows to a few targets: the case float atomics reorder
    gen = torch.Generator(device=dev).manual_seed(0)
    tgt = torch.randint(0, 3, (1 << 20,), device=dev, generator=gen)
    val = torch.rand((1 << 20, 2), device=dev, generator=gen) * 1e3
    assert torch.equal(tsg._sums_by_target(tgt, val, 4),
                       tsg._sums_by_target(tgt, val, 4))


def test_frame_on_the_card_matches_the_cpu(dev):
    """A small scene's frame through Session.render on the card equals the
    port's CPU frame within 1 per channel, through both kernels."""
    pts = tlas.synthetic_forest(n_trees=16, points_per_tree=2000,
                                ground_points=8000, seed=1)
    cam = Camera.orbital(distance=60.0, device="cpu").rotate_orbital(40.0, -60.0)
    frames = []
    for device in ("cpu", dev):
        s = tpl.Session.from_points(pts, SMALL_CFG, device=device)
        s.segment(0.75)
        frames.append(s.render(cam.to(device)))
    assert kernels.dilate.launches > 0 and kernels.eye_dome.launches == 1
    diff = np.abs(frames[0].astype(int) - frames[1].astype(int))
    assert diff.max() <= 1


def test_inventory_repeats_on_the_card(dev):
    """Both inventory forms on a small scene: two runs on the card give the
    same columns bit for bit (the float sums go through the segmented
    cumsum, not float atomics), both new kernels run, and the columns agree
    with the CPU's within float rounding wherever the ids agree."""
    pts = tlas.synthetic_forest(n_trees=16, points_per_tree=2000,
                                ground_points=8000, seed=1)
    s = tpl.Session.from_points(pts, SMALL_CFG, device=dev)
    s.segment(0.75)
    for kw in (dict(), dict(axis_algo="lowhigh", method="mean",
                            symmetric=True)):
        kernels.reset_launches()
        a = s.inventory(**kw)
        assert kernels.segmented_cumsum.launches > 0
        assert kernels.segmented_cummax.launches > 0
        b = s.inventory(**kw)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        cpu = tpl.Session.from_points(pts, SMALL_CFG, device="cpu")
        cpu.segment(0.75)
        if torch.equal(cpu.cloud.segment, s.cloud.segment.cpu()):
            c = cpu.inventory(**kw)
            for k in a:
                np.testing.assert_allclose(
                    np.asarray(a[k], np.float64), np.asarray(c[k], np.float64),
                    rtol=1e-5, atol=1e-6 * np.abs(c[k]).max(initial=1.0),
                    err_msg=k)


# ---- the octree, LOD and edits: the card against the CPU ------------------------------

def _octree_clouds():
    """(pos, valid) on the host: an empty cloud, an all-padding one, one
    point, and rows that are no multiple of 1024."""
    rng = np.random.default_rng(11)
    pts = tlas.synthetic_forest(n_trees=4, points_per_tree=700,
                                ground_points=1300, seed=4)
    ragged = np.zeros((len(pts) + 333, 3), np.float32)
    ragged[:len(pts)] = pts
    return {
        "empty": (np.zeros((1024, 3), np.float32), np.zeros(1024, bool)),
        "all_padding": (rng.uniform(-5, 5, (3000, 3)).astype(np.float32),
                        np.zeros(3000, bool)),
        "one_point": (np.array([[1.5, 2.0, -3.0]], np.float32),
                      np.ones(1, bool)),
        "ragged": (ragged, np.arange(len(ragged)) < len(pts)),
    }


def _frusta():
    """Planes that cull nothing, that cull everything, and a partial view."""
    aspect = 1280 / 720
    return {
        "none": None,
        "keep_all": Camera.orbital(distance=200.0, device="cpu")
        .frustum_planes(aspect),
        "cull_all": Camera.orbital(distance=-300.0, device="cpu")
        .frustum_planes(aspect),
        "partial": Camera.orbital(distance=12.0, device="cpu")
        .rotate_orbital(120.0, -80.0).frustum_planes(aspect),
    }


@pytest.mark.parametrize("name", sorted(_octree_clouds()))
def test_octree_on_the_card_equals_the_cpu(dev, name):
    """build, lod_mask and adaptive_mask at levels 0 and 10 against every
    frustum, adaptive_counts, node tables (with overflow) and
    compact_indices with a capacity below, at and above the count: the
    card's outputs equal the CPU's bit for bit."""
    pos, valid = _octree_clouds()[name]
    trees = [toctree.build(torch.from_numpy(pos).to(d),
                           torch.from_numpy(valid).to(d))
             for d in ("cpu", dev)]
    for f in ("keys", "order", "rank", "inv", "lo", "hi"):
        assert torch.equal(getattr(trees[1], f).cpu(),
                           getattr(trees[0], f)), f
    live = torch.from_numpy(valid & (np.arange(len(valid)) % 5 != 0))
    cam_pos = torch.tensor([3.0, 20.0, 40.0])
    for planes in _frusta().values():
        for level in (0, 10):
            got = toctree.lod_mask(trees[1], level, 2, live.to(dev), planes)
            ref = toctree.lod_mask(trees[0], level, 2, live, planes)
            assert torch.equal(got.cpu(), ref)
        for tau in (0.75, 2.0, 8.0):
            got = toctree.adaptive_mask(trees[1], cam_pos, 1086.0, tau,
                                        live=live.to(dev), frustum=planes)
            ref = toctree.adaptive_mask(trees[0], cam_pos, 1086.0, tau,
                                        live=live, frustum=planes)
            assert torch.equal(got.cpu(), ref)
        taus = tpl.Session.TAU_LADDER
        assert torch.equal(
            toctree.adaptive_counts(trees[1], cam_pos, 1086.0, taus,
                                    live=live.to(dev), frustum=planes).cpu(),
            toctree.adaptive_counts(trees[0], cam_pos, 1086.0, taus,
                                    live=live, frustum=planes))
    for level in (0, 5, 10):
        for max_nodes in (1, 7, 4096):
            got = toctree.node_table(trees[1], level, max_nodes)
            ref = toctree.node_table(trees[0], level, max_nodes)
            for f in ("prefix", "start", "count", "n"):
                assert torch.equal(getattr(got, f).cpu(), getattr(ref, f))
            for g, r in zip(toctree.node_bounds(got, trees[1], level),
                            toctree.node_bounds(ref, trees[0], level)):
                assert torch.equal(g.cpu(), r)
    mask = toctree.lod_mask(trees[0], 10, live=live)
    k = int(mask.sum())
    for cap in sorted({max(k - 3, 1), max(k, 1), k + 1, len(valid) + 9}):
        got = toctree.compact_indices(mask.to(dev), cap)
        ref = toctree.compact_indices(mask, cap)
        assert all(torch.equal(g.cpu(), r) for g, r in zip(got, ref))
        assert torch.equal(toctree._compact_indices_scatter(mask.to(dev),
                                                            cap)[1].cpu(),
                           ref[1])


def test_interactive_session_runs_on_the_card(dev):
    """Every new Session entry point, given host inputs (a CPU camera, a
    CPU prop, numpy centres), computes on the card: its state stays there,
    each frame launches both frame kernels, the recomputed table launches
    the cummax; and its results equal the CPU session's from the same ids
    (frames within 1 per channel, pick's distance within rtol 1e-5)."""
    pts = tlas.synthetic_forest(n_trees=16, points_per_tree=2000,
                                ground_points=8000, seed=1)
    cam = Camera.orbital(distance=60.0, device="cpu").rotate_orbital(40.0,
                                                                     -60.0)
    ref = tpl.Session.from_points(pts, SMALL_CFG, device="cpu")
    ref.segment(0.75)
    out = []
    for device in ("cpu", dev):
        s = tpl.Session.from_points(pts, SMALL_CFG, device=device)
        s.cloud = s.cloud.replace(segment=ref.cloud.segment.to(device))
        s.characteristics()
        s.camera = cam
        prop = torch.linspace(0.0, 1.0, s.cloud.capacity)
        kernels.reset_launches()
        s.build_lod()
        frames = [s.render(cam, use_lod=True),
                  s.render(cam, prop=prop, use_lod=True)]
        taus = (s.solve_adaptive_tau(budget_rows=20_000, camera=cam),
                s.solve_adaptive_tau(match_floor=0.9, camera=cam))
        s.build_lod(camera=cam, adaptive_tau_px=taus[0])
        frames.append(s.render(cam, use_lod=True))
        s.build_lod(camera=cam, level=9)
        center = np.array([4.0, 6.0, 4.0], np.float32)
        s.delete_sphere(center, radius=2.0)
        frames.append(s.render(cam, use_lod=True))
        nid = s.spawn(center + [0.0, -3.0, 0.0], radius=1.5)
        s.draw_sphere(center, nid, radius=2.5, include_deleted=True)
        s.combine(1, 2)
        s.reclassify_sphere(center, 2, nid, radius=1.0)
        hit = s.pick(160.0, 120.0)
        table = s.full_table()
        launches = kernels.launches()
        state = [s.cloud.pos, s.cloud.segment, s.cloud.classification,
                 s.cloud.valid, *s._lod, s._tree.keys, s._tree.order,
                 s._tree.lo, table.count, table.ground_sep]
        assert all(t.device.type == s.device.type for t in state)
        out.append(dict(frames=frames, taus=taus, nid=nid, hit=hit,
                        seg=s.cloud.segment.cpu(), launches=launches))
    cpu, card = out
    assert sum(cpu["launches"].values()) == 0
    assert card["launches"]["dilate"] >= 4
    assert card["launches"]["eye_dome"] >= 4
    assert card["launches"]["segmented_cummax"] > 0
    assert (cpu["taus"], cpu["nid"]) == (card["taus"], card["nid"])
    assert torch.equal(cpu["seg"], card["seg"])
    assert (cpu["hit"][0], cpu["hit"][2]) == (card["hit"][0], card["hit"][2])
    np.testing.assert_allclose(card["hit"][1], cpu["hit"][1], rtol=1e-5)
    for a, b in zip(cpu["frames"], card["frames"]):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


# the knn_select kernel's own shapes: rows ragged over its 16-row tiles and
# 1024-candidate chunks, a snug buffer with an invalid tail, exact copies
# 1500 rows apart (across tiles and chunks, so ties meet in one list)
KNN_KERNEL_CASES = ("rows_8191", "rows_12289", "snug_16384", "duplicates")


def _knn_case(case: str):
    """(pos f32[N,3], valid bool[N]) on the CPU for a k-NN edge case."""
    rng = np.random.default_rng(7)
    if case == "empty":
        return torch.zeros((0, 3)), torch.zeros(0, dtype=torch.bool)
    if case in KNN_KERNEL_CASES:
        n = {"rows_8191": 8191, "rows_12289": 12289, "snug_16384": 16384,
             "duplicates": 10000}[case]
        pos = tlas.synthetic_tree(rng, np.array([30.0, 2.0, -40.0]),
                                  n_points=n)
        valid = rng.random(n) < 0.97
        if case == "snug_16384":
            valid = np.arange(n) < n - n // 50
            pos[~valid] = 0.0
        elif case == "duplicates":
            pos = pos[np.arange(n) % 1500]
        return torch.from_numpy(pos), torch.from_numpy(valid)
    pos = torch.from_numpy(rng.uniform(-3, 3, (3000, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random(3000) < 0.9)
    if case == "no_point":
        valid[:] = False
    elif case == "one_point":
        valid[:] = False
        valid[1234] = True
    elif case == "few_members":
        valid = torch.arange(3000) % 300 == 7
    elif case == "all_ties":
        pos[:] = torch.tensor([1.5, -2.0, 0.25])
    elif case == "overflow":     # 40 copies of each of 75 points
        pos = pos[:75].repeat(40, 1)
    return pos, valid


@pytest.mark.parametrize("case", ["empty", "no_point", "one_point",
                                  "few_members", "all_ties", "overflow",
                                  "random", *KNN_KERNEL_CASES])
def test_knn_on_the_card_equals_the_cpu(dev, case):
    """Both k-NNs on the card equal the CPU's bit for bit (elementwise f32
    arithmetic; the brute force's ``knn_select`` kernel against the plain
    version's int64 keys through topk, the grid's stable sort), and
    repeat.  At the kernel's own shapes the brute force alone, at k = 1,
    8, 31 and 64."""
    pos, valid = _knn_case(case)
    if case in KNN_KERNEL_CASES:
        for k in (1, 8, 31, 64):
            ref = tnb.knn_bruteforce(pos, valid, k=k)
            kernels.reset_launches()
            got = tnb.knn_bruteforce(pos.to(dev), valid.to(dev), k=k)
            again = tnb.knn_bruteforce(pos.to(dev), valid.to(dev), k=k)
            assert kernels.knn_select.launches == 2
            for g, a, r in zip(got, again, ref):
                assert torch.equal(g, a)
                assert torch.equal(g.cpu(), r), (case, k)
        return
    for fn, kw in ((tnb.knn_bruteforce, {}),
                   (tnb.knn_grid, dict(cell_size=0.5, cell_capacity=2)),
                   (tnb.knn_grid, dict(cell_size=0.5))):
        if case == "empty" and fn is tnb.knn_grid:
            continue    # the grid's origin is a reduction over the rows
        ref = fn(pos, valid, **kw)
        kernels.reset_launches()
        got = fn(pos.to(dev), valid.to(dev), **kw)
        again = fn(pos.to(dev), valid.to(dev), **kw)
        if fn is tnb.knn_bruteforce:    # no launch for no rows
            assert kernels.knn_select.launches == (0 if case == "empty"
                                                   else 2)
        for g, a, r in zip(got, again, ref):
            assert torch.equal(g, a)
            assert torch.equal(g.cpu(), r), (fn.__name__, kw)
    if case == "all_ties":
        idx, dist = tnb.knn_bruteforce(pos.to(dev), valid.to(dev))
        assert (dist == 0).all()
        first = torch.nonzero(valid).flatten()[:31].to(dev)
        assert (idx == first.to(torch.int32)).all()
    if case == "overflow":
        _, dist = tnb.knn_grid(pos.to(dev), valid.to(dev), 0.5,
                               cell_capacity=2)
        assert (dist == 3.0e38).any()


def test_knn_select_refuses_k_past_its_lists_on_the_card(dev):
    """On the card the brute force takes k up to the kernel's 64; past it,
    where the CPU's plain version still answers, it raises and launches
    nothing."""
    pos, valid = _knn_case("random")
    assert tnb.knn_bruteforce(pos, valid, k=65)[0].shape == (3000, 65)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="at most 64"):
        tnb.knn_bruteforce(pos.to(dev), valid.to(dev), k=65)
    assert kernels.knn_select.launches == 0


def test_eigen_degenerate_branches_on_the_card(dev):
    """The closed form's branches on the card: diagonal matrices take the
    sorted diagonal and isotropic or zero ones the +y normal, as on the CPU,
    bit for bit; elsewhere acos and cos of CUDA's libm may differ from the
    CPU's by a few ulps, which near a repeated eigenvalue moves the
    eigenvalues by up to sqrt(ulp) of the scale, and the normal of a
    repeated smallest eigenvalue is any unit vector of its plane."""
    rng = np.random.default_rng(3)
    d = rng.uniform(0, 5, (300, 3)).astype(np.float32)
    d[::3] = d[::3, :1]                              # isotropic
    d[1::7] = 0.0                                    # zero
    diag = torch.from_numpy(np.einsum("ni,ij->nij", d, np.eye(3,
                                                               dtype=np.float32)))
    u = torch.from_numpy(rng.normal(size=(300, 3, 1)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(300, 3, 3)).astype(np.float32))
    mats = torch.cat([diag, u @ u.transpose(1, 2), a @ a.transpose(1, 2)])
    scale = mats.abs().amax(dim=(1, 2))
    out = {}
    for fn in (teig.eigvals_sym3, teig.smallest_eigenvector,
               teig.curvature_from_cov):
        got, ref = fn(mats.to(dev)).cpu(), fn(mats)
        assert torch.equal(got[:300], ref[:300]), fn.__name__
        assert torch.equal(fn(mats.to(dev)).cpu(), got)
        out[fn.__name__] = got, ref
    got, ref = out["eigvals_sym3"]
    assert ((got - ref).abs().amax(dim=1) <= 5e-4 * scale).all()
    got, ref = out["curvature_from_cov"]
    assert ((got - ref).abs() <= 2e-3).all()
    got, ref = out["smallest_eigenvector"]
    ev = out["eigvals_sym3"][1]
    apart = ev[:, 1] - ev[:, 2] > 1e-3 * scale
    assert apart[600:].all() and not apart[300:600].any()
    dot = (got * ref).sum(dim=1).abs()
    assert (1.0 - dot[apart] <= 1e-4).all()
    assert (got[:, 1] >= 0).all()
    assert ((got.norm(dim=1) - 1.0).abs() <= 1e-5).all()


@pytest.mark.parametrize("display", tpl.FOCUS_DISPLAYS)
def test_render_focus_on_the_card(dev, display):
    """Each focused display on the card, from the CPU's ids: both frame
    kernels launch (and the cummax for expansion and height), the frame
    repeats bit for bit and equals the CPU's within 1 per channel on all
    but a few pixels (curvature and normals sum in another order)."""
    pts = tlas.synthetic_forest(n_trees=4, points_per_tree=3000,
                                ground_points=4000, seed=11)
    cam = Camera.orbital(distance=30.0, device="cpu").rotate_orbital(40.0,
                                                                     -60.0)
    ref = tpl.Session.from_points(pts, SMALL_CFG, device="cpu")
    ref.segment(0.75)
    counts = ref.table.count.numpy()
    sid = int(np.argmax(counts[1:])) + 1
    frames = []
    for device in ("cpu", dev):
        s = tpl.Session.from_points(pts, SMALL_CFG, device=device)
        s.cloud = s.cloud.replace(
            segment=ref.cloud.segment.to(device),
            classification=ref.cloud.classification.to(device))
        s.table = tch.SegmentTable.from_numpy(ref.table.to_numpy(),
                                              device=device)
        s.camera = cam.to(device)
        kernels.reset_launches()
        frames.append(s.render_focus(sid, display=display, show_axis=True,
                                     show_rbv=display == "height",
                                     show_hull=display == "shaded"))
        launches = kernels.launches()
        if s.device.type == "cuda":
            assert launches["dilate"] >= 1 and launches["eye_dome"] == 1
            if display in ("expansion", "height"):
                assert launches["segmented_cummax"] >= 1
            np.testing.assert_array_equal(
                frames[-1], s.render_focus(sid, display=display,
                                           show_axis=True,
                                           show_rbv=display == "height",
                                           show_hull=display == "shaded"))
            curve = s.curvature(sid)
            s._clear_focus()        # recompute the k-NN, not the cache
            assert torch.equal(s.curvature(sid), curve)
    diff = np.abs(frames[0].astype(int) - frames[1].astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.999


def _attribute_scan(path) -> int:
    """A small forest written as LAS 1.4 PDRF 7 with intensity, RGB and GPS
    time from a seed; returns its point count."""
    pts = tlas.synthetic_forest(n_trees=4, points_per_tree=3000,
                                ground_points=4000, seed=11)
    n = len(pts)
    rng = np.random.default_rng(12)
    rec = np.zeros((n, tlas.POINT_LENGTHS[7]), np.uint8)
    rec[:, 12:14] = rng.integers(0, 1 << 16, n, dtype=np.uint16).astype(
        "<u2").view(np.uint8).reshape(n, 2)
    rec[:, 22:30] = (3.0e8 + rng.uniform(0.0, 3600.0, n)).astype(
        "<f8").view(np.uint8).reshape(n, 8)
    rec[:, 30:36] = rng.integers(0, 1 << 16, (n, 3), dtype=np.uint16).astype(
        "<u2").view(np.uint8).reshape(n, 6)
    tlas.write_las(str(path), pts, point_format=7, records=rec)
    return n


@pytest.mark.parametrize("name", ["intensity", "rgb", "gps_time"])
def test_attribute_frames_on_the_card(dev, tmp_path, name):
    """A source attribute as a whole-cloud, a LOD and a focused frame on the
    card, from the CPU's ids: the property equals the CPU's bit for bit,
    both frame kernels launch in every frame, each frame repeats bit for
    bit and equals the CPU's within 1 per channel on all but a few
    pixels."""
    src = tmp_path / "scan.las"
    _attribute_scan(src)
    ref = tpl.Session.from_las(str(src), SMALL_CFG, device="cpu")
    ref.segment(0.75)
    sid = int(np.argmax(ref.table.count.numpy()[1:])) + 1
    cam = Camera.orbital(distance=40.0, device="cpu").rotate_orbital(30.0,
                                                                     -35.0)
    frames, props = [], []
    for device in ("cpu", dev):
        s = tpl.Session.from_las(str(src), SMALL_CFG, device=device)
        s.cloud = s.cloud.replace(
            segment=ref.cloud.segment.to(device),
            classification=ref.cloud.classification.to(device))
        s.table = tch.SegmentTable.from_numpy(ref.table.to_numpy(),
                                              device=device)
        c = cam.to(device)
        prop, pal = s.attribute_prop(name)
        assert prop.device.type == s.device.type
        props.append(prop.cpu())

        def draw():
            return [s.render(c, prop=prop, palette=pal),
                    s.render(c, prop=prop, palette=pal, use_lod=True),
                    s.render_focus(sid, c, display=name)]

        kernels.reset_launches()
        got = draw()
        launches = kernels.launches()
        if s.device.type == "cuda":
            assert launches["dilate"] >= 3 and launches["eye_dome"] == 3
            for a, b in zip(got, draw()):
                np.testing.assert_array_equal(a, b)
        frames.append(got)
    assert torch.equal(props[0], props[1])
    for a, b in zip(*frames):
        diff = np.abs(a.astype(int) - b.astype(int)).max(-1)
        assert (diff <= 1).mean() >= 0.999


def test_ingest_checkpoint_and_export_on_the_card(dev, tmp_path):
    """``from_las`` with ingest previews, ``save`` / ``open``, ``add_session``
    of one segment and ``export_las`` on the card: the previews launch both
    frame kernels and equal the CPU's within 1 per channel; the card's
    checkpoint reopens on the card as it was; the card's export is the
    CPU's file byte for byte."""
    src = tmp_path / "scan.las"
    n = _attribute_scan(src)
    previews = {}
    sessions = {}
    for device in ("cpu", dev):
        got = []
        kernels.reset_launches()
        s = tpl.Session.from_las(str(src), SMALL_CFG, preview_cb=got.append,
                                 preview_points=4096, slab_points=8000,
                                 device=device)
        if s.device.type == "cuda":
            assert kernels.launches()["eye_dome"] == len(got)
        previews[s.device.type] = got
        s.segment(0.75)
        sessions[s.device.type] = s
    assert len(previews["cpu"]) == len(previews["cuda"]) == -(-n // 8000)
    for a, b in zip(previews["cpu"], previews["cuda"]):
        diff = np.abs(a.astype(int) - b.astype(int)).max(-1)
        assert (diff <= 1).mean() >= 0.999
    card, cpu = sessions["cuda"], sessions["cpu"]
    assert torch.equal(card.cloud.segment.cpu(), cpu.cloud.segment)
    assert torch.equal(card.cloud.classification.cpu(),
                       cpu.cloud.classification)
    for ext in ("las", "laz"):
        a, b = tmp_path / f"card.{ext}", tmp_path / f"cpu.{ext}"
        assert card.export_las(str(a)) == cpu.export_las(str(b))
        assert a.read_bytes() == b.read_bytes()
    ckpt = tmp_path / "s.npz"
    card.save(str(ckpt))
    back = tpl.Session.open(str(ckpt), SMALL_CFG, device=dev)
    live = card.cloud.valid
    for f in ("pos", "segment", "classification"):
        assert torch.equal(getattr(back.cloud, f)[:n],
                           getattr(card.cloud, f)[live])
    for k, v in card.attributes.items():
        np.testing.assert_array_equal(back.attributes[k][:n],
                                      v[live.cpu().numpy()])
    sid = int(np.argmax(card.table.count.cpu().numpy()[1:])) + 1
    part = tmp_path / "one.ipc"
    card.save(str(part), segment_id=sid)
    top = int(card.cloud.segment.max())
    card.add_session(str(part))
    seg = card.cloud.segment[card.cloud.valid].cpu().numpy()
    assert (seg[n:] == top + 1).all() and len(seg) > n
    assert card.table is None and card.cloud.pos.device.type == "cuda"


def test_cli_save_and_reopen_on_the_card(dev, tmp_path, monkeypatch):
    """``python -m treee_tpu_torch --demo --save`` and then the checkpoint
    reopened (``--no-segment --frames 1``) on the card: every frame kernel
    runs, the reopened frame is the frame the first run drew, byte for byte,
    and the checkpoint holds the card session's arrays."""
    import contextlib
    import io

    from treee_tpu_torch import app

    monkeypatch.setenv("TREEE_APP_CONFIG", "small")
    ckpt, first, second = tmp_path / "s.npz", tmp_path / "a", tmp_path / "b"
    frame = ["--frames", "1", "--width", "192", "--height", "108"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert app.main(["--demo", "--save", str(ckpt), "--out-dir",
                         str(first), *frame]) == 0
    assert "segments:" in out.getvalue()
    assert kernels.launches()["dilate"] > 0
    assert kernels.launches()["eye_dome"] > 0
    kernels.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        assert app.main([str(ckpt), "--no-segment", "--out-dir", str(second),
                         *frame]) == 0
    assert kernels.launches()["dilate"] > 0
    assert ((second / "frame_000.png").read_bytes()
            == (first / "frame_000.png").read_bytes())
    back = tpl.Session.open(str(ckpt), device=dev)
    assert back.cloud.pos.device.type == "cuda" and back.cloud.count == 148_000
    assert int(back.cloud.segment.max()) > 1


def test_viewer_server_on_the_card(dev):
    """The browser viewer over a small card session: /frame.rgb is
    Session.render's frame byte for byte, a drag burst coalesces into fewer
    renders than commands, and shutdown ends the render worker."""
    import json
    import urllib.request

    from treee_tpu_torch.serve import ViewerServer

    pts = tlas.synthetic_forest(n_trees=4, points_per_tree=4000,
                                ground_points=4000, seed=3)
    s = tpl.Session.from_points(pts, SMALL_CFG, device=dev)
    s.segment(0.75)
    v = ViewerServer(s, port=0)
    v.serve_background()
    try:
        base = f"http://127.0.0.1:{v.port}"

        def settle():
            for _ in range(3000):
                with v._frame_cond:
                    if v._req_gen == v._done_gen:
                        return
                time.sleep(0.01)
            raise AssertionError("render worker never settled")

        def cmd(line):
            req = urllib.request.Request(f"{base}/cmd", data=line.encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        v.frame_png()
        settle()
        with urllib.request.urlopen(f"{base}/frame.rgb", timeout=60) as r:
            h, w = int(r.headers["X-Height"]), int(r.headers["X-Width"])
            img = np.frombuffer(r.read(), np.uint8).reshape(h, w, 3)
        np.testing.assert_array_equal(img, s.render())
        renders = []
        orig = v._frame_img_locked
        v._frame_img_locked = lambda focus=False: (renders.append(1),
                                                   orig(focus))[1]
        seq = v.frame_seq
        assert cmd("event down left 10 10")["ok"]
        for i in range(20):
            assert cmd(f"event move {12 + 3 * i} 10")["ok"]
        assert cmd(f"event up left {12 + 3 * 19} 10")["ok"]
        png, seq2 = v.frame_wait(seq, timeout=60)
        assert seq2 > seq and png[:4] == b"\x89PNG"
        settle()
        assert 1 <= len(renders) < 22
        img, _ = v.frame_rgb()
        with v.lock:
            np.testing.assert_array_equal(img, s.render())
    finally:
        v.shutdown()
    assert not v._render_thread.is_alive()


def _sharded_equals_single(pos, valid, cfg, mesh):
    """The sharded session step over ``mesh`` against full_pipeline on the
    mesh's first device: ids, classes and table bit for bit."""
    ref = tpl.full_pipeline(torch.from_numpy(pos).to(mesh.devices[0]),
                            torch.from_numpy(valid).to(mesh.devices[0]),
                            0.75, cfg)
    pos_s, valid_s = tsh.shard_points(mesh, pos, valid)
    got = tsh.sharded_session_step(mesh, cfg)(pos_s, valid_s, 0.75)
    assert torch.equal(torch.cat(got[0]), ref[0])
    assert torch.equal(torch.cat(got[1]), ref[1])
    for f in ("present", "count", "n_slices", "lo", "hi", "areas",
              "ground_sep", "crown_sep"):
        a, b = getattr(got[2], f), getattr(ref[2], f)
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b), f
    assert int(got[3].n_segments) == int(ref[3].n_segments)


def test_sharded_step_with_padding_shards_on_the_card(dev):
    """Four shards on one card, three of them padding only, far from the
    origin: bounds and the table's y grid take the identities."""
    pts = tlas.synthetic_forest(n_trees=3, points_per_tree=1500,
                                ground_points=1000, seed=13)
    pts = pts + np.float32([400.0, 50.0, 400.0])
    pos = np.zeros((4 * 8192, 3), np.float32)
    pos[:len(pts)] = pts
    valid = np.arange(len(pos)) < len(pts)
    mesh = tsh.make_mesh([dev] * 4)
    _sharded_equals_single(pos, valid, SMALL_CFG, mesh)
    assert kernels.cc_sweep.launches > 0
    assert kernels.segmented_cummax.launches > 0


def test_tile_of_one_point_on_the_card(dev):
    """A far point alone in the last tile: its tile's step runs on one
    valid row, and the mesh path gives the mesh-free path's ids."""
    pts = tlas.synthetic_forest(n_trees=4, points_per_tree=2000,
                                ground_points=2000, seed=5)
    pts = np.concatenate([pts, [[500.0, 1.0, 0.0]]]).astype(np.float32)
    runs = [ttiles.tiled_pipeline(pts, 2, 0.75, SMALL_CFG, halo=5.0,
                                  device=dev),
            ttiles.tiled_pipeline(pts, 2, 0.75, SMALL_CFG, halo=5.0,
                                  mesh=tsh.make_mesh([dev] * 4))]
    for seg, cls, tables, info in runs:
        assert info["n_alloc"][1] <= 1
        assert (seg[:-1] > 0).mean() > 0.5
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def _spanning_rows(dev, seed=3, n_pad=4096):
    """Morton-ordered rows with runs of 60 identical positions (leaf nodes
    across shard edges), a third of them dead, padding at the end (the last
    of 8 shards all padding), on the card."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 40, (50, 3)).astype(np.float32)
    pts = np.concatenate([np.repeat(centers, 60, axis=0),
                          rng.uniform(0, 40, (500, 3)).astype(np.float32)])
    pos = np.zeros((n_pad, 3), np.float32)
    pos[:len(pts)] = pts
    valid = np.arange(n_pad) < len(pts)
    order = tsh.morton_order(torch.from_numpy(pos),
                             torch.from_numpy(valid)).numpy()
    live = valid[order].copy()
    live[::3] = False
    return (torch.from_numpy(pos[order]).to(dev),
            torch.from_numpy(valid[order]).to(dev),
            torch.from_numpy(live).to(dev))


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_lod_carries_on_the_card(dev, d):
    """The LOD and adaptive cuts over d shards of the card, their carries
    crossing nodes that span shards and a shard of padding, equal the
    card's one-device cuts bit for bit."""
    pos, valid, live = _spanning_rows(dev)
    mesh = tsh.make_mesh([dev] * d)
    tree = toctree.build(pos, valid)
    trees = tsh.sharded_octree(mesh)(tsh.split(mesh, pos),
                                     tsh.split(mesh, valid))
    live_s = tsh.split(mesh, live)
    planes = Camera.orbital(distance=60.0, device=dev).frustum_planes(16 / 9)
    for level, ppn, frustum in ((6, 2, None), (9, 1, None), (6, 1, planes)):
        ref = toctree.lod_mask(tree, level, ppn, live=live, frustum=frustum)
        got = tsh.sharded_lod_mask(mesh, level, ppn)(trees, live_s, frustum)
        assert torch.equal(torch.cat(got), ref), (level, ppn)
    cam_pos = torch.tensor([25.0, 30.0, 25.0], device=dev)
    ref = toctree.adaptive_mask(tree, cam_pos, 870.0, tau_px=2.0, live=live)
    got = tsh.sharded_adaptive_mask(mesh, 870.0, 2.0)(trees, live_s, cam_pos)
    assert torch.equal(torch.cat(got), ref)
    taus = tpl.Session.TAU_LADDER
    assert torch.equal(
        tsh.sharded_adaptive_counts(mesh, 870.0, taus)(trees, live_s,
                                                       cam_pos),
        toctree.adaptive_counts(tree, cam_pos, 870.0, taus, live=live))


def test_sharded_pick_tie_on_the_card(dev):
    """A ray through a run of identical points that crosses a shard edge:
    the lowest row wins over 8 shards of the card, as on one device."""
    from treee_tpu_torch import interactive as tedit
    from treee_tpu_torch.cloud import PointCloud

    pos, valid, _ = _spanning_rows(dev)
    n = pos.shape[0]
    seg = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    cls_ = torch.zeros(n, dtype=torch.int32, device=dev)
    mesh = tsh.make_mesh([dev] * 8)
    rows = n // 8
    keys = toctree.build(pos, valid).keys.cpu().numpy()
    edge = next(k * rows for k in range(1, 8)
                if keys[k * rows - 1] == keys[k * rows])
    sharded = tsh.ShardedCloud(mesh, tuple(
        PointCloud(pos=pos[k * rows:(k + 1) * rows],
                   segment=seg[k * rows:(k + 1) * rows],
                   classification=cls_[k * rows:(k + 1) * rows],
                   valid=valid[k * rows:(k + 1) * rows]) for k in range(8)))
    origin = pos[edge] + torch.tensor([0.0, 5.0, 0.0], device=dev)
    down = torch.tensor([0.0, -1.0, 0.0], device=dev)
    ref = tedit.pick(PointCloud(pos=pos, segment=seg, classification=cls_,
                                valid=valid), origin, down, 0.01)
    got = tsh.sharded_pick(mesh)(sharded, origin, down, 0.01)
    assert bool(got[2]) and int(got[0]) == int(ref[0]) <= edge
    assert float(got[1]) == float(ref[1])
