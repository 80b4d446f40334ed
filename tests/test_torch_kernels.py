"""The port's kernel wrappers on the CPU: their plain PyTorch versions against
the JAX package's Pallas kernels in interpret mode, bit for bit, and the
dispatch rules (plain path only for CPU tensors, no launches counted)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from treee_tpu import characteristics as jch
from treee_tpu import segmentation as jsg
from treee_tpu.ops import pallas_kernels as pk
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.ops.kernels import build

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


def test_jump_flood_steps():
    assert kernels.jump_flood_steps(384) == [192, 96, 48, 24, 12, 6, 3, 1]
    assert kernels.jump_flood_steps(1) == []
    assert kernels.jump_flood_steps(3) == [1]


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
    cols = key[:, None] % 4                                  # i32[100,1]
    assert torch.equal(kernels.take_along_axis(val, cols, 1),
                       kernels.take_along_axis_plain(val, cols, 1))
    rows = (key[:8, None] % 9).expand(8, 4).contiguous()     # i32[8,4]
    assert torch.equal(kernels.take_along_axis(val, rows, 0),
                       kernels.take_along_axis_plain(val, rows, 0))
    flat = val[:, 0].contiguous()
    assert torch.equal(kernels.take_along_axis(flat, key, None),
                       flat[key.long()])
    assert kernels.launches() == {"cc_sweep": 0, "match_scan": 0,
                                  "segmented_cummax": 0, "dilate": 0,
                                  "eye_dome": 0, "segmented_cumsum": 0,
                                  "jump_flood": 0, "take_along_axis": 0}


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
        kernels.take_along_axis(meta[4], meta[3][:, None] % 4, 1)
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
            "take_along.cu"} <= names
    assert "tools/probe_extract.py::try_kernel" in (
        build.CSRC / "take_along.cu").read_text()
    # the two step kernels run as one thread-block cluster launch each
    for src in ("cc_sweep.cu", "match_scan.cu"):
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
