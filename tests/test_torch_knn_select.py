"""The focused view's k-NN selection, ``kernels.knn_select``, on the CPU.

On CPU tensors the wrapper is the plain tiled brute force and counts no
launch, at any k; it checks its inputs alike on every device, and its
kernel route refuses k past the kernel's lists before it builds or
launches anything.  The plain version is the contract the kernel is held
to bit for bit on the card (``test_torch_cuda.py``): each row's k least
keys (distance bits, row) of a whole sort, the distances rounded as
``(dx^2 + dy^2) + dz^2`` in f32 and invalid rows at exactly INF, at any
query tile.  Its output equals the JAX package's ``knn_bruteforce`` on a
lattice, whose distances are exact under both packages' arithmetic
(elsewhere the JAX package's identity ``|q|^2 + |p|^2 - 2 q.p`` rounds
otherwise: ``test_torch_focus.py`` holds the two within its cancellation).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treee_tpu.ops import neighbors as jnb
from treee_tpu_torch import config as tconfig
from treee_tpu_torch import characteristics, pipeline
from treee_tpu_torch.io import las as tlas
from treee_tpu_torch.ops import kernels
from treee_tpu_torch.ops import neighbors as tnb
from treee_tpu_torch.ops.kernels import build
from treee_tpu_torch.ops.kernels.knn_select import INF, MAX_K

import torch_threads

torch_threads.share_cores()


def _sorted_by_key(pos, valid, k):
    """(idx i32[N,k], dist f32[N,k]) from a whole sort of every row's keys
    (distance bits, row) in numpy: the plain version's contract."""
    pos, valid = pos.numpy(), valid.numpy()
    d = pos[:, None, :] - pos[None, :, :]           # f32, each rounded
    d = d * d
    d = (d[..., 0] + d[..., 1]) + d[..., 2]
    d = np.where(valid[None, :], d, np.float32(INF)).astype(np.float32)
    keys = (d.view(np.int32).astype(np.int64) << 32) | np.arange(len(pos))
    top = np.sort(keys, axis=1)[:, :k]
    return ((top & 0xFFFFFFFF).astype(np.int32),
            (top >> 32).astype(np.int32).view(np.float32))


def _case(kind: str, n: int, seed: int = 5):
    """(pos f32[N,3], valid bool[N]) on the CPU."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * [2, 5, 2]
    valid = rng.random(n) < 0.95
    if kind == "duplicates":    # copies 700 rows apart: across chunks, tiles
        pos = pos[np.arange(n) % 700]
    elif kind == "snug":        # a member block, then the invalid tail
        valid = np.arange(n) < n - n // 50
    elif kind == "few_valid":   # fewer valid rows than k
        valid = np.zeros(n, bool)
        valid[rng.choice(n, 5, replace=False)] = True
    elif kind == "tree":        # a tree's trunk, then its crown
        pos = tlas.synthetic_tree(rng, np.array([10.0, 0.0, -20.0]),
                                  n_points=n)
        valid = np.ones(n, bool)
    return (torch.from_numpy(pos.astype(np.float32)),
            torch.from_numpy(valid))


SORT_CASES = [("random", 2500, 31), ("random", 70, 64), ("random", 64, 64),
              ("duplicates", 2100, 8), ("snug", 1200, 31),
              ("few_valid", 900, 8), ("tree", 1500, 1),
              ("duplicates", 1500, 100)]


@pytest.mark.parametrize("tile", [1024, 97])
@pytest.mark.parametrize("kind,n,k", SORT_CASES)
def test_knn_select_plain_is_a_sort_by_key(kind, n, k, tile):
    """The plain version gives each row's k least keys of a whole sort, bit
    for bit, in one tile or in ragged tiles: ties on the distance to the
    lower row, a row with fewer than k valid candidates padded with the
    lowest invalid rows at INF."""
    pos, valid = _case(kind, n)
    idx, dist = kernels.knn_select_plain(pos, valid, k, tile)
    ref_idx, ref_dist = _sorted_by_key(pos, valid, k)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(dist.numpy().view(np.int32),
                                  ref_dist.view(np.int32))
    if kind == "few_valid":
        assert (dist[:, 5:] == np.float32(INF)).all()


def test_knn_select_kernel_keeps_the_wrappers_largest_k():
    """The wrapper refuses on the card what the kernel's lists cannot
    hold: its MAX_K is the source's kMaxK."""
    text = (build.CSRC / "knn_select.cu").read_text()
    k_max = int(re.search(r"constexpr int kMaxK = (\d+);", text).group(1))
    assert k_max == MAX_K == 64


@pytest.mark.parametrize("tile", [1, 7, 1024])
def test_knn_select_on_cpu_is_the_plain_version(tile):
    """On CPU tensors the wrapper and ``knn_bruteforce`` are the plain
    version at any tile, and no launch is counted."""
    pos, valid = _case("duplicates", 600)
    kernels.reset_launches()
    got = kernels.knn_select(pos, valid, 31, tile)
    via = tnb.knn_bruteforce(pos, valid, k=31, tile=tile)
    ref = kernels.knn_select_plain(pos, valid, 31, 1024)
    for g, v, r in zip(got, via, ref):
        assert torch.equal(g, r) and torch.equal(v, r)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    assert sum(kernels.launches().values()) == 0


@pytest.mark.parametrize("k", [1, 8, 31, 64, 100])
def test_knn_bruteforce_on_cpu_equals_jax_on_a_lattice(k):
    """On a lattice with duplicated and invalid points (exact distances,
    many ties) the port's CPU output equals the JAX package's twin bit for
    bit: the tie rule and the INF padding alike, past the kernel's k too."""
    g = np.arange(7, dtype=np.float32)
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos = np.concatenate([pos, pos[::4]])
    valid = np.ones(len(pos), bool)
    valid[::9] = False
    kernels.reset_launches()
    idx, dist = tnb.knn_bruteforce(torch.from_numpy(pos),
                                   torch.from_numpy(valid), k=k)
    j_idx, j_dist = jnb.knn_bruteforce(jnp.asarray(pos), jnp.asarray(valid),
                                       k=k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(j_dist))
    assert kernels.knn_select.launches == 0


def test_knn_select_empty_and_all_invalid():
    """N = 0 gives empty outputs; rows with no valid candidate take the
    first k rows at INF."""
    idx, dist = kernels.knn_select(torch.zeros((0, 3)),
                                   torch.zeros(0, dtype=torch.bool), 31, 64)
    assert idx.shape == (0, 31) and dist.shape == (0, 31)
    pos, _ = _case("random", 100)
    idx, dist = kernels.knn_select(pos, torch.zeros(100, dtype=torch.bool),
                                   31, 64)
    assert (idx == torch.arange(31, dtype=torch.int32)).all()
    assert (dist == np.float32(INF)).all()


def _bad_inputs():
    pos, valid = _case("random", 100)
    good = dict(pos=pos, valid=valid, k=31, tile=64)
    return good, {
        "f64 positions": dict(pos=pos.double()),
        "2 coordinates": dict(pos=pos[:, :2]),
        "1-D positions": dict(pos=pos[:, 0]),
        "u8 flags": dict(valid=valid.to(torch.uint8)),
        "short flags": dict(valid=valid[1:]),
        "2-D flags": dict(valid=valid[:, None]),
        "k 0": dict(k=0),
        "k 65": dict(k=65),
        "k past N": dict(pos=pos[:20], valid=valid[:20]),
        "tile 0": dict(tile=0),
        "meta device": dict(pos=pos.to("meta"), valid=valid.to("meta")),
        "mixed devices": dict(valid=valid.to("meta")),
    }


@pytest.mark.parametrize("bad", sorted(_bad_inputs()[1]))
def test_knn_select_checks_its_inputs(bad, monkeypatch):
    good, bads = _bad_inputs()
    if bad == "k 65":
        # the kernel's route, taken here for CPU tensors: it refuses k past
        # the kernel's lists before it builds or launches anything (the
        # plain version takes any k)
        monkeypatch.setattr(build, "on_cuda", lambda t, name: True)
    kernels.reset_launches()
    with pytest.raises(ValueError,
                       match="device" if "device" in bad else "knn_select"):
        kernels.knn_select(**{**good, **bads[bad]})
    assert kernels.knn_select.launches == 0


def test_a_session_with_100_neighbours_on_the_cpu():
    """A session configured past the kernel's k computes the focused
    view's curvature on the CPU through the plain version, as the
    characteristics function does."""
    pts = tlas.synthetic_forest(n_trees=1, points_per_tree=1500,
                                ground_points=500, seed=3)
    cfg = tconfig.Config(characteristics=tconfig.CharacteristicsConfig(
        neighbors=100))
    s = pipeline.Session.from_points(pts, cfg, device="cpu")
    s.segment(0.75)
    sid = int(torch.argmax(s.table.count[1:])) + 1
    kernels.reset_launches()
    curve = s.curvature(sid)
    member = s._member_mask(sid)
    assert torch.equal(curve, characteristics.segment_curvature(
        s.cloud.pos, member, k=100))
    assert float(curve[member].max()) > 0
    assert kernels.knn_select.launches == 0
