"""The port's kernel wrappers on the CPU: their plain PyTorch versions against
the JAX package's Pallas kernels in interpret mode, bit for bit, and the
dispatch rules (plain path only for CPU tensors, no launches counted)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treee_tpu import characteristics as jch
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
                                      (40, 24)])
def test_cc_sweep_plain_matches_pallas(g, sweeps):
    lbl = _labels(_blob_grid(3, g, 6, seed=g + sweeps))
    ref = np.asarray(pk.cc_sweep_pallas(jnp.asarray(lbl), sweeps,
                                        interpret=True))
    got = kernels.cc_sweep(torch.from_numpy(lbl), sweeps)
    np.testing.assert_array_equal(got.numpy(), ref)


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
    assert kernels.launches() == {"cc_sweep": 0, "match_scan": 0,
                                  "segmented_cummax": 0, "dilate": 0,
                                  "eye_dome": 0}


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
    assert sum(kernels.launches().values()) == 0


def test_wrappers_check_their_inputs():
    lbl, cents, cmask, key, val = _cpu_inputs()
    with pytest.raises(ValueError):
        kernels.cc_sweep(lbl.float(), 3)
    with pytest.raises(ValueError):
        kernels.cc_sweep(lbl, 0)
    with pytest.raises(ValueError):
        kernels.match_scan(cents, cmask[:, :4], 1.0, 2, 16)
    with pytest.raises(ValueError):
        kernels.segmented_cummax(key.long(), val)
    with pytest.raises(ValueError):
        kernels.segmented_cummax(key, torch.zeros(100, 17))


def test_build_targets_hopper_without_fma_contraction(monkeypatch, tmp_path):
    flags = build.NVCC_FLAGS
    assert "-gencode=arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert not any("fast_math" in f for f in flags)
    names = {p.name for p in build.sources()}
    assert {"cc_sweep.cu", "match_scan.cu", "seg_cummax.cu", "dilate.cu",
            "eye_dome.cu"} <= names
    # every kernel source names the TPU kernel it replaces
    for src, tpu in [("cc_sweep.cu", "_cc_sweep_kernel"),
                     ("match_scan.cu", "_match_kernel"),
                     ("seg_cummax.cu", "_seg_cummax_kernel"),
                     ("dilate.cu", "_dilate_kernel"),
                     ("eye_dome.cu", "_eye_dome_kernel")]:
        assert f"pallas_kernels.py::{tpu}" in (build.CSRC / src).read_text()
    cmd = build.nvcc_command(tmp_path / "lib.so")
    assert cmd[0] == "nvcc" and str(tmp_path / "lib.so") in cmd
    # without a CUDA toolkit the build raises instead of falling back
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os, "access", lambda p, m: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
