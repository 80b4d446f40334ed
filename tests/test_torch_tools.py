"""The port's counterpart of ``tools/probe_extract.py`` on the CPU: it draws
the probe's inputs in the probe's order, its four gathers through the
``take_along_axis`` wrapper equal the probe's Pallas bodies (interpret mode)
bit for bit, and it refuses to run without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from treee_tpu_torch.ops import kernels
from treee_tpu_torch.tools import probe_extract

import torch_threads

torch_threads.share_cores()

N = 5000


def _probe_draws(n):
    """The JAX probe's draws, in its order (tools/probe_extract.py:46-121)."""
    rng = np.random.default_rng(0)
    seg_np = np.sort(rng.integers(1, 941, n)).astype(np.int32)
    slice_np = rng.integers(0, 128, n).astype(np.int32)
    bucket_np = np.sort(seg_np * 128 + slice_np).astype(np.int32)
    val = rng.random((n, 12)).astype(np.float32)
    tab8 = rng.random((8, 128)).astype(np.float32)
    idx8 = rng.integers(0, 8, (8, 128)).astype(np.int32)
    tab256 = rng.random((256, 128)).astype(np.float32)
    idx256 = rng.integers(0, 256, (256, 128)).astype(np.int32)
    tabl = rng.random((8, 128)).astype(np.float32)
    idxl = rng.integers(0, 128, (8, 128)).astype(np.int32)
    return dict(bucket=bucket_np, val=val, tab8=tab8, idx8=idx8,
                tab256=tab256, idx256=idx256, tabl=tabl, idxl=idxl)


def test_probe_inputs_follow_the_probe_draws():
    got, ref = probe_extract.probe_inputs(N), _probe_draws(N)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _k_taa0(tab_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=0)


def _k_taa1(tab_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=1)


def _k_take(tab_ref, idx_ref, out_ref):
    out_ref[:] = tab_ref[0, idx_ref[:]]


# the probe's calls: (body, table, indices) as try_kernel passes them
PROBE_CALLS = [(_k_taa0, "tab8", "idx8"), (_k_taa0, "tab256", "idx256"),
               (_k_taa1, "tabl", "idxl"), (_k_take, "tabl", "idxl")]


@pytest.mark.parametrize("case", range(4))
def test_probe_gathers_equal_the_pallas_bodies(case):
    inputs = probe_extract.probe_inputs(N)
    cases = probe_extract.gather_cases(inputs)
    kernels.reset_launches()
    got = probe_extract.run_gathers(cases[case:case + 1], "cpu")[0]
    body, tab, idx = PROBE_CALLS[case]
    ref = np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((inputs[tab].shape[0], 128),
                                             jnp.float32),
        interpret=True)(jnp.asarray(inputs[tab]), jnp.asarray(inputs[idx])))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.view(np.int32))
    assert kernels.take_along_axis.launches == 0   # CPU tensors: plain only


def test_probe_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        probe_extract.main(["--points", "1000"])

