"""Itemise the characteristics' bucket run-end extraction on the card, and
time the shared-memory gather kernel at the Mosaic gather probe's shapes.

Counterpart of ``tools/probe_extract.py``, which asked the same of the TPU.
At 15M points, ``s_cap``=2048 and ``ms``=128 (262,144 buckets), inputs drawn
from numpy's generator with seed 0 in the probe's order, it times with CUDA
events (median of ``--reps``):

- ``characteristics._run_end_index`` (one searchsorted, a clamp and a
  gather-compare);
- the [262144, 12] row gather from [N, 12];
- the planar 12 x [262144] gather from [12, N];
- ``torch.searchsorted`` alone;

and runs the ``take_along_axis`` kernel at the probe's four shapes
(``take_along_axis`` on axis 0 at (8,128) and (256,128), on axis 1 at
(8,128), and a 1-D table indexed by an (8,128) grid), each held bit for bit
against its plain version and timed beside it and beside
``torch.take_along_dim``.  Every result line names the card.

    python -m treee_tpu_torch.tools.probe_extract [--points N] [--reps R]

Needs a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

N_POINTS = 15_000_000
S_CAP = 2048
MAX_SLICES = 128
FILL = -3.0e38


def probe_inputs(n: int = N_POINTS, seed: int = 0) -> dict:
    """The probe's numpy inputs, drawn in its order from one generator:
    sorted bucket keys of n points, f32[n,12] values, then the gather
    probe's tables and indices."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(1, 941, n)).astype(np.int32)
    slc = rng.integers(0, MAX_SLICES, n).astype(np.int32)
    out = {"bucket": np.sort(seg * MAX_SLICES + slc).astype(np.int32),
           "val": rng.random((n, 12)).astype(np.float32)}
    out["tab8"] = rng.random((8, 128)).astype(np.float32)
    out["idx8"] = rng.integers(0, 8, (8, 128)).astype(np.int32)
    out["tab256"] = rng.random((256, 128)).astype(np.float32)
    out["idx256"] = rng.integers(0, 256, (256, 128)).astype(np.int32)
    out["tabl"] = rng.random((8, 128)).astype(np.float32)
    out["idxl"] = rng.integers(0, 128, (8, 128)).astype(np.int32)
    return out


def gather_cases(inputs: dict) -> list[tuple[str, np.ndarray, np.ndarray, object]]:
    """(name, table, indices, axis) of the probe's four gathers; the last one
    indexes row 0 of the table, as ``tab_ref[0, idx_ref[:]]`` does."""
    return [
        ("take_along_axis axis=0 (8,128)", inputs["tab8"], inputs["idx8"], 0),
        ("take_along_axis axis=0 (256,128)", inputs["tab256"],
         inputs["idx256"], 0),
        ("take_along_axis axis=1 (8,128)", inputs["tabl"], inputs["idxl"], 1),
        ("vector index tab[0, idx2d] (8,128)", inputs["tabl"][0],
         inputs["idxl"], None),
    ]


def run_gathers(cases, device) -> list[torch.Tensor]:
    """Each case through ``take_along_axis`` on ``device``: the kernel on a
    card, the plain version on the CPU."""
    from treee_tpu_torch.ops import kernels

    return [kernels.take_along_axis(torch.from_numpy(tab).to(device),
                                    torch.from_numpy(idx).to(device), axis)
            for _, tab, idx, axis in cases]


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``reps`` calls of ``fn``, each between CUDA events,
    after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=N_POINTS)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_extract needs a CUDA card")
    from treee_tpu_torch import characteristics as ch
    from treee_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    where = card()
    n_buckets = S_CAP * MAX_SLICES
    inputs = probe_inputs(args.points)
    bucket = torch.from_numpy(inputs["bucket"]).to(dev)
    val = torch.from_numpy(inputs["val"]).to(dev)
    val_t = val.t().contiguous()
    print(f"# probe_extract n={args.points:,} buckets={n_buckets:,} on "
          f"{where}", flush=True)

    def line(name, ms, extra=""):
        print(f"{name:44s} {ms:9.4f} ms{extra}   [{where}]", flush=True)

    line("run_end_index (searchsorted)",
         cuda_ms(lambda: ch._run_end_index(bucket, n_buckets), args.reps))
    idx, hit = ch._run_end_index(bucket, n_buckets)
    line("row gather [262k,12] from [N,12]",
         cuda_ms(lambda: torch.where(hit[:, None], val[idx], FILL),
                 args.reps))
    line("planar 12x [262k] from (12,N)",
         cuda_ms(lambda: torch.where(hit[None, :], val_t[:, idx], FILL),
                 args.reps))
    q = torch.arange(n_buckets, dtype=bucket.dtype, device=dev)
    line("torch.searchsorted",
         cuda_ms(lambda: torch.searchsorted(bucket, q, right=True),
                 args.reps))

    cases = gather_cases(inputs)
    for (name, tab, ix, axis), got in zip(cases, run_gathers(cases, dev)):
        tab, ix = torch.from_numpy(tab).to(dev), torch.from_numpy(ix).to(dev)
        ref = kernels.take_along_axis_plain(tab, ix, axis)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"{name}: the kernel differs from the plain "
                                 "version")
        ix_l = ix.long()
        lib = ((lambda: tab[ix_l]) if axis is None else
               (lambda: torch.take_along_dim(tab, ix_l, dim=axis)))
        k_ms = cuda_ms(lambda: kernels.take_along_axis(tab, ix, axis),
                       args.reps)
        p_ms = cuda_ms(lambda: kernels.take_along_axis_plain(tab, ix, axis),
                       args.reps)
        line(f"kernel {name}", k_ms, f"; plain {p_ms:.4f} ms, library "
             f"{cuda_ms(lib, args.reps):.4f} ms; bit-equal")


if __name__ == "__main__":
    main()
