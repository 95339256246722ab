"""The selection sweep's routes on the CPU (`sharp_tpu_torch.ops.silhouette`).

A CPU tensor takes the plain sweep (`sweep_scores_nested_plain`) and
launches nothing; the kernels' source is built with the other kernels,
unfused; the kernels' wrappers refuse what the kernels do not take before
they load anything. The kernels themselves are held to the plain sweep on
the card (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sharp_tpu_torch.ops import _build, silhouette
from sharp_tpu_torch.ops import linkage as tlink
from sharp_tpu_torch.ops.select import opt_hclust, prep_distance
from sharp_tpu_torch.utils import timers
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(minN=2, ncand=39, nc_pad=48)


def _lanes(n=96, nreals=(96, 70, 12), maxNs=(40, 20, 40), seed=0, p=6):
    rng = np.random.default_rng(seed)
    Z = np.zeros((len(nreals), n, p), np.float32)
    for lane, r in enumerate(nreals):
        Z[lane, :r] = 3.0 * rng.normal(size=(6, p))[rng.integers(0, 6, r)] + rng.normal(size=(r, p))
    mask = torch.from_numpy(np.arange(n)[None, :] < np.asarray(nreals)[:, None])
    D, D_real, feats = prep_distance(torch.from_numpy(Z), mask, symmetric=False)
    link = tlink.ward_linkage(D)
    nr, mx = torch.tensor(nreals, dtype=torch.int32), torch.tensor(maxNs, dtype=torch.int32)
    cuts = tlink.cutree_multi(link.merges, nr, mask, mx, **KW)
    return D_real, feats, link.merges, cuts.labels, mask, nr, mx


def test_cpu_sweep_takes_the_plain_version():
    """On CPU tensors the sweep is the plain version, value for value, with
    and without the lane axis, and launches no kernel."""
    args = _lanes()
    before = dict(silhouette.LAUNCHES)
    msil, ch = silhouette.sweep_scores_nested(*args, **KW)
    pm, pc = silhouette.sweep_scores_nested_plain(*args, **KW)
    assert torch.equal(msil, pm) and torch.equal(ch, pc)
    one = [a[1] for a in args[:5]] + [int(args[5][1]), int(args[6][1])]
    m1, c1 = silhouette.sweep_scores_nested(*one, **KW)
    assert m1.shape == (KW["ncand"],) and torch.equal(m1, pm[1]) and torch.equal(c1, pc[1])
    assert silhouette.LAUNCHES == before == dict.fromkeys(("sweep_nodes", "sweep_score", "sweep_median"), 0)


def test_tracer_counts_the_plain_lanes():
    """While a profiler records, a CPU selection counts its lanes as
    `select.plain_lanes` and none as `select.kernel_lanes`; off, nothing."""
    D_real, feats, _, _, mask, nr, mx = _lanes()
    timers.reset()
    opt_hclust(feats, mask, nr, mx, symmetric=False, **KW)
    assert "select.plain_lanes" not in timers.snapshot()["sums"]
    with profile(activities=[ProfilerActivity.CPU]):
        opt_hclust(feats, mask, nr, mx, symmetric=False, **KW)
    sums = timers.snapshot()["sums"]
    timers.reset()
    assert sums["select.plain_lanes"] == 3 and "select.kernel_lanes" not in sums


def test_sweep_source_is_built_unfused():
    """csrc/sweep.cu is one of the built sources, under the flags that keep
    its float arithmetic unfused and its divisions IEEE, with its C entry
    point's signature, and defines the three kernels."""
    assert "sweep.cu" in _build.SOURCES
    assert "--fmad=false" in _build.NVCC_FLAGS and "--use_fast_math" not in _build.NVCC_FLAGS
    restype, argtypes = _build._SIGNATURES["sweep.cu"]["sharp_sweep_launch"]
    assert len(argtypes) == 16 + 9 + 1
    src = (_build.CSRC / "sweep.cu").read_text()
    kernels = set(re.findall(r"^(sweep_\w+)\(", src, re.M))
    assert kernels == set(silhouette.LAUNCHES)
    assert Path(_build.CSRC / "sweep.cu").exists()


@pytest.mark.parametrize("V,dtype", [(87, torch.uint8), (256, torch.uint8), (257, torch.int16),
                                     (506, torch.int16), (32768, torch.int16), (32769, torch.int32)])
def test_own_table_takes_the_narrowest_type(V, dtype):
    assert silhouette._own_type(V)[0] == dtype


def test_sweep_wrappers_refuse_bad_input():
    """The kernels' wrappers check dtype, shape and layout, then the device,
    before loading any kernel; the sweep refuses a device that is neither
    the CPU nor a card."""
    L, n, V, ncand = 2, 16, 10, 4
    sums, fc = torch.zeros((L, n, V)), torch.zeros((L, n, V))
    counts = torch.zeros((L, V))
    own = torch.zeros((L, ncand, n), dtype=torch.uint8)
    live = torch.zeros((L, ncand, 1), dtype=torch.int32)
    real = torch.ones((L, n), dtype=torch.bool)
    with pytest.raises(TypeError):
        silhouette.sweep_score_kernel(sums.double(), counts, fc, own, live, real)
    with pytest.raises(ValueError, match="not contiguous"):
        silhouette.sweep_score_kernel(sums, counts, fc.transpose(1, 2).contiguous().transpose(1, 2), own, live,
                                      real)
    with pytest.raises(TypeError):
        silhouette.sweep_score_kernel(sums, counts, fc, own.int(), live, real)
    with pytest.raises(ValueError, match="CUDA"):
        silhouette.sweep_score_kernel(sums, counts, fc, own, live, real)
    width = torch.zeros((L, ncand, n))
    with pytest.raises(ValueError):
        silhouette.sweep_median_kernel(width, width[:, :, :-1], real, torch.zeros(L, dtype=torch.int32), live,
                                       counts, counts, minN=2)
    merges = torch.zeros((L, n - 1, 2), dtype=torch.int32)
    labels = torch.zeros((L, ncand, n), dtype=torch.int32)
    nr = torch.full((L,), n, dtype=torch.int32)
    with pytest.raises(TypeError):
        silhouette.sweep_nodes_kernel(merges.long(), labels, nr, nr, sums, counts, torch.zeros((L, V, 3)),
                                      minN=2, nc_pad=V - ncand)
    with pytest.raises(ValueError, match="nc_pad"):
        silhouette.sweep_nodes_kernel(merges, labels, nr, nr, sums, counts, torch.zeros((L, V, 3)),
                                      minN=2, nc_pad=V - ncand + 1)
    args = _lanes()
    with pytest.raises(ValueError, match="unsupported device"):
        silhouette.sweep_scores_nested(*(a.to("meta") for a in args[:5]), args[5], args[6], **KW)
