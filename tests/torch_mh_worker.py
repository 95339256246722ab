"""Worker for the two-process gloo tests of the port (test_torch_parallel.py).

Usage: python torch_mh_worker.py <rank> <port> <outdir> [mode]
Joins a two-process torch.distributed group on localhost:<port> through
torchrun's variables, runs `sharp_tpu_torch.sharp_unlimited(multihost=True,
device="cpu")` on the inputs of tests/mh_worker.py (mode "basic": 3 blocks
of 500 x 400 cells in all; "budget": n_cells forced to 2.1e6, so the
summary budget must cover the widened cluster range) and writes this
process's labels to <outdir>/p<rank>.npz. The RP matrix is `shared_rp`'s,
so the JAX package's `sharp_unlimited` can be given the same one. Imports
nothing of JAX.
"""

import os
import sys

import numpy as np

_MATS = {}


def ternary(rng, m, p):
    """A (m, p) float32 ternary RP matrix drawn from the numpy Generator rng."""
    s = np.sqrt(np.float32(m))
    u = rng.random((m, p), dtype=np.float32)
    t = 1.0 / (2.0 * s)
    return np.where(u < t, np.sqrt(s), np.where(u > 1.0 - t, -np.sqrt(s), 0.0)).astype(np.float32)


def shared_rp(K, m, p):
    """A (m, K*p) ternary RP matrix made with numpy from (K, m): one matrix
    that both packages' streaming modules can be given."""
    if (K, m, p) not in _MATS:
        _MATS[K, m, p] = ternary(np.random.default_rng(K * 1000 + m), m, K * p)
    return _MATS[K, m, p]


def inputs(mode):
    """(blocks, knobs) of tests/mh_worker.py's mode."""
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.append(here)
    from mh_worker import BUDGET_KW, budget_blocks
    from synth import make_tpm_like

    if mode == "budget":
        return budget_blocks(make_tpm_like), BUDGET_KW
    X, _ = make_tpm_like(n_cells=500, n_genes=400, n_types=4, seed=5)
    return [X[:200], X[200:350], X[350:]], dict(rN_seed=3, ensize_K=3, base_ncells=200, partition_ncells=128)


def run(mode, **extra):
    """This mode's `sharp_unlimited` of the port on the CPU."""
    from sharp_tpu_torch import sharp_unlimited

    blocks, kw = inputs(mode)
    return sharp_unlimited(blocks, device="cpu", **kw, **extra)


def main():
    rank, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mode = sys.argv[4] if len(sys.argv) > 4 else "basic"
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2", RANK=str(rank))
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    from sharp_tpu_torch.parallel import streaming

    streaming.ensemble_rp_matrix = lambda seed, K, m, p, dtype=torch.float32, device="cpu": (
        torch.from_numpy(shared_rp(K, m, p)).to(device, dtype))
    r = run(mode, multihost=True)
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "sharp_tpu")]
    if loaded:
        raise AssertionError(f"the port loaded {loaded[:5]}")
    np.savez(os.path.join(outdir, f"p{rank}.npz"), labels=r.pred_clusters, n=r.N_pred_cluster)


if __name__ == "__main__":
    main()
