"""Settings of the benchmark's own tests.

    python -m pytest perfbench/tests -q

Tests marked `cuda` need a CUDA card; each decides inside the test whether
one is there and skips without it. The others run on the CPU at small
sizes, where the port runs the plain versions of its kernels.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small configurations of the two cells' shapes, for the CPU
ATLAS_SMALL = dict(n_cells=1500, n_genes=400, block_cells=500, n_types=6, ensize_K=3, reduced_ndim=32,
                   partition_ncells=200, dtype_compute="bfloat16", forview=False, linkage_backend="auto")
WANG_SMALL = dict(n_cells=120, n_genes=300, n_types=4, ensize_K=5, reduced_ndim=32, exp_type="TPM",
                  linkage_backend="auto")


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
