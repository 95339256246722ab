"""Configuration of a clustering call: the port's copy of `sharp_tpu/config.py`.

Knob names and auto-scaling defaults mirror the reference's knob
resolution block (R/SHARP.R:119-228) and live in one dataclass, so every
result echoes its fully-resolved configuration (the reference's `paras`,
R/SHARP.R:292-313). `resolve_config(...).as_dict()` is field for field the
JAX package's: results of the two packages carry the same `paras`.

All static shapes (padded block size, candidate-k sweep bounds, cluster
budget paddings) are resolved here, on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_dim(n: int, minimum: int = 8) -> int:
    """Round n up to a padded size: powers of two up to 512, then multiples
    of 512 (few distinct shapes, padding waste under 25%)."""
    n = max(n, minimum)
    if n <= 512:
        return 1 << (n - 1).bit_length()
    return _ceil_to(n, 512)


@dataclasses.dataclass(frozen=True)
class SharpConfig:
    """Resolved SHARP configuration. Defaults follow R/SHARP.R:119-228; see
    `resolve_config` for the auto-scaling rules."""

    # --- data ---
    n_cells: int = 0
    n_genes: int = 0

    # --- core knobs (reference names in parens) ---
    reduced_ndim: int = 0          # p            (R/SHARP.R:119-122)
    ensize_K: int = 0              # ensize.K     (R/SHARP.R:254-270)
    base_ncells: int = 5000        # base.ncells  (R/SHARP.R:124-127)
    partition_ncells: int = 2000   # partition.ncells (R/SHARP.R:129-132)
    hmethod: str = "ward.D"        # hmethod      (R/SHARP.R:134-137)
    N_cluster: Optional[int] = None        # fixed cluster count (optional)
    indN_cluster: Optional[int] = None     # per-RP fixed count (optional)
    minN_cluster: int = 2          # minN.cluster (R/SHARP.R:139-142)
    maxN_cluster: int = 40         # maxN.cluster (R/SHARP.R:144-147)
    sil_thre: float = 0.35         # sil.thre     (R/SHARP.R:149-152)
    height_Ntimes: float = 2.0     # height.Ntimes (R/SHARP.R:154-157)
    prep: bool = False             # negative clamp + all-zero-gene drop (R/SHARP.R:74-80,99-106)
    # logflag (R/SHARP.R:202-228) controls whether the testlog check runs:
    # None => check when n < 1e4, else transform unconditionally; True =>
    # run the check; False => log-transform without checking.
    # `log_transform` forces the final decision directly.
    logflag: Optional[bool] = None
    log_transform: Optional[bool] = None   # explicit final decision override
    exp_type: Optional[str] = None  # "count"|"CPM"|"TPM"|"FPKM"|... (R/SHARP.R:110-117)
    rN_seed: Optional[int] = None   # None => nonreproducible sentinel (R/SHARP.R:169-179)
    sncells: int = 100             # testlog probe size (R/SHARP.R:879-882)
    forview: bool = True           # keep viE/x0 for visualization (R/SHARP.R:445-449)

    # --- knobs of the implementation (no reference equivalent) ---
    n_devices: int = 1             # replaces n.cores (R/SHARP.R:162-167)
    ensemble_axis: int = 1         # partitioning of the K ensemble axis over devices
    dtype_compute: str = "float32"  # RP product input dtype ("bfloat16" on real runs)
    # "auto" | "xla" | "pallas" | "pallas_bf16" | "rnn" | "rnn_bf16", mapped
    # per problem size by ops/linkage.resolve_linkage_backend
    linkage_backend: str = "auto"
    block_pad: int = 0             # static padded block size (cells per block)
    nc_pad: int = 64               # padded per-block cluster one-hot width (>= maxN+1)
    meta_nc_budget: int = 2048     # compaction budget for sMetaC global clusters

    @property
    def is_small(self) -> bool:
        return self.n_cells < self.base_ncells

    def replace(self, **kw) -> "SharpConfig":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def default_reduced_ndim(n_cells: int) -> int:
    """JL-style reduced dimension ceil(log2(n) / 0.2^2) (R/SHARP.R:119-122)."""
    return int(math.ceil(math.log2(max(n_cells, 2)) / 0.04))


def resolve_config(n_cells: int, n_genes: int, **overrides) -> SharpConfig:
    """Resolve all defaulted knobs from the data dimensions, in the
    reference's order (R/SHARP.R:119-280):
      - reduced.ndim = ceil(log2(n)/0.04)                 (:121)
      - ensize.K     = 15 if small path else 5            (:256,270)
      - maxN.cluster = max(40, ceil(n/5000))              (:145)
      - prep/logflag auto-disabled at n >= 1e4            (:74-80,202-209)
    """
    cfg = SharpConfig(n_cells=n_cells, n_genes=n_genes)
    kw = dict(overrides)

    # reference knobs accepted for signature parity and ignored: n.cores
    # sized the fork pool (R/SHARP.R:162-167), flashmark switched hclust
    # implementations (R/get_opt_hclust.R:76-83)
    kw.pop("n_cores", None)
    kw.pop("flashmark", None)

    if not kw.get("reduced_ndim"):
        kw["reduced_ndim"] = default_reduced_ndim(n_cells)
    base_ncells = kw.get("base_ncells", cfg.base_ncells)
    small = n_cells < base_ncells
    if not kw.get("ensize_K"):
        kw["ensize_K"] = 15 if small else 5
    if "maxN_cluster" not in kw:
        kw["maxN_cluster"] = max(40, math.ceil(n_cells / 5000))
    if "prep" not in kw:
        kw["prep"] = n_cells < 1e4
    if kw.get("log_transform") is None and kw.get("logflag") is None:
        # the reference runs the testlog check only under 1e4 cells and
        # log-transforms unconditionally above (R/SHARP.R:202-228)
        if n_cells >= 1e4:
            kw["log_transform"] = True

    if not kw.get("block_pad"):
        pn = kw.get("partition_ncells", cfg.partition_ncells)
        kw["block_pad"] = pad_dim(min(n_cells, pn if not small else n_cells))
    if "nc_pad" not in kw:
        # one-hot width for per-block cluster ids; +8 slack, 8-aligned
        kw["nc_pad"] = _ceil_to(min(kw["maxN_cluster"], 40) + 2, 8)

    return cfg.replace(**kw)
