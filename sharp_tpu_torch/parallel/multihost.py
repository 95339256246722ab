"""Several processes over one block stream: the multi-process streaming path.

Counterpart of `sharp_tpu/parallel/multihost.py` (numpy apart from its jax
calls, so the port keeps its own copy). Each process streams a disjoint
contiguous slice of the cell blocks, with no traffic between processes
during the block pass; the one collective is an all-gather of the padded
O(clusters x p) block summaries (centroids and counts) before every
process runs the same deterministic global sMetaC. Every process draws the
same RP matrices from the shared seed, so a block's result does not depend
on the process that ran it.

The collectives are `torch.distributed` over gloo, on CPU float32 tensors:
the summaries are small host arrays (one flagship block's is about 264 x
257 float32, 0.27 MB), and NCCL refuses two ranks on one card.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the process group when one is configured; returns
    (process_index, process_count).

    Arguments not given come from torchrun's variables: MASTER_ADDR and
    MASTER_PORT ("host:port"), WORLD_SIZE and RANK. With no address, or a
    world of one process, nothing is joined and (0, 1) is returned. A group
    already joined is kept.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    num_processes = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    process_id = process_id if process_id is not None else _env_int("RANK")
    if not coordinator_address or (num_processes or 1) <= 1:
        return 0, 1
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id or 0,
    )
    return dist.get_rank(), dist.get_world_size()


def local_rank() -> int:
    """This process's rank on its machine: LOCAL_RANK, else RANK, else 0."""
    v = _env_int("LOCAL_RANK")
    if v is None:
        v = _env_int("RANK")
    return v or 0


def processes_per_card() -> int:
    """The processes of this machine that share one card: LOCAL_WORLD_SIZE
    (else WORLD_SIZE) over the visible cards, rounded up; 1 outside a
    process group."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    local = _env_int("LOCAL_WORLD_SIZE") or dist.get_world_size()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return max(1, -(-local // max(cards, 1)))


def block_slice(n_blocks: int, process_index: int, process_count: int) -> List[int]:
    """Contiguous block assignment: process h streams blocks [lo, hi).

    Contiguous (not strided) so each process's manifest directory stays
    resume-compatible when the process count changes.
    """
    base = n_blocks // process_count
    rem = n_blocks % process_count
    lo = process_index * base + min(process_index, rem)
    hi = lo + base + (1 if process_index < rem else 0)
    return list(range(lo, hi))


def pad_block_summary(
    cents: np.ndarray, counts: np.ndarray, budget: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a block's (C, p) centroids / (C,) counts to a fixed budget so the
    summaries of all processes stack into one all-gather payload."""
    C, p = cents.shape
    if C > budget:
        raise ValueError(
            f"block produced {C} clusters > summary budget {budget}; "
            "the budget is derived from maxN_cluster (after the "
            "smetac_range widening) — raise maxN_cluster to cover it"
        )
    cp = np.zeros((budget, p), np.float32)
    cp[:C] = cents
    cc = np.zeros((budget,), np.float32)
    cc[:C] = counts
    return cp, cc


def barrier(process_count: Optional[int] = None) -> None:
    """A sync point of all processes (an all-gather of one float): once
    after joining, and once per streamed block, so that no process waits at
    the summary all-gather for more than one block's worth of skew."""
    allgather_summaries(np.zeros((1,), np.float32), process_count)


def allgather_summaries(local: np.ndarray, process_count: Optional[int] = None) -> np.ndarray:
    """All-gather the processes' stacked summary payloads.

    local: (n_local_blocks, ...) float32, the same shape in every process.
    Returns their concatenation in process order, the same array in every
    process. One process: the identity.
    """
    import torch
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    pc = process_count if process_count is not None else (dist.get_world_size() if initialized else 1)
    if pc == 1:
        return local
    t = torch.from_numpy(np.ascontiguousarray(local, np.float32))
    parts = [torch.empty_like(t) for _ in range(pc)]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=0).numpy()
