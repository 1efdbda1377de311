"""Masked group-by ops on fixed-size tensors (PyTorch port of the matching
parts of `happypose_tpu/ops/segment_ops.py`). Invalid rows never win."""

from __future__ import annotations

import torch


def group_keys(*cols: torch.Tensor) -> torch.Tensor:
    """Pack small non-negative int columns (ids < 1024) into one group key."""
    key = torch.zeros_like(cols[0])
    for c in cols:
        key = key * 1024 + torch.clamp(c, 0, 1023)
    return key


def topk_per_group(
    key: torch.Tensor,  # [N] int group ids
    score: torch.Tensor,  # [N] float, higher is better
    valid: torch.Tensor,  # [N] bool
    k: int,
) -> torch.Tensor:
    """[N] bool mask of the rows among their group's top-k scores.

    Rows sort by (key asc, score desc) with a stable sort, as
    `jnp.lexsort`: tied scores keep their row order, so the lower row wins.
    """
    N = key.shape[0]
    big = 2**30
    k_sort = torch.where(valid, key, torch.full_like(key, big))
    # lexsort = stable sort by the secondary key, then by the primary one
    order = torch.argsort(-score, stable=True)
    order = order[torch.argsort(k_sort[order], stable=True)]
    sorted_key = k_sort[order]
    idx = torch.arange(N, device=key.device)
    is_start = torch.ones_like(valid)
    is_start[1:] = sorted_key[1:] != sorted_key[:-1]
    start_run = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    keep_sorted = ((idx - start_run) < k) & (sorted_key != big)
    keep = torch.zeros_like(valid)
    keep[order] = keep_sorted
    return keep & valid
