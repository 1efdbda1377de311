"""Masked group-by ops on fixed-size tensors (PyTorch port of
`happypose_tpu/ops/segment_ops.py`). Invalid rows never win."""

from __future__ import annotations

from typing import Tuple

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


def argmin_per_group(
    key: torch.Tensor,  # [N] int in [0, n_groups)
    value: torch.Tensor,  # [N]
    valid: torch.Tensor,  # [N] bool
    n_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group argmin: (index into N of each group's smallest valid value,
    the lowest index on ties, -1 for an empty group [n_groups]; the minima,
    inf for an empty group [n_groups])."""
    N = key.shape[0]
    key = key.long()
    v = value.masked_fill(~valid, torch.inf)
    mins = torch.full((n_groups,), torch.inf, dtype=value.dtype, device=value.device)
    mins = mins.scatter_reduce(0, key, v, reduce="amin")
    idxs = torch.arange(N, device=key.device)
    cand = torch.where(valid & (v == mins[key]), idxs, N)
    arg = torch.full((n_groups,), N, dtype=idxs.dtype, device=key.device)
    arg = arg.scatter_reduce(0, key, cand, reduce="amin")
    return torch.where(arg == N, -1, arg), mins


def expand_for_symmetry(
    n_sym_per_row: torch.Tensor,  # [N] int
    max_total: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ragged symmetry expansion as dense gather indices: (row_idx, sym_idx,
    valid), each [max_total]; the valid prefix enumerates the (row, sym)
    pairs in row-major order, the rest is 0 and invalid."""
    N = n_sym_per_row.shape[0]
    ends = torch.cumsum(n_sym_per_row.long(), dim=0)
    pos = torch.arange(max_total, device=ends.device)
    row = torch.clamp(torch.searchsorted(ends, pos, right=True), 0, N - 1)
    sym = pos - (ends - n_sym_per_row.long())[row]
    valid = pos < ends[-1]
    zero = torch.zeros_like(pos)
    return torch.where(valid, row, zero), torch.where(valid, sym, zero), valid
