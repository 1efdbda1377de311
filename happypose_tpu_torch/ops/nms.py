"""Greedy non-maximum suppression on the device with a fixed output budget:
the wrapper of the hand-written CUDA kernels `nms_mask_kernel` and
`nms_scan_kernel` (`csrc/mask_rcnn_ops.cu`), and their plain PyTorch
version.

torchvision's `batched_nms` semantics without its data-dependent shapes:
candidates [..., N] with boxes (x1, y1, x2, y2), scores, groups (a class
or a pyramid level: only candidates of one group suppress each other) and
a validity flag (an invalid candidate is neither kept nor suppresses).
They are visited in the order of a stable descending sort of the scores
(ties: the lowest index first); a live one is kept and suppresses the
later ones of its group whose IoU with it is over the threshold. The
first `max_out` kept come back, in that order, as indices into the
candidates with a validity flag. An unused slot holds the index of the
first candidate in scan order (the highest-scored), its flag false: Mask
R-CNN masks every slot by the flag, and `models.detector.nms_fixed` maps
the index to 0, as JAX's does. IoUs are computed from the boxes as they
are (torchvision's `batched_nms` offsets the boxes by group instead, which
rounds larger coordinates).

`nms` sends a CUDA tensor to the kernels and a CPU tensor to
`nms_reference`. No fallback: a CUDA tensor launches the kernels or
raises. Nothing is read to the host, so the call can be part of a CUDA
graph.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

# Kernel launches (of the pair) since the last reset; the CPU path never counts.
launches = 0
_TILE = 64


def _sorted_inputs(boxes, scores, groups, valid):
    """The candidates in scan order: a stable descending sort of the scores
    (invalid ones included, wherever their score puts them)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    sb = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    return order, sb, torch.gather(groups, -1, order), torch.gather(valid, -1, order)


def suppression_matrix(boxes: torch.Tensor, groups: torch.Tensor, valid: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    """[..., N, N] bool: candidate j is suppressed by candidate i (both
    valid, one group, IoU over the threshold), with the kernel's arithmetic:
    torchvision's IoU, inter / (area_i + area_j - inter), no clamp."""
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    iou = inter / (area[..., :, None] + area[..., None, :] - inter)
    same = groups[..., :, None] == groups[..., None, :]
    both = valid[..., :, None] & valid[..., None, :]
    return (iou > iou_threshold) & same & both


def _scan(suppress: np.ndarray, valid: np.ndarray, max_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The greedy scan of one image, candidates already in scan order."""
    alive = valid.copy()
    keep = np.zeros(max_out, np.int64)
    kv = np.zeros(max_out, bool)
    nk = 0
    for i in range(len(alive)):
        if nk == max_out:
            break
        if alive[i]:
            keep[nk], kv[nk] = i, True
            nk += 1
            alive[i + 1:] &= ~suppress[i, i + 1:]
    return keep, kv


def nms_reference(boxes: torch.Tensor, scores: torch.Tensor, groups: torch.Tensor,
                  valid: torch.Tensor, iou_threshold: float,
                  max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `nms` (the scan on the host, in numpy)."""
    lead, N = scores.shape[:-1], scores.shape[-1]
    order, sb, sg, sv = _sorted_inputs(boxes, scores, groups, valid)
    suppress = suppression_matrix(sb, sg, sv, iou_threshold).reshape(-1, N, N).cpu().numpy()
    scans = [_scan(s, v, max_out) for s, v in zip(suppress, sv.reshape(-1, N).cpu().numpy())]
    pos = torch.from_numpy(np.stack([k for k, _ in scans]) if scans else
                           np.zeros((0, max_out), np.int64)).reshape(*lead, max_out)
    kv = torch.from_numpy(np.stack([v for _, v in scans]) if scans else
                          np.zeros((0, max_out), bool)).reshape(*lead, max_out)
    pos, kv = pos.to(boxes.device), kv.to(boxes.device)
    return torch.gather(order, -1, pos), kv


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nms_launch.argtypes = [vp] * 6 + [ci] * 3 + [cf, ci, vp]
    lib.nms_launch.restype = ci
    lib.mask_rcnn_error_string.argtypes = [ci]
    lib.mask_rcnn_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_library() -> ctypes.CDLL:
    from happypose_tpu_torch.csrc import load_library

    return _bind(load_library("mask_rcnn_ops"))


def nms(boxes: torch.Tensor, scores: torch.Tensor, groups: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float, max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of candidates [..., N] (module docstring): returns (keep
    [..., max_out] int64 indices into the candidates, keep_valid
    [..., max_out] bool)."""
    global launches
    N = scores.shape[-1]
    if boxes.shape != (*scores.shape, 4) or groups.shape != scores.shape \
            or valid.shape != scores.shape:
        raise ValueError(f"boxes [..., N, 4], scores, groups, valid [..., N]; got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}, {tuple(groups.shape)}, "
                         f"{tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if boxes.device.type == "cpu":
        return nms_reference(boxes, scores, groups, valid, iou_threshold, max_out)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms runs on CUDA or CPU tensors, not {boxes.device}")
    lead = scores.shape[:-1]
    order, sb, sg, sv = _sorted_inputs(boxes.float(), scores, groups.to(torch.int32), valid)
    B = int(np.prod(lead)) if lead else 1
    sb, sg, sv = sb.contiguous(), sg.contiguous(), sv.contiguous()
    n_words = -(-N // _TILE)
    mask = torch.empty(B * N * n_words, dtype=torch.int64, device=boxes.device)
    pos = torch.empty(B * max_out, dtype=torch.int64, device=boxes.device)
    kv = torch.empty(B * max_out, dtype=torch.bool, device=boxes.device)
    lib = _kernel_library()
    err = lib.nms_launch(sb.data_ptr(), sg.data_ptr(), sv.data_ptr(), mask.data_ptr(),
                         pos.data_ptr(), kv.data_ptr(), B, N, max_out, float(iou_threshold),
                         boxes.device.index, torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: "
                           f"{lib.mask_rcnn_error_string(err).decode()} ({err})")
    launches += 1
    pos, kv = pos.reshape(*lead, max_out), kv.reshape(*lead, max_out)
    return torch.gather(order, -1, pos), kv
