"""MegaPose's single-view stages in plain PyTorch (Labbé et al., CoRL 2022):
the SO(3)-grid hypotheses with their autodepth init, the coarse
classifier's logits, one refiner iteration and the scoring pass. Each
takes its inputs as the benchmark made them (image, intrinsics, boxes,
objects, the weights' dictionaries) and works everything else out again:
crops, crop cameras, renders, features.

`tf32=True` computes the networks and the crop's products one precision
below the configuration's float32: TF32 on a card (PyTorch's two flags),
and on a CPU, which has no TF32, with every product's inputs rounded to
TF32's 10-bit mantissa. That is the control of the comparison.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import geometry as G
from benchmark.reference import nets, raster

CROP_LAMBDA = 1.4


@dataclass
class Scene:
    """One frame as both sides get it: image [1, 3, H, W], K [1, 3, 3];
    the object database (`meshes`, `points` [n, P, 3], `points_mask`)."""

    image: torch.Tensor
    K: torch.Tensor
    meshes: raster.Meshes
    points: torch.Tensor
    points_mask: torch.Tensor


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest on TF32's 10 mantissa bits (the gradient
    passes straight through)."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0x1000 + ((i >> 13) & 1)) & ~0x1FFF
    r = i.view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


@contextlib.contextmanager
def precision(tf32: bool, device):
    """PyTorch's two TF32 flags at `tf32` on a card for the block, restored
    after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on_card = tf32 and torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on_card
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def conv_for(tf32: bool, device):
    """The convolution: F.conv2d, or on a CPU with `tf32` with its input and
    weight rounded to TF32."""
    if not tf32 or torch.device(device).type == "cuda":
        return F.conv2d
    return lambda y, w, **k: F.conv2d(round_tf32(y), round_tf32(w), **k)


BACKBONES = {"resnet34": nets.resnet34, "efficientnet_b3": nets.effnet_b3}


def features(P, x, tf32: bool, train: bool = False, backbone: str = "resnet34"):
    """Backbone features of network inputs x."""
    return BACKBONES[backbone](P, x, train=train, conv=conv_for(tf32, x.device))


def grid_hypotheses(grid: torch.Tensor, boxes, obj_ids, K, scene: Scene):
    """[D * M, 4, 4] poses: each detection's box with each grid rotation
    (detection-major), and their object ids."""
    D, M = boxes.shape[0], grid.shape[0]
    det = torch.arange(D, device=boxes.device).repeat_interleave(M)
    ids = obj_ids[det]
    T = G.autodepth_init(boxes[det], scene.points[ids], scene.points_mask[ids],
                         K.expand(D * M, 3, 3), grid.repeat(D, 1, 1))
    return T, ids


def crop_camera(K, hw, points, points_mask, obj_ids, T_in, size):
    """An iteration's geometry: the pose after orthonormalization, the crop
    box around the object's projected points (anchored at the projected
    reference point, tCR = the pose's translation) in an image of `hw`, its
    camera, and tCR."""
    T = G.orthonormalize(T_in)
    tCR = T[:, :3, 3]
    pts, mask = points[obj_ids], points_mask[obj_ids]
    boxes_rend = G.point_boxes(G.project(pts, K, T), mask)
    center = G.project(torch.zeros_like(pts[:, :1]), K, G.make_T(T[:, :3, :3], tCR))[:, 0]
    boxes = G.crop_boxes(center, boxes_rend, CROP_LAMBDA, hw)
    return T, boxes, G.crop_intrinsics(K, boxes, size), tCR


def network_input(images, K, meshes, points, points_mask, obj_ids, T_in, size, tf32=False,
                  normals: bool = True):
    """One iteration's input [B, 6 or 9, h, w] (the crop, the rendered
    colour and, with `normals`, normals) of images [B, 3, H, W] and K
    [B, 3, 3], the pose after orthonormalization, the crop camera and the
    reference point."""
    T, boxes, K_crop, tCR = crop_camera(K, images.shape[-2:], points, points_mask, obj_ids,
                                        T_in, size)
    crops = (_crop_rounded(images, boxes, size) if tf32 and images.device.type == "cpu"
             else G.crop(images, boxes, size))
    rgb, n, _ = raster.render(meshes, obj_ids, T, K_crop, size)
    chans = (torch.cat([rgb, n], dim=-1) if normals else rgb).permute(0, 3, 1, 2)
    return torch.cat([crops, chans], dim=1), T, K_crop, tCR


def scene_input(scene: Scene, obj_ids, T_in, size, tf32=False, normals: bool = True):
    """`network_input` of rows that all look at the scene's one frame."""
    B = T_in.shape[0]
    return network_input(scene.image.expand(B, -1, -1, -1).contiguous(), scene.K.expand(B, 3, 3),
                         scene.meshes, scene.points, scene.points_mask, obj_ids, T_in, size,
                         tf32=tf32, normals=normals)


def _crop_rounded(images, boxes, size):
    H, W = images.shape[-2:]
    Ry = G._interpolation(boxes[:, 1], boxes[:, 3] - boxes[:, 1], H, size[0], 4)
    Rx = G._interpolation(boxes[:, 0], boxes[:, 2] - boxes[:, 0], W, size[1], 4)
    rows = torch.einsum("bih,bchw->bciw", round_tf32(Ry), round_tf32(images))
    return torch.einsum("bciw,bjw->bcij", round_tf32(rows), round_tf32(Rx))


def _linear(P, name, feats, tf32):
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if tf32 and feats.device.type == "cpu":
        w, feats = round_tf32(w), round_tf32(feats)
    return F.linear(feats, w, b)


@torch.no_grad()
def logits(P, scene: Scene, obj_ids, T, size, block: int, tf32: bool = False) -> torch.Tensor:
    """The coarse classifier's logit [N] of each pose hypothesis."""
    out = []
    with precision(tf32, T.device):
        for s in range(0, T.shape[0], block):
            x, *_ = scene_input(scene, obj_ids[s:s + block], T[s:s + block], size, tf32=tf32)
            out.append(_linear(P, "views_logits_head", features(P, x, tf32), tf32)[:, 0])
    return torch.cat(out) if out else T.new_zeros(0)


def refine_outputs(P, x, T, K_crop, tCR, tf32: bool, train: bool = False,
                   backbone: str = "resnet34"):
    """Head outputs [B, 9] and the updated pose of network inputs x."""
    raw = _linear(P, "pose_fc", features(P, x, tf32, train=train, backbone=backbone), tf32)
    return raw, G.update_pose(T, K_crop, raw[:, 6:9], G.rotation_from_6d(raw[:, :6]), tCR)


@torch.no_grad()
def refine(P, scene: Scene, obj_ids, T_in, size, block: int, tf32: bool = False,
           backbone: str = "resnet34", normals: bool = True) -> torch.Tensor:
    """One pose update of each pose [N, 4, 4] -> [N, 4, 4]."""
    out = []
    with precision(tf32, T_in.device):
        for s in range(0, T_in.shape[0], block):
            x, T, K_crop, tCR = scene_input(scene, obj_ids[s:s + block], T_in[s:s + block],
                                            size, tf32=tf32, normals=normals)
            out.append(refine_outputs(P, x, T, K_crop, tCR, tf32, backbone=backbone)[1])
    return torch.cat(out) if out else T_in.clone()


def update_gap(T_in, T_prog, T_ref) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row: the largest difference between the program's and the
    reference's update of the pose (rotation entries, and translation over
    the input's distance), and the reference update's own size."""
    T0 = G.orthonormalize(T_in)
    dist = torch.linalg.vector_norm(T0[:, :3, 3], dim=-1, keepdim=True)

    def update(T):
        return torch.cat([(T[:, :3, :3] - T0[:, :3, :3]).flatten(1),
                          (T[:, :3, 3] - T0[:, :3, 3]) / dist], dim=-1)

    d_ref = update(T_ref)
    return (update(T_prog) - d_ref).abs().amax(-1), d_ref.abs().amax(-1)
