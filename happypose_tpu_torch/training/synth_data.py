"""Synthetic training scenes (PyTorch port of
`happypose_tpu/training/synth_data.py`): a random object at a random pose
in the camera's frustum, rendered through `render_batch_fused` (the
hand-written kernel for CUDA tensors, its plain version for CPU tensors)
over a smooth random background, with pixel noise.

`sample_synth_scenes` makes the draws with a `torch.Generator` on its
device; `make_synth_batch` is deterministic in them, so a test can hand it
the draws JAX made. It runs as one CUDA graph a key (JAX's jit of
`make_synth_batch`, static in the batch size and the resolution): the
shapes of the assets, the intrinsics and the draws, whose values are
copied into the graph's inputs, so that every mesh database of one shape
replays one graph. `make_synth_batch_eager` is its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from happypose_tpu_torch.lib3d.rotations import quat_to_rotmat
from happypose_tpu_torch.lib3d.transforms import make_T
from happypose_tpu_torch.meshes.database import MeshDataBase, RenderAssets
from happypose_tpu_torch.meshes.io import (
    decimate_mesh,
    load_mesh,
    make_box_mesh,
    make_procedural_texture,
    make_uv_sphere,
    position_colored,
)
from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused
from happypose_tpu_torch.training.forward_loss import PoseTrainingBatch
from happypose_tpu_torch.utils.cuda_graphs import GraphCache
from happypose_tpu_torch.utils.profiling import annotate


def make_synth_mesh_db(
    synth_set: str = "debug",
    mesh_files: Optional[Sequence] = None,
    texture_size: int = 256,
    max_faces: int = 0,
) -> MeshDataBase:
    """The synthetic-training mesh registry (training and checkpoint
    evaluation build it here, so their object ids agree).

    synth_set: "debug" (position-coloured sphere and box), "textured" (a
    procedurally textured UV sphere and the box: the surface detail
    render-and-compare needs to learn rotation) or "mesh_only" (only
    `mesh_files`). Extra mesh files in mm (diameter > 1) are scaled to m,
    meshes with UVs but no texture get a seeded procedural one, and meshes
    above `max_faces` faces are decimated (0 keeps them whole)."""
    meshes, scales = {}, {}
    if synth_set == "debug":
        meshes["sphere"] = position_colored(make_uv_sphere(0.04, 16, 24))
        meshes["box"] = position_colored(make_box_mesh((0.035, 0.025, 0.045)))
    elif synth_set == "textured":
        sphere = make_uv_sphere(0.04, 16, 24, with_uv=True)
        sphere.texture = make_procedural_texture(texture_size, seed=1)
        meshes["sphere"] = sphere
        meshes["box"] = position_colored(make_box_mesh((0.035, 0.025, 0.045)))
    elif synth_set == "mesh_only":
        if not mesh_files:
            raise ValueError("synth_set=mesh_only needs --mesh-files")
    else:
        raise ValueError(f"unknown synth set: {synth_set}")

    for k, path in enumerate(mesh_files or []):
        m = load_mesh(path)
        label = f"mesh{k}"
        if m.diameter > 1.0:  # mm-scale BOP model
            scales[label] = 1e-3
        if max_faces and len(m.faces) > max_faces:
            m = decimate_mesh(m, max_faces)
        if m.vertex_uv is not None and m.texture is None:
            m = dataclasses.replace(m, texture=make_procedural_texture(texture_size, seed=100 + k))
        meshes[label] = m
    return MeshDataBase(meshes=meshes, scales=scales)


def random_rotations(generator: torch.Generator, n: int) -> torch.Tensor:
    """Uniform random rotations [n, 3, 3]: normalized 4D gaussians as
    quaternions."""
    return quat_to_rotmat(torch.randn(n, 4, generator=generator, device=generator.device))


def sample_synth_scenes(
    generator: torch.Generator,
    n_objects: int,
    batch_size: int,
    resolution: Tuple[int, int] = (120, 160),
    z_range: Tuple[float, float] = (0.35, 0.8),
    xy_extent: float = 0.08,
    force_obj_ids: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """The draws of `make_synth_batch`, on the generator's device: object
    ids (`force_obj_ids` pins them), rotations, xy in +-`xy_extent`, depth
    in `z_range`, a uniform background and gaussian pixel noise
    [B, H, W, 3]."""
    B, (H, W), dev = batch_size, resolution, generator.device

    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=generator, device=dev)

    obj_ids = (
        force_obj_ids if force_obj_ids is not None
        else torch.randint(0, n_objects, (B,), generator=generator, device=dev)
    )
    return {
        "obj_ids": obj_ids,
        "R": random_rotations(generator, B),
        "xy": uniform(B, 2, lo=-xy_extent, hi=xy_extent),
        "z": uniform(B, 1, lo=z_range[0], hi=z_range[1]),
        "bg": uniform(B, H, W, 3),
        "noise": torch.randn(B, H, W, 3, generator=generator, device=dev),
    }


# The synthetic batch's graphs, one a key (a training cache: the batch's
# tensors are ordinary tensors, which a train step's autograd may read).
synth_batch_graphs = GraphCache("synth", training=True)


def make_synth_batch(
    assets: RenderAssets,
    K1: torch.Tensor,  # [3, 3] shared intrinsics
    draws: Dict[str, torch.Tensor],
) -> PoseTrainingBatch:
    """`make_synth_batch_eager` through its graph (on CPU tensors, the same
    path with a plain call), under the span `train.batch`."""
    with annotate("train.batch"):
        return synth_batch_graphs("synth_batch", make_synth_batch_eager, (assets, K1, draws))


def make_synth_batch_eager(
    assets: RenderAssets,
    K1: torch.Tensor,  # [3, 3] shared intrinsics
    draws: Dict[str, torch.Tensor],
) -> PoseTrainingBatch:
    """Render the drawn scenes at the background's resolution. The
    background is smoothed by a resize to 1/8 and back (antialiased
    bilinear down, bilinear up: `jax.image.resize(..., "linear")`)."""
    obj_ids, bg = draws["obj_ids"], draws["bg"]
    B, H, W, _ = bg.shape
    TCO_gt = make_T(draws["R"], torch.cat([draws["xy"], draws["z"]], dim=-1))
    K = K1.expand(B, 3, 3)
    out = render_batch_fused(assets, obj_ids, TCO_gt, K, resolution=(H, W))

    bg = F.interpolate(
        bg.permute(0, 3, 1, 2), size=(H // 8, W // 8), mode="bilinear", antialias=True,
        align_corners=False,
    )
    bg = F.interpolate(bg, size=(H, W), mode="bilinear", align_corners=False)
    rgb = torch.where(out.mask[:, None], out.rgb.permute(0, 3, 1, 2), bg)
    images = torch.clamp(rgb + 0.02 * draws["noise"].permute(0, 3, 1, 2), 0.0, 1.0)
    return PoseTrainingBatch(images=images.contiguous(), K=K, obj_ids=obj_ids, TCO_gt=TCO_gt)
