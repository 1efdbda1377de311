"""Batched scene recording (PyTorch port of
`happypose_tpu/datasets/scene_record.py`): render, composite, shade and
annotate a batch of domain-randomized scenes on the device.

    render all M instances (one launch of the rasterizer kernel)
    -> per-scene z-composite -> shadow-map pass from a light camera (a
    second launch) -> Blinn-Phong specular -> background composite ->
    depth-of-field blur -> sensor noise -> per-instance visibility, bbox and
    border annotations

Parity target: the reference's synthetic data engines (pybullet
`BopRecordingScene`, cosypose/recording/bop_recording_scene.py:26-271, and
the BlenderProc PBR generator, megapose/scripts/generate_shapenet_pbr.py).
Shadows are a second rasterizer pass from a camera along the light plus a
depth compare; every annotation is a masked reduction on the device. The
host samples the scene parameters (`datasets/scene_synth.py`, numpy, the
same draws as the JAX package for a seed) and writes the files.

The sensor noise is the one draw the JAX package makes with `jax.random`:
here a tensor drawn from a `torch.Generator` and handed to
`record_scene_batch`, so a test can hand it JAX's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from happypose_tpu_torch.datasets.scene_synth import (
    SceneSynthConfig,
    SceneSynthesizer,
    SynthScene,
)
from happypose_tpu_torch.meshes.database import MeshDataBase, RenderAssets
from happypose_tpu_torch.meshes.io import Mesh, make_random_texture
from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused
from happypose_tpu_torch.ops.scene_renderer import composite, scene_zmin
from happypose_tpu_torch.utils.logging import get_logger

FLOOR_LABEL = "zz_floor"  # sorts last: the object ids of the base database stay


class RecordBatch(NamedTuple):
    """Device outputs for B scenes of up to N instances each (M = B x N)."""

    rgb: torch.Tensor  # [B, H, W, 3] uint8 final composite
    depth: torch.Tensor  # [B, H, W] float32 (0 where empty)
    visib_px: torch.Tensor  # [M] int32 visible pixels per instance
    solo_px: torch.Tensor  # [M] int32 unoccluded pixels per instance
    bbox: torch.Tensor  # [M, 4] float32 (x0, y0, x1, y1) of the visible mask
    any_vis: torch.Tensor  # [B] bool: >= 1 annotated instance visible
    border_bad: torch.Tensor  # [B] bool: a visible instance touches the border


def _gaussian_blur5(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap gaussian of images [B, H, W, C] with a sigma an
    image [B], edges replicated; sigma ~ 0 is the identity (the weights
    are one-hot at the centre tap)."""
    t = torch.arange(-2, 3, dtype=torch.float32, device=img.device)
    s = torch.clamp(sigma, min=1e-3)[:, None]
    w = torch.exp(-0.5 * (t[None] / s) ** 2)
    w = w / w.sum(-1, keepdim=True)  # [B, 5]

    def pass_(x, dim):
        n = x.shape[dim]
        base = torch.arange(n, device=x.device)
        acc = 0.0
        for k in range(5):
            idx = torch.clamp(base + (k - 2), 0, n - 1)
            acc = acc + w[:, k, None, None, None] * x.index_select(dim, idx)
        return acc

    return pass_(pass_(img, 1), 2)


def record_scene_batch(
    assets: RenderAssets,
    obj_ids: torch.Tensor,  # [M] instance object ids (M = n_scenes x n_max)
    scene_of: torch.Tensor,  # [M] owning scene of each instance
    TCO: torch.Tensor,  # [M, 4, 4] camera-from-object
    K: torch.Tensor,  # [n_scenes, 3, 3]
    valid: torch.Tensor,  # [M] the instance exists (is rendered)
    annotate: torch.Tensor,  # [M] the instance is annotated (the floor is not)
    lights: torch.Tensor,  # [n_scenes, 5] direction to the light (camera frame), amb, dif
    T_LC: torch.Tensor,  # [n_scenes, 4, 4] light-camera-from-camera
    K_L: torch.Tensor,  # [n_scenes, 3, 3] shadow-map intrinsics
    materials: torch.Tensor,  # [n_scenes, 4] spec_k, shininess, blur sigma, noise std
    bg_pool: torch.Tensor,  # [P, H, W, 3] uint8 background library
    bg_idx: torch.Tensor,  # [n_scenes]
    bg_gain: torch.Tensor,  # [n_scenes, 3] per-channel background gain
    noise: torch.Tensor,  # [n_scenes, H, W, 3] standard normal sensor noise
    n_scenes: int,
    resolution: Tuple[int, int] = (240, 320),
    shadow_size: int = 256,
    enable_shadows: bool = True,
) -> RecordBatch:
    """One batch of frames: two `render_batch_fused` calls (the instances at
    `resolution`, and with `enable_shadows` the shadow map at
    `shadow_size`^2 from the light cameras), the rest elementwise work and
    reductions on the inputs' device."""
    H, W = resolution
    dev = TCO.device
    inf = float("inf")
    scene_of = scene_of.to(torch.int64)

    out = render_batch_fused(assets, obj_ids, TCO, K[scene_of], resolution=resolution,
                             lights=lights[scene_of])
    scene, is_front = composite(out, scene_of, valid, n_scenes)
    rgb, normals, mask, depth = scene.rgb, scene.normals, scene.mask, scene.depth

    # per-instance annotations (no second render)
    visib = is_front & (valid & annotate)[:, None, None]  # [M, H, W]
    visib_px = visib.sum((1, 2)).to(torch.int32)
    solo_px = (out.mask & valid[:, None, None]).sum((1, 2)).to(torch.int32)
    jj = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    ii = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    pos_inf = torch.full((), inf, device=dev)

    def extreme(coord, lo):
        return (torch.where(visib, coord, pos_inf).amin((1, 2)) if lo
                else torch.where(visib, coord, -pos_inf).amax((1, 2)))

    x0, x1, y0, y1 = extreme(jj, True), extreme(jj, False), extreme(ii, True), extreme(ii, False)
    bbox = torch.stack([x0, y0, x1, y1], -1)
    touches = (visib_px > 0) & ((x0 == 0) | (y0 == 0) | (x1 == W - 1) | (y1 == H - 1))

    def any_of_scene(x):  # [M] bool -> [n_scenes] bool
        acc = torch.zeros(n_scenes, dtype=torch.int32, device=dev)
        return acc.index_add_(0, scene_of, x.to(torch.int32)) > 0

    any_touch, any_vis = any_of_scene(touches), any_of_scene(visib_px > 0)

    # lighting extras on the composite
    d = lights[:, :3]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-8)
    lambert = torch.clamp(torch.einsum("bhwc,bc->bhw", normals, d), min=0.0)

    # camera-frame position of every composite pixel (backprojection)
    uu = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    vv = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    fx, fy, cx, cy = (K[:, i, j][:, None, None] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    Xc = torch.stack([(uu - cx) / fx * depth, (vv - cy) / fy * depth, depth], -1)  # [B, H, W, 3]

    lit = torch.ones(n_scenes, H, W, dtype=torch.float32, device=dev)
    if enable_shadows:
        S = shadow_size
        T_LO = torch.einsum("mij,mjk->mik", T_LC[scene_of], TCO)
        shadow = render_batch_fused(assets, obj_ids, T_LO, K_L[scene_of], resolution=(S, S))
        zmap = scene_zmin(shadow, scene_of, valid, n_scenes)[1]
        # project composite pixels into the light camera; sample points are
        # pushed along the surface normal (slope-scaled) against acne on
        # grazing-lit surfaces
        offset = (0.004 + 0.02 * (1.0 - lambert))[..., None] * normals
        Xl = (torch.einsum("bij,bhwj->bhwi", T_LC[:, :3, :3], Xc + offset)
              + T_LC[:, None, None, :3, 3])
        zl = Xl[..., 2]
        zc = torch.clamp(zl, min=1e-3)
        ul = K_L[:, 0, 0][:, None, None] * Xl[..., 0] / zc + K_L[:, 0, 2][:, None, None]
        vl = K_L[:, 1, 1][:, None, None] * Xl[..., 1] / zc + K_L[:, 1, 2][:, None, None]
        iu = torch.clamp(torch.round(ul).to(torch.int64), 0, S - 1)
        iv = torch.clamp(torch.round(vl).to(torch.int64), 0, S - 1)
        inside = (ul >= 0) & (ul <= S - 1) & (vl >= 0) & (vl <= S - 1) & (zl > 0)
        zref = torch.gather(zmap.reshape(n_scenes, -1), 1,
                            (iv * S + iu).reshape(n_scenes, -1)).reshape(n_scenes, H, W)
        # depth compare with a bias against shadow acne
        occluded = inside & torch.isfinite(zref) & (zl > zref + 0.008)
        lit = torch.where(occluded, 0.0, 1.0)

    amb = lights[:, 3][:, None, None]
    dif = lights[:, 4][:, None, None]
    shade_full = torch.clamp(amb + dif * lambert, 0.0, 1.0)
    shade_shadowed = torch.clamp(amb + dif * lambert * lit, 0.0, 1.0)
    rgb = rgb * (shade_shadowed / torch.clamp(shade_full, min=1e-3))[..., None]

    # Blinn-Phong specular highlight (white), none inside shadows and none on
    # surfaces facing away from the light
    vdir = -Xc / torch.clamp(torch.linalg.vector_norm(Xc, dim=-1, keepdim=True), min=1e-6)
    h = d[:, None, None, :] + vdir
    h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-6)
    ndoth = torch.clamp(torch.einsum("bhwc,bhwc->bhw", normals, h), min=0.0)
    spec_k = materials[:, 0][:, None, None]
    shininess = materials[:, 1][:, None, None]
    spec = spec_k * lit * ndoth ** shininess * (lambert > 0)
    rgb = rgb + spec[..., None] * mask[..., None]

    # background composite + sensor model
    bg = bg_pool[bg_idx.to(torch.int64)].to(torch.float32) / 255.0
    bg = torch.clamp(bg * bg_gain[:, None, None, :], 0.0, 1.0)
    rgb = torch.where(mask[..., None], rgb, bg)
    rgb = _gaussian_blur5(rgb, materials[:, 2])
    rgb = rgb + materials[:, 3][:, None, None, None] * noise
    rgb_u8 = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8)
    return RecordBatch(rgb=rgb_u8, depth=depth, visib_px=visib_px, solo_px=solo_px,
                       bbox=bbox, any_vis=any_vis, border_bad=any_touch)


def make_floor_mesh(
    half_size: float = 0.45, n_grid: int = 16, seed: int = 7, texture_size: int = 128,
) -> Mesh:
    """Textured ground plane (z = 0, +z normal), a grid of 2 n_grid^2
    triangles, that receives shadows in resting scenes (the reference's
    `show_plane`, bop_recording_scene.py:84-90)."""
    lin = np.linspace(-half_size, half_size, n_grid + 1, dtype=np.float32)
    xx, yy = np.meshgrid(lin, lin, indexing="ij")
    verts = np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(-1, 3)
    uv = np.stack(
        [(xx + half_size) / (2 * half_size), (yy + half_size) / (2 * half_size)], -1
    ).reshape(-1, 2).astype(np.float32)
    faces = []
    for i in range(n_grid):
        for j in range(n_grid):
            a = i * (n_grid + 1) + j
            b = a + 1
            c = a + (n_grid + 1)
            faces += [[a, c, b], [b, c, c + 1]]
    rs = np.random.RandomState(seed)
    return Mesh(
        vertices=verts,
        faces=np.asarray(faces, np.int32),
        vertex_colors=np.full((len(verts), 3), 0.6, np.float32),
        vertex_uv=uv,
        texture=make_random_texture(rs, texture_size),
    )


def light_camera(
    light_dir: np.ndarray, TCO: np.ndarray, valid: np.ndarray,
    diameters: np.ndarray, shadow_size: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """A pinhole "light camera" along the directional light, framing the
    valid objects, so a depth render from it approximates a directional
    shadow map. Returns (T_LC light-camera-from-camera, K_L)."""
    d = light_dir / max(np.linalg.norm(light_dir), 1e-8)
    t = TCO[valid, :3, 3]
    diam = diameters[valid] if valid.any() else np.asarray([0.1])
    center = t.mean(0) if len(t) else np.zeros(3)
    r = 0.15
    if len(t):
        r = max(r, float((np.linalg.norm(t - center, axis=-1) + diam / 2).max()))
    rho = 2.5 * r + 0.3
    pos = center + d * rho
    z = -d  # looks back at the scene centre
    up = np.zeros(3)
    up[int(np.argmin(np.abs(z)))] = 1.0
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T_CL = np.eye(4, dtype=np.float32)
    T_CL[:3, :3] = np.stack([x, y, z], -1)
    T_CL[:3, 3] = pos
    T_LC = np.linalg.inv(T_CL).astype(np.float32)
    f = 0.42 * shadow_size * rho / r
    K_L = np.asarray(
        [[f, 0, shadow_size / 2], [0, f, shadow_size / 2], [0, 0, 1]], np.float32)
    return T_LC, K_L


@dataclass
class RecordedFrame:
    """Host-side result for one accepted frame."""

    rgb: np.ndarray  # [H, W, 3] uint8
    depth: np.ndarray  # [H, W] float32
    K: np.ndarray
    TWC: np.ndarray
    labels: List[str]
    TCO: np.ndarray  # [n, 4, 4]
    bboxes: np.ndarray  # [n, 4]
    visib_fract: np.ndarray  # [n]


class BatchedSceneRecorder:
    """Records domain-randomized frames in device batches of `batch_scenes`
    scenes (each batch one `record_scene_batch` call, two kernel launches
    with shadows):

        rec = BatchedSceneRecorder(mesh_db, cfg, seed=0)
        frames = rec.record(4096)   # list of RecordedFrame

    Every host draw (scenes, backgrounds, the noise seed) follows the JAX
    package's numpy streams, so the same seed samples the same scenes."""

    def __init__(
        self,
        mesh_db: MeshDataBase,
        cfg: Optional[SceneSynthConfig] = None,
        seed: int = 0,
        batch_scenes: int = 16,
        floor: bool = True,
        shadows: bool = True,
        shadow_size: int = 256,
        n_backgrounds: int = 64,
        randomize_object_textures: bool = False,
        min_annot_px: int = 4,
        device="cuda",
    ):
        cfg = cfg or SceneSynthConfig()
        self.db = mesh_db
        self.cfg = cfg
        self.device = torch.device(device)
        self.synth = SceneSynthesizer(mesh_db, cfg, seed=seed)
        self.rs = np.random.RandomState(seed + 1)
        self.batch_scenes = batch_scenes
        self.floor = floor
        self.shadows = shadows
        self.shadow_size = shadow_size
        self.min_annot_px = min_annot_px
        self.randomize_object_textures = randomize_object_textures
        self.n_max = cfg.n_objects_interval[1] + (1 if floor else 0)

        render_meshes = dict(mesh_db.meshes)
        if floor:
            if FLOOR_LABEL in render_meshes or not all(l < FLOOR_LABEL for l in mesh_db.labels):
                raise ValueError(f"the floor's label {FLOOR_LABEL!r} must sort last")
            render_meshes[FLOOR_LABEL] = make_floor_mesh(seed=seed + 13)
        self.render_db = MeshDataBase(
            render_meshes, symmetries=mesh_db.symmetries, scales=mesh_db.scales)
        self.floor_id = self.render_db.label_to_id[FLOOR_LABEL] if floor else -1
        self.assets = self.render_db.render_assets(texture_size=128, device=self.device)
        self._diam = np.asarray(
            [self.render_db.meshes[l].diameter * self.render_db.scales.get(l, 1.0)
             for l in self.render_db.labels], np.float32)

        # background library, on the device once; a scene picks one and a gain
        H, W = cfg.resolution
        pool = np.stack([make_random_texture(self.rs, max(H, W))[:H, :W]
                         for _ in range(n_backgrounds)])
        self.bg_pool = torch.from_numpy((pool * 255).astype(np.uint8)).to(self.device)

    def _refresh_object_textures(self) -> None:
        """New random textures on the textured objects (not the floor): the
        reference's `textures_on_objects`, once a batch."""
        tex = self.assets.textures.cpu().numpy().copy()
        has_texture = self.assets.has_texture.cpu().numpy()
        for i, label in enumerate(self.render_db.labels):
            if label != FLOOR_LABEL and has_texture[i]:
                tex[i] = make_random_texture(self.rs, tex.shape[1])
        self.assets = dataclasses.replace(
            self.assets, textures=torch.from_numpy(tex).to(self.device))

    def _sample_batch(self, scenes: Optional[List[SynthScene]] = None):
        """The batch's scenes and `record_scene_batch`'s tensor inputs."""
        B, N = self.batch_scenes, self.n_max
        if scenes is None:
            scenes = [self.synth.sample_scene() for _ in range(B)]
        if len(scenes) != B:
            raise ValueError(f"{len(scenes)} scenes for a batch of {B}")
        M = B * N
        obj_ids = np.zeros(M, np.int64)
        scene_of = np.repeat(np.arange(B, dtype=np.int64), N)
        TCO = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
        TCO[:, 2, 3] = 10.0  # parked far behind everything
        valid = np.zeros(M, bool)
        annotate = np.zeros(M, bool)
        K = np.zeros((B, 3, 3), np.float32)
        lights = np.zeros((B, 5), np.float32)
        mats = np.zeros((B, 4), np.float32)
        T_LC = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        K_L = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        for b, sc in enumerate(scenes):
            n = len(sc.obj_ids)
            sl = slice(b * N, b * N + n)
            obj_ids[sl] = sc.obj_ids
            TCO[sl] = sc.TCO
            valid[sl] = True
            annotate[sl] = True
            if self.floor and sc.falling:
                k = b * N + self.n_max - 1
                obj_ids[k] = self.floor_id
                TCO[k] = np.linalg.inv(sc.TWC)  # the floor's frame is the world's
                valid[k] = True
            K[b] = sc.K
            lights[b] = sc.light
            mats[b] = sc.material
            # the shadow map frames the annotated objects only (the floor
            # extends past it; floor pixels outside it stay lit)
            T_LC[b], K_L[b] = light_camera(
                sc.light[:3], TCO[b * N: (b + 1) * N], annotate[b * N: (b + 1) * N],
                self._diam[obj_ids[b * N: (b + 1) * N]], self.shadow_size)
        bg_idx = self.rs.randint(self.bg_pool.shape[0], size=B)
        bg_gain = self.rs.uniform(0.3, 1.0, (B, 3)).astype(np.float32)
        arrays = dict(obj_ids=obj_ids, scene_of=scene_of, TCO=TCO, K=K, valid=valid,
                      annotate=annotate, lights=lights, T_LC=T_LC, K_L=K_L, materials=mats,
                      bg_idx=bg_idx.astype(np.int64), bg_gain=bg_gain)
        return scenes, {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}

    def record_batch(self, scenes: Optional[List[SynthScene]] = None):
        """One device batch: (its scenes, its `RecordBatch` on the device)."""
        if self.randomize_object_textures:
            self._refresh_object_textures()
        scenes, inputs = self._sample_batch(scenes)
        # the noise seed is drawn where JAX draws its key, keeping the numpy
        # stream (and so every later batch) the JAX package's
        noise_seed = int(self.rs.randint(2**31))
        H, W = self.cfg.resolution
        g = torch.Generator(device=self.device).manual_seed(noise_seed)
        noise = torch.randn(self.batch_scenes, H, W, 3, generator=g, device=self.device)
        out = record_scene_batch(
            self.assets, noise=noise, n_scenes=self.batch_scenes,
            resolution=self.cfg.resolution, shadow_size=self.shadow_size,
            enable_shadows=self.shadows, bg_pool=self.bg_pool, **inputs)
        return scenes, out

    def frames_of(self, scenes: List[SynthScene], out: RecordBatch) -> List[Optional[RecordedFrame]]:
        """A frame a scene, None where the border check or the visibility
        rejected it."""
        out = RecordBatch(*(x.cpu().numpy() for x in out))
        N = self.n_max
        frames: List[Optional[RecordedFrame]] = []
        for b, sc in enumerate(scenes):
            if not out.any_vis[b] or (self.cfg.border_check and out.border_bad[b]):
                frames.append(None)
                continue
            labels, tcos, bbs, vf = [], [], [], []
            for j in range(len(sc.obj_ids)):
                m = b * N + j
                if out.visib_px[m] < self.min_annot_px:
                    continue
                labels.append(self.db.labels[int(sc.obj_ids[j])])
                tcos.append(sc.TCO[j])
                bbs.append(out.bbox[m])
                vf.append(out.visib_px[m] / max(int(out.solo_px[m]), 1))
            if not labels:
                frames.append(None)
                continue
            frames.append(RecordedFrame(
                rgb=out.rgb[b], depth=out.depth[b], K=sc.K, TWC=sc.TWC, labels=labels,
                TCO=np.stack(tcos), bboxes=np.asarray(bbs, np.float32),
                visib_fract=np.asarray(vf, np.float32),
            ))
        return frames

    def _render_frames(self, scenes: Optional[List[SynthScene]] = None) -> List[Optional[RecordedFrame]]:
        return self.frames_of(*self.record_batch(scenes))

    def record(self, n_frames: int, max_batches: Optional[int] = None,
               progress_every: int = 0) -> List[RecordedFrame]:
        frames: List[RecordedFrame] = []
        n_batches = 0
        limit = max_batches or (n_frames // self.batch_scenes + 1) * 20
        while len(frames) < n_frames and n_batches < limit:
            got = [f for f in self._render_frames() if f is not None]
            frames.extend(got[: n_frames - len(frames)])
            n_batches += 1
            if progress_every and n_batches % progress_every == 0:
                get_logger(__name__).info(
                    f"recorded {len(frames)}/{n_frames} frames ({n_batches} batches)")
        return frames

    def record_multiview(
        self, n_scenes: int, n_views: int, min_views: int = 2,
        max_rounds: Optional[int] = None,
    ) -> List[List[RecordedFrame]]:
        """Multi-view scenes: one world layout seen from `n_views` cameras.
        The light is fixed in the world frame (each view's row holds its
        direction rotated into that camera's frame), so the shading agrees
        between views. Returns a list a scene of >= `min_views` frames in
        view order; each frame's TWC is its camera."""
        groups: List[List[RecordedFrame]] = []
        per_batch = max(1, self.batch_scenes // n_views)
        rounds = 0
        limit = max_rounds or (n_scenes // per_batch + 1) * 20
        while len(groups) < n_scenes and rounds < limit:
            rounds += 1
            entries: List[SynthScene] = []
            for _ in range(per_batch):
                sc = self.synth.sample_scene()
                d_world = sc.TWC[:3, :3] @ sc.light[:3]
                entries.append(sc)
                target = sc.TWO[:, :3, 3].mean(0)
                for _v in range(1, n_views):
                    TWC_v, K_v = self.synth.sample_camera(target)
                    light_v = np.concatenate(
                        [TWC_v[:3, :3].T @ d_world, sc.light[3:]]).astype(np.float32)
                    entries.append(dataclasses.replace(
                        sc, TWC=TWC_v.astype(np.float32), K=K_v, light=light_v))
            pad = self.batch_scenes - len(entries)
            frames = self._render_frames(entries + [entries[-1]] * pad)[: len(entries)]
            for s in range(per_batch):
                views = [f for f in frames[s * n_views: (s + 1) * n_views] if f is not None]
                if len(views) >= min_views and len(groups) < n_scenes:
                    groups.append(views)
        return groups
