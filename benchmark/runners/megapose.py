"""What the MegaPose cells share: the world made from the seed (objects,
both networks' weights, the traffic and its images), the program built
from it through the port's `load_named_model`, and the reference's view of
the same world."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import flops, traffic, world
from benchmark.reference import geometry as G
from benchmark.reference import megapose as ref
from benchmark.reference import nets, raster

N_POSE = 9  # ortho6d rotation + (vx, vy, vz)


def refiner_table(n_inputs: int):
    return nets.resnet34_params(n_inputs) + [
        ("pose_fc.weight", (N_POSE, nets.N_FEATURES), "pose_head"),
        ("pose_fc.bias", (N_POSE,), "pose_bias")]


def coarse_table(n_inputs: int):
    return nets.resnet34_params(n_inputs) + [
        ("views_logits_head.weight", (1, nets.N_FEATURES), "linear"),
        ("views_logits_head.bias", (1,), "zero")]


class MegaPoseWorld:
    """The seed's world for a MegaPose configuration and one traffic mix."""

    def __init__(self, cell: Dict, seed: int, device: torch.device):
        cfg, mix = cell["config_spec"], cell["mix_spec"]
        self.cfg, self.device = cfg, device
        self.size = tuple(cfg["render_size"])
        self.objects = world.make_objects(np.random.default_rng([seed % (1 << 63), 1]),
                                          cfg["objects"])
        gen = world.device_generator(seed, device)
        self.n_inputs = 3 + 3 + (3 if cfg["render_normals"] else 0)
        self.P_refiner = world.make_weights(refiner_table(self.n_inputs), gen, device,
                                            cfg["weights"])
        self.P_coarse = world.make_weights(coarse_table(self.n_inputs), gen, device,
                                           cfg["weights"])
        self.traffic = traffic.generate(mix, seed, cfg["objects"]["count"])
        self.images = world.make_images(gen, self.traffic["images"], mix["image_size"], device)
        self.meshes = world.reference_meshes(self.objects, device)
        self.points, self.points_mask = world.model_points(self.objects, cfg["n_points"], device)
        self.forward_flops = {n: flops.forward_flops(cfg["backbone"], self.n_inputs, *self.size, n)
                              for n in (1, N_POSE)}

    def program(self):
        """The port's estimator of the configuration, with these weights."""
        from happypose_tpu_torch.inference.types import InferenceConfig
        from happypose_tpu_torch.models.pose_predictor import PosePredictorConfig
        from happypose_tpu_torch.utils.load_model import NamedModelSpec, load_named_model

        cfg = self.cfg
        model = dict(backbone=cfg["backbone"], render_size=self.size,
                     render_normals=cfg["render_normals"], crop_lamb=cfg["crop_lambda"])
        spec = NamedModelSpec(
            refiner_cfg=PosePredictorConfig(**model),
            coarse_cfg=PosePredictorConfig(**model, predict_pose_update=False,
                                           predict_rendered_views_logits=True),
            inference_cfg=InferenceConfig(
                n_refiner_iterations=cfg["n_refiner_iterations"],
                SO3_grid_size=cfg["so3_grid_size"], n_pose_hypotheses=cfg["n_pose_hypotheses"]))
        return load_named_model(spec, world.program_database(self.objects),
                                n_points=cfg["n_points"], device=self.device,
                                state_dicts={"refiner": self.P_refiner, "coarse": self.P_coarse})

    def scene(self, image: int, K: np.ndarray) -> ref.Scene:
        img = torch.from_numpy(self.images[image]).to(self.device).permute(2, 0, 1)[None]
        return ref.Scene(image=img.contiguous(), K=torch.from_numpy(K).to(self.device)[None],
                         meshes=self.meshes, points=self.points, points_mask=self.points_mask)

    def render_work(self, scene: ref.Scene, obj_ids, T_in):
        return render_work(self.objects, scene, obj_ids, T_in, self.size)

    def grid(self) -> torch.Tensor:
        return G.so3_grid(self.cfg["so3_grid_size"], self.device)


def render_work(objects, scene: ref.Scene, obj_ids, T_in, size):
    """(bytes, pixel tests) of rendering each pose of `T_in` in its
    iteration's crop camera: each render reads its mesh (positions,
    normals, uv, face indices) and camera once and writes its image of
    7 float32 channels once."""
    B = T_in.shape[0]
    if not B:
        return 0, 0
    T, _, K_crop, _ = ref.crop_camera(scene.K.expand(B, 3, 3), scene.image.shape[-2:],
                                      scene.points, scene.points_mask, obj_ids, T_in, size)
    V, F = objects["vertices"].shape[1], objects["faces"].shape[1]
    per = 4 * (V * 8 + F * 3) + 4 * (16 + 9) + 4 * 7 * size[0] * size[1]
    return per * B, int(raster.pixel_tests(scene.meshes, obj_ids, T, K_crop, size).sum())


def pick_sample(records, rng: np.random.Generator, n: int):
    """`n` records drawn from the seed, the one with the most units first."""
    if not records:
        return []
    largest = max(range(len(records)), key=lambda i: records[i].units)
    rest = [i for i in range(len(records)) if i != largest]
    chosen = [largest] + list(rng.choice(rest, size=min(n - 1, len(rest)), replace=False))
    return [records[i] for i in chosen]


def worst(per_item, limits: Dict) -> Dict:
    """The largest reading of each number over the items checked, beside
    its limit."""
    names = list(limits)
    return {k: {"value": max((float(p[k]) for p in per_item), default=float("nan")),
                "limit": limits[k]} for k in names}
