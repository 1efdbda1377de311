"""MegaPose refiner training on synthetic batches: each step draws its
scenes and pose noise from the seed on the card, renders the batch through
the port's `make_synth_batch` and takes one `TrainStep` of
`make_refiner_loss_fn` (each a CUDA graph replay after the first), in a
closed loop (the step's metrics are read on the host).

Set-up builds one train state. Its first step captures the synthetic
batch's and the train step's graphs (the step itself runs as the graphs'
eager warm-up); the parameters, batch-norm statistics, Adam's moments and
steps and the update count are then put back in place to their initial
values, so that the captured storage stays the same. The next
`CHECKED_STEPS` steps are replays, through the window's own call; the window
goes on with the same state. The reference follows those steps from the
same weights and draws:
- `loss_gap`: the first checked step's loss, relative to the reference's;
- `loss_gap_later`: the same for the later checked steps, whose losses
  move by the first updates' round-off (see `change_gap`);
- `grad_gap`: the first checked step's clipped gradient as Adam's first
  moment holds it (mu / (1 - b1)), leaf by leaf: the gap between the two
  norms over the reference's norm of that leaf or of the median leaf,
  whichever is larger, the worst leaf;
- `change_gap`: the same for each parameter's change over the checked
  steps, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's. Adam's first updates are near lr * sign(g) an
  entry, so an entry whose gradient is round-off moves by a full step
  either way: this number is held only against a state left unchanged (it
  reads 1).

With `control`, the reference takes the program's place: in TF32
("tf32"), or with half of each batch left out of the loss, the mean taken
over the rest ("half").
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from benchmark import world
from benchmark.runners.megapose import MegaPoseWorld
from benchmark.harness import Record
from benchmark.reference import geometry as G
from benchmark.reference import megapose as ref
from benchmark.reference import training as T_ref

CHECKED_STEPS = 3


class Runner:
    CONTROLS = ("tf32", "half")

    def __init__(self, cell: Dict, seed: int, device: torch.device):
        self.w = w = MegaPoseWorld(cell, seed, device)
        self.cell, self.device = cell, device
        self.mix = mix = cell["mix_spec"]
        self.traffic = w.traffic
        self.B, self.size_img = mix["batch_size"], tuple(mix["image_size"])
        H, W = self.size_img
        f = mix["focal_px"]
        self.K1 = torch.tensor([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]], device=device)
        self.gen = world.device_generator(seed + 1, device)
        self._build_program()

    def _build_program(self):
        from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
        from happypose_tpu_torch.training.forward_loss import make_refiner_loss_fn
        from happypose_tpu_torch.training.trainer import TrainState, make_optimizer, make_train_step

        w, opt_cfg = self.w, self.mix["optimizer"]
        with torch.device(self.device):
            model = PosePredictor(PosePredictorConfig(
                backbone=w.cfg["backbone"], render_size=w.size,
                render_normals=w.cfg["render_normals"], crop_lamb=w.cfg["crop_lambda"]))
        model.load_state_dict(w.P_refiner)
        db = world.program_database(w.objects)
        self.assets = db.render_assets(device=self.device)
        meshes = db.batched(n_points=w.cfg["n_points"], device=self.device)
        self.loss_fn = make_refiner_loss_fn(model, self.assets, meshes,
                                            n_iterations=self.mix["n_iterations"])
        self.step = make_train_step(self.loss_fn)
        opt = make_optimizer(model.parameters(), lr=opt_cfg["lr"],
                             n_warmup_steps=opt_cfg["warmup_steps"],
                             clip_grad_norm=opt_cfg["clip_grad_norm"])
        self.state = TrainState(model, opt)

    def draws(self):
        """One step's scenes and pose noise, drawn on the card: uniform
        objects and rotations, xy and depth in the mix's ranges, a uniform
        background, pixel and pose noise."""
        g, B, dev, m = self.gen, self.B, self.device, self.mix
        H, W = self.size_img
        R = G.rotation_from_quat(torch.randn(B, 4, generator=g, device=dev))
        u = torch.rand(B, 3, generator=g, device=dev)
        e = torch.randn(B, 6, generator=g, device=dev)
        scene = {
            "obj_ids": torch.randint(0, self.w.cfg["objects"]["count"], (B,), generator=g,
                                     device=dev),
            "R": R,
            "xy": (u[:, :2] * 2 - 1) * m["xy_extent_m"],
            "z": m["depth_m"][0] + (m["depth_m"][1] - m["depth_m"][0]) * u[:, 2:3],
            "bg": torch.rand(B, H, W, 3, generator=g, device=dev),
            "noise": torch.randn(B, H, W, 3, generator=g, device=dev)}
        noise = {"euler": e[:, :3] * torch.tensor(m["euler_deg_std"], device=dev) * (np.pi / 180),
                 "trans": e[:, 3:] * torch.tensor(m["trans_std_m"], device=dev)}
        return scene, noise

    def warm(self):
        """The capturing step, the state put back in place, then the checked
        steps: replays of both graphs, as the window's are."""
        model, opt = self.state.model, self.state.optimizer
        params = dict(model.named_parameters())
        p0 = {k: v.detach().clone() for k, v in params.items()}
        b0 = [b.detach().clone() for b in model.buffers()]
        self.run(self.traffic["items"][0])
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(p0[k])
            for b, v in zip(model.buffers(), b0):
                b.copy_(v)
            for t in opt.state_tensors():  # the update count, Adam's steps and moments
                t.zero_()
        self.state.step = 0
        steps = []
        for i in range(CHECKED_STEPS):
            steps.append(self.run(self.traffic["items"][1 + i], keep=True).keep)
            if i == 0:
                adam = opt.adam
                b1 = adam.param_groups[0]["betas"][0]
                g1 = {k: adam.state[p]["exp_avg"] / (1 - b1) for k, p in params.items()}
        change = {k: v.detach() - p0[k] for k, v in params.items()}
        self.checked = {"steps": steps, "losses": [s["loss"] for s in steps], "g1": g1,
                        "change": change}
        print(f"benchmark: 1 capturing + {CHECKED_STEPS} replayed steps in set-up, checked "
              f"losses {self.checked['losses']}", file=sys.stderr)

    def run(self, item, keep: bool = False) -> Record:
        from happypose_tpu_torch.training.synth_data import make_synth_batch

        scene, noise = self.draws()
        batch = make_synth_batch(self.assets, self.K1, scene)
        metrics = self.step(self.state, batch, noise)
        ok = np.isfinite(metrics["loss"]) and not metrics["skipped_nonfinite"]
        kept = {"scene": scene, "noise": noise, "loss": metrics["loss"]} if keep else None
        f = self.w.forward_flops[9]
        return Record(0.0, 0.0, units=self.B, ok=bool(ok), keep=kept,
                      model_flops=3.0 * self.B * self.mix["n_iterations"] * f)

    def release(self):
        del self.state, self.step, self.loss_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def follow(self, tf32: bool = False, half: bool = False):
        """The reference's first steps from the same weights and draws:
        their losses, the first step's clipped gradient and the change of
        every parameter over them; `half`: the loss of the first half of
        each batch."""
        w, m, opt = self.w, self.mix, self.mix["optimizer"]
        P = {k: v.clone() for k, v in w.P_refiner.items()}
        names = T_ref.trainable(P)
        for k in names:
            P[k].requires_grad_(True)
        adam = T_ref.Adam([P[k] for k in names], opt["lr"], opt["warmup_steps"],
                          opt["clip_grad_norm"])
        losses, g1 = [], None
        for step in self.checked["steps"]:
            scene, noise = step["scene"], step["noise"]
            with ref.precision(tf32, self.device), torch.no_grad():
                images, T_gt = T_ref.synth_images(w.meshes, self.K1, scene)
                T_in = G.make_T(T_gt[:, :3, :3] @ T_ref.euler_sxyz(noise["euler"]),
                                T_gt[:, :3, 3] + noise["trans"])
            loss = T_ref.step_loss(P, images, self.K1.expand(self.B, 3, 3), scene["obj_ids"],
                                   T_gt, T_in, w.meshes, w.points, w.points_mask, w.size,
                                   m["n_iterations"], tf32=tf32, rows=self.B // 2 if half else None)
            clipped = adam.step(list(torch.autograd.grad(loss, [P[k] for k in names])))
            losses.append(loss.item())
            g1 = g1 or dict(zip(names, clipped))
        return losses, g1, {k: P[k].detach() - w.P_refiner[k] for k in names}

    def check(self, records, rng: np.random.Generator, control=None) -> Dict:
        """The checked steps against the reference's (the window's steps
        advance the state that was checked)."""
        ref_losses, ref_g1, ref_change = self.follow()
        if control:
            losses, g1, change = self.follow(tf32=control == "tf32", half=control == "half")
        else:
            c = self.checked
            losses, g1, change = c["losses"], c["g1"], c["change"]

        def norms(tree):
            return {k: float(torch.linalg.vector_norm(v)) for k, v in tree.items()}

        def leaf_gap(a, b, leaves):
            na, nb = norms(a), norms(b)
            med = float(np.median(list(nb.values())))
            return max(abs(na[k] - nb[k]) / max(nb[k], med) for k in leaves)

        g_ref = norms(ref_g1)
        g_med = float(np.median(list(g_ref.values())))
        moved = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        values = {
            "loss_gap": loss_gaps[0],
            "loss_gap_later": max(loss_gaps[1:]),
            "grad_gap": leaf_gap(g1, ref_g1, list(ref_g1)),
            "change_gap": leaf_gap(change, ref_change, moved),
        }
        return {k: {"value": values[k], "limit": self.cell["limits"][k]} for k in values}
