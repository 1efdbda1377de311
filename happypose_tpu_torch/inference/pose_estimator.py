"""Single-view pose estimation (PyTorch port of
`happypose_tpu/inference/pose_estimator.py`). Two flavours, chosen by the
coarse model:

- MegaPose (a coarse hypothesis classifier): each detection is replicated
  over the SO(3) grid with an autodepth init, every hypothesis is scored,
  the top-K per detection are refined, re-scored, and the best one is kept.
- CosyPose (a coarse pose model, or none): each detection starts at the
  z-up autodepth init, the coarse model runs `n_coarse_iterations` pose
  updates, the refiner `n_refiner_iterations`.

With `cfg.run_depth_refiner` and an observation that has depth, the final
poses of either flavour are then refined against the observed depth
(`run_depth_refiner`: ICP or GNC-TLS, one depth render of all estimates).

The hypothesis axis is cut into chunks of `bsz_images` (coarse scoring)
and `bsz_objects` (pose updates); each chunk is one model call and one
render batch per iteration. With a `device_mesh`, the coarse hypotheses
are split over the ranks of its `mesh_axis`: each rank scores its block,
in chunks of `bsz_images`, and the logits are gathered on every rank;
every later stage runs on every rank, as JAX's does.

The JAX package's compiled entry points are CUDA graphs here
(`utils/cuda_graphs.py`): `forward_coarse_jit` and
`run_inference_pipeline_jit` capture a whole stage or frame once per shape
key and replay it per frame; the stage programs `_coarse_logits_fn` and
`_refine_fn` capture one chunk of one model. As in the JAX package, every
chunk of pose updates (`forward_refiner`, CosyPose's coarse model) goes
through `_refine_fn`: called alone (a tracked frame) each chunk is one
replay of its shape's graph; inside a frame's graph it runs plainly and
the frame's graph records it. The other methods run eagerly.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Tuple

import torch

from happypose_tpu_torch.inference.icp_refiner import ICPRefiner
from happypose_tpu_torch.inference.teaser_refiner import TeaserRefiner
from happypose_tpu_torch.inference.types import (
    DetectionBatch,
    InferenceConfig,
    ObservationBatch,
    PoseEstimateBatch,
)
from happypose_tpu_torch.lib3d.pose_init import (
    TCO_init_from_boxes_autodepth_with_R,
    TCO_init_from_boxes_zup_autodepth,
)
from happypose_tpu_torch.lib3d.so3_grid import load_SO3_grid
from happypose_tpu_torch.meshes.database import BatchedMeshes, RenderAssets
from happypose_tpu_torch.models.pose_predictor import PosePredictor
from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused
from happypose_tpu_torch.ops.segment_ops import group_keys, topk_per_group
from happypose_tpu_torch.parallel.collectives import sharded_batch_apply
from happypose_tpu_torch.utils.cuda_graphs import GraphCache, storage_of
from happypose_tpu_torch.utils.profiling import annotate, stage


def _model_images(model: PosePredictor, obs: ObservationBatch) -> torch.Tensor:
    """The frames `model` reads: an RGB model drops a depth channel anyway,
    so it is not gathered once per hypothesis first."""
    return obs.images if model.cfg.input_depth else obs.rgb


# The stage programs' graphs, one cache a model: JAX's module-level jits key
# on the model; here a model's graphs go when the model does.
_stage_graphs: "weakref.WeakKeyDictionary[PosePredictor, GraphCache]" = weakref.WeakKeyDictionary()


def _stage_call(model: PosePredictor, key, fn, args, assets):
    graphs = _stage_graphs.get(model)
    if graphs is None:
        graphs = _stage_graphs[model] = GraphCache("stage")
    key = (key, model.cfg, model.training, storage_of(model))
    return graphs(key, fn, args, captured=(assets,))


def _coarse_logits(model, images, K, obj_ids, TCO, assets, meshes) -> torch.Tensor:
    """The coarse classifier's logits [chunk] of one chunk of hypotheses
    (`meshes`: the chunk's rows, `select(obj_ids)`)."""
    out = model(images, K, obj_ids, TCO, assets, meshes, n_iterations=1)
    return out.renderings_logits[0, :, 0]


def _coarse_logits_fn(model, images, K, obj_ids, TCO, assets, meshes) -> torch.Tensor:
    """`_coarse_logits` through the model's graph of this chunk's shapes; a
    ragged last chunk has its own."""
    def logits(images, K, obj_ids, TCO, meshes):
        return _coarse_logits(model, images, K, obj_ids, TCO, assets, meshes)

    return _stage_call(model, "coarse_logits", logits, (images, K, obj_ids, TCO, meshes), assets)


def _refine_fn(model, images, K, obj_ids, TCO, assets, meshes, n_iterations) -> torch.Tensor:
    """`n_iterations` pose updates of one chunk: TCO_output [n_iterations,
    chunk, 4, 4], through the model's graph of this chunk's shapes and
    `n_iterations`."""
    def refine(images, K, obj_ids, TCO, meshes):
        return model(images, K, obj_ids, TCO, assets, meshes, n_iterations=n_iterations).TCO_output

    return _stage_call(model, ("refine", n_iterations), refine,
                       (images, K, obj_ids, TCO, meshes), assets)


class PoseEstimator:
    """Orchestrates the pipelines.

    refiner: pose-update PosePredictor; coarse: a hypothesis-classifier
    PosePredictor (`predict_rendered_views_logits`: MegaPose), a pose-update
    PosePredictor (CosyPose) or None (CosyPose without a coarse model);
    assets / meshes: the padded mesh database on the device the pipeline
    runs on; device_mesh: a `DeviceMesh` (`parallel.make_mesh`) whose
    `mesh_axis` splits the coarse hypotheses over its ranks, or None.
    """

    def __init__(
        self,
        refiner: PosePredictor,
        coarse: Optional[PosePredictor],
        assets: RenderAssets,
        meshes: BatchedMeshes,
        cfg: InferenceConfig = InferenceConfig(),
        device_mesh=None,
        mesh_axis: str = "hp",
    ):
        self.refiner_model = refiner
        self.coarse_model = coarse
        self._coarse_is_classifier = (
            coarse is not None and coarse.cfg.predict_rendered_views_logits
        )
        self.assets = assets
        self.meshes = meshes
        self.cfg = cfg
        self.device_mesh = device_mesh
        self.mesh_axis = mesh_axis
        self.SO3_grid = torch.from_numpy(load_SO3_grid(cfg.SO3_grid_size)).to(
            assets.vertices.device
        )
        self._depth_refiners: Dict[tuple, object] = {}
        self._pipeline_jit_cache = GraphCache("pipeline")

    # ------------------------------------------------------------------
    # MegaPose coarse: score detections x SO(3)-grid hypotheses
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def forward_coarse(
        self, obs: ObservationBatch, detections: DetectionBatch
    ) -> PoseEstimateBatch:
        """Replicate each detection over the SO(3) grid, init TCO with
        autodepth, score every hypothesis with the coarse classifier."""
        with stage("estimator.coarse"):
            D = detections.n_rows
            M = self.SO3_grid.shape[0]  # the loaded grid's size
            dev = self.SO3_grid.device
            det_idx = torch.arange(D, device=dev).repeat_interleave(M)
            hyp_ids = torch.arange(M, device=dev).repeat(D)
            boxes = detections.boxes[det_idx]
            obj_ids = detections.obj_ids[det_idx]
            im_ids = detections.batch_im_ids[det_idx]
            valid = detections.valid[det_idx]
            R = self.SO3_grid.repeat(D, 1, 1)
            K = obs.K[im_ids]

            inst = self.meshes.select(obj_ids)
            TCO_init = TCO_init_from_boxes_autodepth_with_R(
                boxes, inst.points, K, R, inst.points_mask
            )
            logits = self._score_hypotheses(obs, K, obj_ids, im_ids, TCO_init)
            logits = torch.where(valid, logits, torch.full_like(logits, -torch.inf))
            return PoseEstimateBatch(
                poses=TCO_init,
                K=K,
                obj_ids=obj_ids,
                batch_im_ids=im_ids,
                instance_ids=detections.instance_ids[det_idx],
                hypothesis_ids=hyp_ids,
                scores=detections.scores[det_idx],
                coarse_logits=logits,
                pose_logits=torch.zeros_like(logits),
                valid=valid,
            )

    def forward_coarse_jit(
        self, obs: ObservationBatch, detections: DetectionBatch
    ) -> PoseEstimateBatch:
        """`forward_coarse` as one CUDA graph per (image shape, detection
        count), replayed per call (on CPU tensors: the same path with a plain
        call)."""
        key = ("coarse", tuple(obs.rgb.shape), detections.n_rows)
        return self._graph_call(key, self.forward_coarse, (obs, detections))

    def _graph_call(self, key, fn, args):
        """`fn(*args)` through `_pipeline_jit_cache`: JAX's key plus the
        configuration, the models' mode and storage, and the captured
        objects' identity."""
        with annotate("estimator.frame"):
            models = [m for m in (self.refiner_model, self.coarse_model) if m is not None]
            key = (key, self.cfg, tuple((m.cfg, m.training) for m in models), storage_of(*models))
            captured = (*models, self.assets, self.meshes, self.SO3_grid)
            return self._pipeline_jit_cache(key, fn, args, captured=captured)

    def _score_hypotheses(self, obs, K, obj_ids, im_ids, TCO) -> torch.Tensor:
        """Coarse-classifier logits [N] of N hypotheses, `bsz_images` at a
        time (split over the mesh axis's ranks with a `device_mesh`)."""
        images = _model_images(self.coarse_model, obs)

        def score(batch):
            Kb, ob, ib, Tb = batch
            logits = []
            for s in range(0, Tb.shape[0], self.cfg.bsz_images):
                sl = slice(s, s + self.cfg.bsz_images)
                logits.append(_coarse_logits(
                    self.coarse_model, images[ib[sl]], Kb[sl], ob[sl], Tb[sl], self.assets,
                    self.meshes.select(ob[sl])))
            return torch.cat(logits)

        batch = (K, obj_ids, im_ids, TCO)
        if self.device_mesh is None:
            return score(batch)
        mesh = self.device_mesh
        N, size = TCO.shape[0], mesh.size(mesh.mesh_dim_names.index(self.mesh_axis))
        # pad to a multiple of the axis size with copies of the last
        # hypothesis (JAX pads zeros; a zero pose would put every vertex at
        # z = 0 in the render), and cut the padded rows' logits off
        pad = -N % size
        batch = tuple(torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) for x in batch)
        return sharded_batch_apply(score, mesh, self.mesh_axis)(batch)[:N]

    # ------------------------------------------------------------------
    # Refiner
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def forward_refiner(
        self, obs: ObservationBatch, estimates: PoseEstimateBatch,
        n_iterations: Optional[int] = None,
    ) -> Tuple[PoseEstimateBatch, Dict[str, PoseEstimateBatch]]:
        """Refine all estimates, `bsz_objects` at a time. Returns (final,
        {"iteration=k": estimates after k iterations})."""
        with stage("estimator.refine"):
            return self._update_poses(
                self.refiner_model, obs, estimates,
                n_iterations or self.cfg.n_refiner_iterations,
            )

    def _update_poses(
        self, model: PosePredictor, obs: ObservationBatch,
        estimates: PoseEstimateBatch, n_iterations: int,
    ) -> Tuple[PoseEstimateBatch, Dict[str, PoseEstimateBatch]]:
        """`n_iterations` pose updates of `model` on all estimates,
        `bsz_objects` at a time, each chunk through `_refine_fn`."""
        images = _model_images(model, obs)
        chunks = []
        for s in range(0, estimates.n_rows, self.cfg.bsz_objects):
            sl = slice(s, s + self.cfg.bsz_objects)
            obj_ids = estimates.obj_ids[sl]
            chunks.append(_refine_fn(  # [n_iter, chunk, 4, 4]
                model, images[estimates.batch_im_ids[sl]], estimates.K[sl], obj_ids,
                estimates.poses[sl], self.assets, self.meshes.select(obj_ids), n_iterations,
            ))
        all_iters = torch.cat(chunks, dim=1)
        per_iter = {
            f"iteration={it + 1}": dataclasses.replace(estimates, poses=all_iters[it])
            for it in range(n_iterations)
        }
        return per_iter[f"iteration={n_iterations}"], per_iter

    # ------------------------------------------------------------------
    # Scoring model (re-score refined poses with the coarse classifier)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def forward_scoring(
        self, obs: ObservationBatch, estimates: PoseEstimateBatch
    ) -> PoseEstimateBatch:
        with stage("estimator.score"):
            logits = self._score_hypotheses(
                obs, estimates.K, estimates.obj_ids, estimates.batch_im_ids,
                estimates.poses,
            )
            logits = torch.where(estimates.valid, logits, torch.full_like(logits, -torch.inf))
            return dataclasses.replace(estimates, pose_logits=logits)

    # ------------------------------------------------------------------
    # Selection
    # ------------------------------------------------------------------

    @staticmethod
    def filter_top_k(
        estimates: PoseEstimateBatch, by: str, k: int
    ) -> PoseEstimateBatch:
        """Group-wise top-k (groups = batch_im_id x obj_id x instance_id)."""
        key = group_keys(
            estimates.batch_im_ids, estimates.obj_ids, estimates.instance_ids
        )
        keep = topk_per_group(key, getattr(estimates, by), estimates.valid, k)
        return dataclasses.replace(estimates, valid=keep)

    # ------------------------------------------------------------------
    # CosyPose: z-up init, coarse pose model
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def make_TCO_init(
        self, obs: ObservationBatch, detections: DetectionBatch
    ) -> PoseEstimateBatch:
        """One estimate per detection at the BOP20 z-up autodepth init."""
        K = obs.K[detections.batch_im_ids]
        inst = self.meshes.select(detections.obj_ids)
        TCO = TCO_init_from_boxes_zup_autodepth(
            detections.boxes, inst.points, K, inst.points_mask
        )
        z = torch.zeros_like(detections.scores)
        return PoseEstimateBatch(
            poses=TCO, K=K, obj_ids=detections.obj_ids,
            batch_im_ids=detections.batch_im_ids,
            instance_ids=detections.instance_ids,
            hypothesis_ids=torch.zeros_like(detections.obj_ids),
            scores=detections.scores, coarse_logits=z, pose_logits=z,
            valid=detections.valid,
        )

    @torch.inference_mode()
    def _forward_coarse_pose_model(
        self, obs: ObservationBatch, estimates: PoseEstimateBatch
    ) -> Tuple[PoseEstimateBatch, Dict[str, PoseEstimateBatch]]:
        """CosyPose coarse: the coarse pose model run `n_coarse_iterations`."""
        with stage("estimator.coarse"):
            return self._update_poses(
                self.coarse_model, obs, estimates, self.cfg.n_coarse_iterations
            )

    # ------------------------------------------------------------------
    # Full pipeline
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def run_inference_pipeline(
        self,
        obs: ObservationBatch,
        detections: DetectionBatch,
        n_refiner_iterations: Optional[int] = None,
        n_pose_hypotheses: Optional[int] = None,
    ) -> Dict[str, PoseEstimateBatch]:
        """MegaPose when the coarse model is a classifier: grid scoring ->
        top-K -> refine -> re-score -> top-1; returns the estimates of every
        stage: "coarse", "iteration=k", "scored" and "final" (one valid row
        per detection). CosyPose otherwise: init -> coarse iterations ->
        refiner iterations; returns "init", "coarse" (when there is a coarse
        model), "iteration=k" and "final", whose `pose_logits` are the
        detection scores (CosyPose has no scoring model). With
        `cfg.run_depth_refiner` and observed depth, "final" is refined
        against the depth and also returned as "depth_refined"."""
        results: Dict[str, PoseEstimateBatch] = {}
        if self._coarse_is_classifier:
            final = self._run_megapose(obs, detections, n_refiner_iterations,
                                       n_pose_hypotheses, results)
        else:
            est = results["init"] = self.make_TCO_init(obs, detections)
            if self.coarse_model is not None:
                est, _ = self._forward_coarse_pose_model(obs, est)
                results["coarse"] = est
            final, per_iter = self.forward_refiner(obs, est, n_refiner_iterations)
            results.update(per_iter)
            final = dataclasses.replace(final, pose_logits=final.scores)
        if self.cfg.run_depth_refiner and obs.depth is not None:
            final = results["depth_refined"] = self.run_depth_refiner(obs, final)
        results["final"] = final
        return results

    def run_inference_pipeline_jit(
        self,
        obs: ObservationBatch,
        detections: DetectionBatch,
        n_refiner_iterations: Optional[int] = None,
        n_pose_hypotheses: Optional[int] = None,
    ) -> Dict[str, PoseEstimateBatch]:
        """`run_inference_pipeline` as one CUDA graph per (image shape,
        depth shape, detection count, iterations, hypotheses): the whole
        frame, the depth refiner included, is captured once and each later
        frame of the key is one replay. Returns the eager pipeline's dict,
        cloned out of the graph. On CPU tensors the same path with a plain
        call. With a `device_mesh` it raises: the sharded coarse stage's
        collectives are not captured (ROADMAP, the jit sites still to
        port); call `run_inference_pipeline`, as `PredictionRunner` does."""
        if self.device_mesh is not None:
            raise ValueError(
                "run_inference_pipeline_jit runs without a device_mesh: the sharded "
                "coarse stage is not captured yet (ROADMAP.md, the jit sites still to "
                "port); call run_inference_pipeline")
        key = (
            tuple(obs.rgb.shape),
            None if obs.depth is None else tuple(obs.depth.shape),
            detections.n_rows,
            n_refiner_iterations,
            n_pose_hypotheses,
        )

        def frame(obs, detections):
            return self.run_inference_pipeline(
                obs, detections, n_refiner_iterations, n_pose_hypotheses)

        return self._graph_call(key, frame, (obs, detections))

    def _run_megapose(self, obs, detections, n_refiner_iterations, n_pose_hypotheses,
                      results) -> PoseEstimateBatch:
        """The MegaPose stages; fills `results`, returns the top-1 estimates."""
        n_hyp = n_pose_hypotheses or self.cfg.n_pose_hypotheses
        coarse = self.forward_coarse(obs, detections)
        results["coarse"] = coarse
        kept = self.filter_top_k(coarse, by="coarse_logits", k=n_hyp)
        # compact to D*n_hyp rows for the refiner, best logits first; the
        # key and its float32 arithmetic are the JAX pipeline's, and the
        # stable sort keeps its order among ties
        key = (~kept.valid).to(torch.float32) * 1e9 - kept.coarse_logits
        order = torch.argsort(key, stable=True)
        subset = kept.select(order[: detections.n_rows * n_hyp])
        refined, per_iter = self.forward_refiner(obs, subset, n_refiner_iterations)
        results.update(per_iter)
        scored = self.forward_scoring(obs, refined)
        results["scored"] = scored
        return self.filter_top_k(scored, by="pose_logits", k=1)

    @torch.inference_mode()
    def run_depth_refiner(
        self, obs: ObservationBatch, estimates: PoseEstimateBatch
    ) -> PoseEstimateBatch:
        """Refine the estimates against the observed depth, at a depth
        resolution cut to at most about 160 px a side (strided) for a fixed
        cost. `cfg.depth_refiner` selects "teaserpp" (GNC-TLS registration)
        or ICP (the default). Both render through `render_batch_fused`: the
        CUDA kernel for CUDA tensors. Only valid rows move."""
        with annotate("estimator.depth_refine"):
            H, W = obs.rgb.shape[-2:]
            scale = max(1, max(H, W) // 160)
            h, w = H // scale, W // scale
            depth = obs.depth[:, 0, ::scale, ::scale]
            K_scaled = torch.cat([obs.K[:, :2] / float(scale), obs.K[:, 2:]], dim=1)
            refiner_cls = TeaserRefiner if self.cfg.depth_refiner == "teaserpp" else ICPRefiner
            key = (refiner_cls, (h, w))
            refiner = self._depth_refiners.get(key)
            if refiner is None:
                refiner = refiner_cls(self.assets, render_batch_fused, resolution=(h, w))
                self._depth_refiners[key] = refiner
            poses = refiner.refine(
                estimates.obj_ids,
                estimates.poses,
                K_scaled[estimates.batch_im_ids],
                depth[estimates.batch_im_ids],
            )
            poses = torch.where(estimates.valid[:, None, None], poses, estimates.poses)
            return dataclasses.replace(estimates, poses=poses)
