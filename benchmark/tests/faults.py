"""Faults planted under the timed path, each where the cell's program
produces the thing it breaks; the tests run a cell with one of them and
see `correct` come out false."""

import torch


def _unchanged_pose(TCO, K, vxvyvz, dR, tCR):
    return TCO.clone()


def _stale(orig):
    first = []

    def stale(*a, **k):
        if not first:
            first.append(orig(*a, **k))
        return first[0]

    return stale


FAULTS = {
    # a step that returns its state unchanged
    ("megapose-bop", "state"): (
        "happypose_tpu_torch.models.pose_predictor.pose_update_with_reference_point",
        lambda orig: _unchanged_pose),
    ("megapose-track", "state"): (
        "happypose_tpu_torch.models.pose_predictor.pose_update_with_reference_point",
        lambda orig: _unchanged_pose),
    ("cosypose-bop", "state"): (
        "happypose_tpu_torch.models.pose_predictor.pose_update_with_reference_point",
        lambda orig: _unchanged_pose),
    ("megapose-train", "state"): (
        "happypose_tpu_torch.training.trainer.Optimizer.apply",
        lambda orig: lambda self, grad_norm, ok=None: None),
    # an answer altered where it is produced
    ("megapose-bop", "answer"): (
        "happypose_tpu_torch.inference.pose_estimator._coarse_logits",
        lambda orig: lambda *a: orig(*a) * 1.01),
    ("cosypose-bop", "answer"): (
        "happypose_tpu_torch.inference.detector.detector_postprocess",
        lambda orig: lambda *a, **k: {**orig(*a, **k), "scores": orig(*a, **k)["scores"] * 1.01}),
    ("megapose-track", "answer"): (
        "happypose_tpu_torch.models.pose_predictor.pose_update_with_reference_point",
        lambda orig: lambda *a: orig(*a) + torch.tensor([[0.0, 0, 0, 1e-3]] * 3 + [[0.0] * 4])),
    # half of the batch left out, the mean taken over the rest
    ("megapose-train", "half"): (
        "happypose_tpu_torch.training.forward_loss.loss_refiner_CO_disentangled_reference_point",
        lambda orig: lambda *a, **k: _half(orig(*a, **k))),
    # a step that trains on a stale batch: the first one, again and again
    ("megapose-train", "stale"): (
        "happypose_tpu_torch.training.synth_data.make_synth_batch", _stale),
}


def _half(out):
    loss, parts = out
    h = loss[: loss.shape[0] // 2]
    return torch.cat([h, h]), parts


def plant(cell: str, fault: str, monkeypatch) -> None:
    """Replace the fault's target (a module's function or a class's
    method) with its broken version for the test."""
    target, make = FAULTS[(cell, fault)]
    module_name, _, attr = target.rpartition(".")
    try:
        owner = __import__(module_name, fromlist=[attr])
    except ImportError:  # a method: module.Class.method
        module_name, _, cls = module_name.rpartition(".")
        owner = getattr(__import__(module_name, fromlist=[cls]), cls)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
