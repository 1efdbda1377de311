"""Training checkpoints (PyTorch port of `happypose_tpu/utils/checkpoint.py`).

A checkpoint is a run directory of the port (`utils/load_model.py`:
`config.json` + `state_dict.pt`, so `spec_from_checkpoints` and
`run_eval --model from-checkpoints` read a training run as it is) with
the optimizer's state and the step count (`optimizer.pt`) and `epoch.json`
beside it. Both `.pt` files also have a `_last` copy, written after the
first ones: a truncated or corrupt file falls back to it, as the reference
falls back to its `checkpoint_epoch=last` copy. In a run of several
processes only rank 0 writes.

`load_checkpoint` also resumes from a training run of the JAX package:
`checkpoint.msgpack` (then `checkpoint_last.msgpack`), read when the
directory holds no `state_dict.pt`. Its TrainState `{"step", "params",
"batch_stats", "opt_state"}` (a detector run's has no `step`) comes over
through the weight bridge: optax's Adam / AdamW state (`opt_state`
`1/0/{count, mu, nu}` behind the clip's empty state, the schedule's
`1/1/count`, or `1/2/count` under AdamW) gives `torch.optim`'s
`exp_avg` / `exp_avg_sq` / `step` and the schedule's count of applied
updates (`Optimizer.count`), `step` the steps taken, applied or skipped.
`flax_train_state` is the other direction; `save_flax_checkpoint` writes
it as the JAX package's `save_checkpoint` does.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from happypose_tpu_torch.models.detector import FCOSDetector
from happypose_tpu_torch.parallel.distributed import is_main_process
from happypose_tpu_torch.training.trainer import TrainState
from happypose_tpu_torch.utils import flax_msgpack
from happypose_tpu_torch.utils.load_model import (
    FLAX_FILE, STATE_DICT_FILE, UNREADABLE, flax_tree_state_dict, last_copy, read_first,
    weights_format,
)
from happypose_tpu_torch.utils.weights_from_jax import (
    adam_state_from_flax, adam_state_to_flax, model_leaves, model_variables,
)
from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

OPTIMIZER_FILE = "optimizer.pt"


def save_checkpoint(
    run_dir: Union[str, Path],
    state: TrainState,
    epoch: int,
    config: Optional[Dict] = None,
    keep_last_copy: bool = True,
) -> Path:
    """Write the train state (rank 0 only); returns the path of the state dict."""
    run_dir = Path(run_dir)
    if not is_main_process():
        return run_dir / STATE_DICT_FILE
    run_dir.mkdir(parents=True, exist_ok=True)
    payloads = {
        run_dir / STATE_DICT_FILE: {
            k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        run_dir / OPTIMIZER_FILE: {
            "optimizer": state.optimizer.state_dict(), "step": state.step},
    }
    for path, payload in payloads.items():
        torch.save(payload, path)
    (run_dir / "epoch.json").write_text(json.dumps({"epoch": epoch}))
    if config is not None:
        (run_dir / "config.json").write_text(json.dumps(config, default=str))
    if keep_last_copy:
        for path, payload in payloads.items():
            torch.save(payload, last_copy(path))
    return run_dir / STATE_DICT_FILE


def has_checkpoint(run_dir: Union[str, Path]) -> bool:
    """Whether `--resume` finds a run to continue: the port's
    `state_dict.pt` or the JAX package's `checkpoint.msgpack`."""
    return (Path(run_dir) / STATE_DICT_FILE).exists() or (Path(run_dir) / FLAX_FILE).exists()


def _optimizer_names(state: TrainState) -> List[str]:
    """The state dict keys of the optimizer's parameters, in its order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.adam.param_groups for p in g["params"]]


def _find_optax_states(opt_state: Mapping) -> Tuple[Mapping, Optional[int]]:
    """optax's `ScaleByAdamState` (the map with `count`, `mu`, `nu`) and the
    schedule's count (a map of `count` alone), depth first."""
    adam, sched = None, None
    stack = [opt_state]
    while stack:
        d = stack.pop(0)
        if {"count", "mu", "nu"} <= set(d):
            adam = d if adam is None else adam
        elif set(d) == {"count"}:
            sched = int(np.asarray(d["count"])) if sched is None else sched
        else:
            stack.extend(v for _, v in sorted(d.items()) if isinstance(v, Mapping))
    if adam is None:
        raise ValueError("the checkpoint's opt_state holds no Adam state (count, mu, nu)")
    return adam, sched


def load_flax_train_state(tree: Mapping, state: TrainState) -> None:
    """Load a decoded JAX TrainState into `state` in place: weights,
    Adam's moments and count, the schedule's count and the step."""
    opt = state.optimizer
    state.model.load_state_dict(flax_tree_state_dict(tree))
    adam, sched = _find_optax_states(tree["opt_state"])
    leaves = model_leaves(state.model)
    opt.adam.load_state_dict({
        "state": adam_state_from_flax(leaves, adam, _optimizer_names(state)),
        "param_groups": opt.adam.state_dict()["param_groups"],
    })
    opt.count = int(np.asarray(adam["count"])) if sched is None else sched
    state.step = int(np.asarray(tree["step"])) if "step" in tree else opt.count


def flax_train_state(state: TrainState) -> Dict[str, object]:
    """The JAX package's TrainState tree of `state`, as its training scripts
    write it: a pose model's `{"step", "params", "batch_stats",
    "opt_state"}` with optax's chain (the clip's empty state when the
    optimizer clips, then Adam's state, AdamW's empty weight-decay state,
    the schedule's count); a detector's `{"batch_stats", "opt_state",
    "params"}` (a dict, which `jax.device_get` sorts) of `optax.adam` at a
    constant rate."""
    opt, model = state.optimizer, state.model
    variables = model_variables(model)
    adam = adam_state_to_flax(model_leaves(model), opt.adam.state_dict()["state"],
                              dict(model.named_parameters()), _optimizer_names(state), opt.count)
    body = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    if isinstance(model, FCOSDetector):  # the JAX detector's `optax.adam(lr)` in a dict, sorted
        return {"batch_stats": body["batch_stats"], "opt_state": {"0": adam, "1": {}},
                "params": body["params"]}
    sched = {"count": np.asarray(opt.count, np.int32)}
    chain = ({"0": adam, "1": {}, "2": sched} if isinstance(opt.adam, torch.optim.AdamW)
             else {"0": adam, "1": sched})
    opt_state = {"0": {}, "1": chain} if opt.clip_grad_norm is not None else {"0": chain}
    return {"step": np.asarray(state.step, np.int32), **body, "opt_state": opt_state}


def save_flax_checkpoint(
    run_dir: Union[str, Path],
    state: TrainState,
    epoch: int,
    config: Optional[Dict] = None,
    keep_last_copy: bool = True,
) -> Path:
    """Write `flax_train_state(state)` as the JAX package's
    `save_checkpoint` does: `checkpoint.msgpack`, `epoch.json`,
    `config.json`, `checkpoint_last.msgpack`."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    payload = flax_msgpack.msgpack_serialize(flax_train_state(state))
    (run_dir / FLAX_FILE).write_bytes(payload)
    (run_dir / "epoch.json").write_text(json.dumps({"epoch": epoch}))
    if config is not None:
        (run_dir / "config.json").write_text(json.dumps(config, default=str))
    if keep_last_copy:
        last_copy(run_dir / FLAX_FILE).write_bytes(payload)
    return run_dir / FLAX_FILE


def load_checkpoint(run_dir: Union[str, Path], state: TrainState) -> Tuple[TrainState, int]:
    """Restore `state` in place from the first readable copy of the port's
    checkpoint or, where the directory holds none, of the JAX package's;
    returns it and the epoch of `epoch.json`."""
    run_dir = Path(run_dir)
    if weights_format(run_dir) == "flax":
        load_flax_train_state(read_first(run_dir, FLAX_FILE, flax_msgpack.read_file), state)
    else:
        primary = [run_dir / STATE_DICT_FILE, run_dir / OPTIMIZER_FILE]
        for paths in (primary, [last_copy(p) for p in primary]):
            try:
                model_sd, opt = (torch.load(p, map_location="cpu", weights_only=True)
                                 for p in paths)
            except UNREADABLE as e:
                logger.warning(f"checkpoint {paths[0].name} / {paths[1].name} unreadable "
                               f"({e}); trying next")
                continue
            state.model.load_state_dict(model_sd)
            state.optimizer.load_state_dict(opt["optimizer"])
            state.step = int(opt["step"])
            break
        else:
            raise FileNotFoundError(f"no readable checkpoint in {run_dir}")
    ep = run_dir / "epoch.json"
    epoch = json.loads(ep.read_text())["epoch"] if ep.exists() else 0
    return state, epoch
