"""Training checkpoints (PyTorch port of `happypose_tpu/utils/checkpoint.py`).

A checkpoint is a run directory of the port (`utils/load_model.py`:
`config.json` + `state_dict.pt`, so `spec_from_checkpoints` and
`run_eval --model from-checkpoints` read a training run as it is) with
the optimizer's state and the step count (`optimizer.pt`) and `epoch.json`
beside it. Both `.pt` files also have a `_last` copy, written after the
first ones: a truncated or corrupt file falls back to it, as the reference
falls back to its `checkpoint_epoch=last` copy. In a run of several
processes only rank 0 writes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import torch

from happypose_tpu_torch.parallel.distributed import is_main_process
from happypose_tpu_torch.training.trainer import TrainState
from happypose_tpu_torch.utils.load_model import STATE_DICT_FILE, UNREADABLE, last_copy
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


def load_checkpoint(run_dir: Union[str, Path], state: TrainState) -> Tuple[TrainState, int]:
    """Restore `state` in place from the first readable copy; returns it
    and the epoch of `epoch.json`."""
    run_dir = Path(run_dir)
    primary = [run_dir / STATE_DICT_FILE, run_dir / OPTIMIZER_FILE]
    for paths in (primary, [last_copy(p) for p in primary]):
        try:
            model_sd, opt = (torch.load(p, map_location="cpu", weights_only=True) for p in paths)
        except UNREADABLE as e:
            logger.warning(f"checkpoint {paths[0].name} / {paths[1].name} unreadable ({e}); "
                           "trying next")
            continue
        state.model.load_state_dict(model_sd)
        state.optimizer.load_state_dict(opt["optimizer"])
        state.step = int(opt["step"])
        ep = run_dir / "epoch.json"
        epoch = json.loads(ep.read_text())["epoch"] if ep.exists() else 0
        return state, epoch
    raise FileNotFoundError(f"no readable checkpoint in {run_dir}")
