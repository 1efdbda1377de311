"""Full evaluation sweep: datasets x detection types, one summary.

Parity target: happypose/pose_estimators/megapose/scripts/
run_full_megapose_eval.py:54-231 (`run_full_eval`): iterate the BOP test
datasets and the requested (detection, coarse) settings, run each
(dataset, setting) evaluation, convert predictions to BOP csv, and collect
the per-setting scores into one report.

Each dataset is a BOP split dir; every setting is one call of
`run_eval.main`, which keeps its overrides to itself. Results land in
  <out-dir>/<dataset-name>/<detections>/{summary_rank0.json, preds_rank0.csv}
plus a combined <out-dir>/full_summary.json.

Usage:
  python -m happypose_tpu_torch.scripts.run_full_eval \
      --datasets <bop>/ycbv/test:<bop>/ycbv/models \
                 <bop>/tless/test:<bop>/tless/models \
      --detections gt detector --detector-run <det-run> \
      --model megapose-RGB --out-dir <out> --bop19 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument(
        "--datasets", nargs="+", required=True,
        metavar="SPLIT_DIR:MODELS_DIR",
        help="one entry per dataset: <split-dir>:<models-dir>",
    )
    p.add_argument("--detections", nargs="+", default=["gt"],
                   choices=["gt", "detector", "external"])
    p.add_argument("--model", default="megapose-RGB")
    p.add_argument("--detector-run", type=Path, default=None)
    p.add_argument("--external-detections", type=Path, default=None)
    p.add_argument("--targets", type=Path, default=None)
    p.add_argument("--so3-grid", type=int, default=None)
    p.add_argument("--n-refiner-iterations", type=int, default=None)
    p.add_argument("--checkpoints", type=Path, default=None)
    p.add_argument("--bop19", action="store_true")
    p.add_argument("--out-dir", type=Path, required=True)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--n-replicas", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--skip-inference", action="store_true",
                   help="only re-collect existing per-setting summaries "
                        "(the reference's skip_inference flag)")
    args = p.parse_args(argv)

    from happypose_tpu_torch.scripts import run_eval

    full = {}
    for entry in args.datasets:
        split_dir, _, models_dir = entry.partition(":")
        if not models_dir:
            p.error(f"dataset entry '{entry}' must be SPLIT_DIR:MODELS_DIR")
        ds_name = Path(split_dir).parent.name or Path(split_dir).name
        for det_type in args.detections:
            save_key = f"{ds_name}/{det_type}"
            out_dir = args.out_dir / ds_name / det_type
            if not args.skip_inference:
                argv_eval = [
                    "--split-dir", split_dir,
                    "--models-dir", models_dir,
                    "--model", args.model,
                    "--detections", det_type,
                    "--out-dir", str(out_dir),
                    "--rank", str(args.rank),
                    "--n-replicas", str(args.n_replicas),
                    "--device", args.device,
                ]
                if det_type == "detector":
                    if args.detector_run is None:
                        p.error("--detections detector needs --detector-run")
                    argv_eval += ["--detector-run", str(args.detector_run)]
                if det_type == "external":
                    if args.external_detections is None:
                        p.error(
                            "--detections external needs "
                            "--external-detections"
                        )
                    argv_eval += [
                        "--external-detections",
                        str(args.external_detections),
                    ]
                    if args.targets:
                        argv_eval += ["--targets", str(args.targets)]
                if args.so3_grid:
                    argv_eval += ["--so3-grid", str(args.so3_grid)]
                if args.n_refiner_iterations:
                    argv_eval += [
                        "--n-refiner-iterations",
                        str(args.n_refiner_iterations),
                    ]
                if args.checkpoints:
                    argv_eval += ["--checkpoints", str(args.checkpoints)]
                if args.bop19:
                    argv_eval += ["--bop19"]
                logger.info(f"=== {save_key} ===")
                run_eval.main(argv_eval)
            summary_file = out_dir / f"summary_rank{args.rank}.json"
            if summary_file.exists():
                full[save_key] = json.loads(summary_file.read_text())
    args.out_dir.mkdir(parents=True, exist_ok=True)
    (args.out_dir / "full_summary.json").write_text(
        json.dumps(full, indent=1, default=float)
    )
    logger.info(json.dumps(full, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
