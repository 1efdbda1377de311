"""Data/asset fetcher CLI, local-mirror edition (PyTorch port's copy of
`happypose_tpu/scripts/download.py`).

The reference's downloader fetches BOP datasets, model checkpoints,
examples and results from network mirrors into HAPPYPOSE_DATA_DIR. This
one resolves the same flags against a **local mirror directory**
(``--mirror`` or $HAPPYPOSE_MIRROR_DIR) and never opens a socket: assets
are symlinked (or copied with ``--copy``) into the data dir with the
reference's layout:

  bop_datasets/<name>/            (--bop_dataset ycbv tless ...)
  megapose-models/                (--megapose_models)
  experiments/<run_id>/           (--cosypose_models <run_id>)
  examples/<name>/                (--examples barbecue-sauce)

A missing mirror gives an actionable error (exit code 2; a missing asset
3). Synthetic data needs no download at all: `record_synthetic_dataset
--write-models` creates self-contained BOP datasets locally.
"""

from __future__ import annotations

import argparse
import os
import shutil
from pathlib import Path
from typing import List, Optional, Tuple

from happypose_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DATA_DIR_ENV = "HAPPYPOSE_DATA_DIR"
MIRROR_ENV = "HAPPYPOSE_MIRROR_DIR"


def _resolve(mirror: Path, rel: str) -> Optional[Path]:
    p = mirror / rel
    return p if p.exists() else None


def _install(src: Path, dst: Path, copy: bool) -> None:
    dst.parent.mkdir(parents=True, exist_ok=True)
    if dst.exists() or dst.is_symlink():
        logger.info(f"exists, skipping: {dst}")
        return
    if copy:
        if src.is_dir():
            shutil.copytree(src, dst)
        else:
            shutil.copy2(src, dst)
    else:
        dst.symlink_to(src.resolve())
    logger.info(f"installed {dst} <- {src}")


def gather_requests(args) -> List[Tuple[str, str]]:
    """(mirror-relative source, data-dir-relative dest) pairs."""
    reqs: List[Tuple[str, str]] = []
    for ds in args.bop_dataset or []:
        reqs.append((f"bop_datasets/{ds}", f"bop_datasets/{ds}"))
    if args.megapose_models:
        reqs.append(("megapose-models", "megapose-models"))
    for run_id in args.cosypose_models or []:
        reqs.append(
            (f"experiments/{run_id}", f"experiments/{run_id}")
        )
    for ex in args.examples or []:
        reqs.append((f"examples/{ex}", f"examples/{ex}"))
    return reqs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--bop_dataset", nargs="*", default=None,
                   help="BOP dataset names (ycbv, tless, hope, ...)")
    p.add_argument("--megapose_models", action="store_true")
    p.add_argument("--cosypose_models", nargs="*", default=None,
                   help="run_ids of pretrained cosypose checkpoints")
    p.add_argument("--examples", nargs="*", default=None)
    p.add_argument("--mirror", type=Path,
                   default=os.environ.get(MIRROR_ENV))
    p.add_argument("--data-dir", type=Path,
                   default=os.environ.get(DATA_DIR_ENV, "local_data"))
    p.add_argument("--copy", action="store_true",
                   help="copy instead of symlink")
    args = p.parse_args(argv)

    reqs = gather_requests(args)
    if not reqs:
        p.print_help()
        return 1
    if args.mirror is None:
        logger.error(
            "no mirror configured: this image has no network egress, so "
            f"assets must come from a local mirror (--mirror or "
            f"${MIRROR_ENV}). For synthetic data, use "
            "record_synthetic_dataset --write-models instead."
        )
        return 2
    mirror = Path(args.mirror)
    missing = []
    for src_rel, dst_rel in reqs:
        src = _resolve(mirror, src_rel)
        if src is None:
            missing.append(src_rel)
            continue
        _install(src, args.data_dir / dst_rel, args.copy)
    if missing:
        logger.error(f"not found in mirror {mirror}: {missing}")
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
