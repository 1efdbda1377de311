"""WebDataset-style tar-shard scene storage (the port's own copy of
`happypose_tpu/datasets/web_scene_dataset.py`; host-side, standard library
`tarfile` and the port's PNG codec, no Pillow and no webdataset package).

Parity target: the reference's toolbox/datasets/web_scene_dataset.py:54-252
and toolbox/utils/webdataset.py:29-66. A sample is a group of tar members
sharing a key: `<key>.rgb.png`, `<key>.depth.png` (uint16 millimetres),
`<key>.camera_data.json` and `<key>.object_datas.json`. Shards written by
either package read in the other.
"""

from __future__ import annotations

import io
import json
import tarfile
from pathlib import Path
from typing import Iterator, List, Sequence, Union

import numpy as np

from happypose_tpu_torch.datasets.bop import SceneObservation
from happypose_tpu_torch.utils.png import decode_png, encode_png


def _obs_to_members(obs: SceneObservation, key: str):
    out = [(f"{key}.rgb.png", encode_png(obs.rgb))]
    if obs.depth is not None:
        d16 = np.clip(obs.depth * 1000.0, 0, 65535).astype(np.uint16)
        out.append((f"{key}.depth.png", encode_png(d16)))
    cam = {"K": np.asarray(obs.K).tolist(),
           "TWC": np.asarray(obs.TWC if obs.TWC is not None else np.eye(4)).tolist()}
    out.append((f"{key}.camera_data.json", json.dumps(cam).encode()))
    objs = []
    for j, label in enumerate(obs.obj_labels or []):
        objs.append({
            "label": label,
            "TWO": np.asarray(obs.TWO[j]).tolist(),
            "bbox": np.asarray(obs.bboxes[j]).tolist(),
            "visib_fract": float(obs.visib_fract[j] if obs.visib_fract is not None else 1.0),
        })
    out.append((f"{key}.object_datas.json", json.dumps(objs).encode()))
    return out


def write_scene_ds_as_wds(
    observations: Sequence[SceneObservation],
    out_dir: Union[str, Path],
    shard_size: int = 64,
    prefix: str = "shard",
) -> List[Path]:
    """Write observations into tar shards of `shard_size` samples; returns
    the shard paths."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for s in range(0, len(observations), shard_size):
        path = out_dir / f"{prefix}-{s // shard_size:06d}.tar"
        with tarfile.open(path, "w") as tar:
            for i, obs in enumerate(observations[s: s + shard_size]):
                for name, payload in _obs_to_members(obs, f"{s + i:08d}"):
                    info = tarfile.TarInfo(name)
                    info.size = len(payload)
                    tar.addfile(info, io.BytesIO(payload))
        paths.append(path)
    return paths


def _members_to_obs(members: dict, key: str) -> SceneObservation:
    rgb = decode_png(members[f"{key}.rgb.png"], f"{key}.rgb.png")
    cam = json.loads(members[f"{key}.camera_data.json"])
    objs = json.loads(members[f"{key}.object_datas.json"])
    depth = None
    if f"{key}.depth.png" in members:
        depth = decode_png(members[f"{key}.depth.png"], f"{key}.depth.png").astype(np.float32) / 1000.0
    kw = dict(rgb=rgb, K=np.asarray(cam["K"], np.float32),
              TWC=np.asarray(cam["TWC"], np.float32), depth=depth)
    if objs:
        kw.update(
            obj_labels=[o["label"] for o in objs],
            TWO=np.stack([np.asarray(o["TWO"], np.float32) for o in objs]),
            bboxes=np.stack([np.asarray(o["bbox"], np.float32) for o in objs]),
            visib_fract=np.asarray([o["visib_fract"] for o in objs], np.float32),
        )
    return SceneObservation(**kw)


def _shard_paths(shards_dir: Union[str, Path]) -> List[Path]:
    return sorted(Path(shards_dir).glob("*.tar"))


class WebSceneDataset:
    """Random-access reader over a directory of tar shards."""

    def __init__(self, shards_dir: Union[str, Path]):
        self.paths = _shard_paths(shards_dir)
        self.index: List[tuple] = []  # (shard index, key)
        for pi, p in enumerate(self.paths):
            with tarfile.open(p) as tar:
                keys = sorted({m.name.split(".")[0] for m in tar.getmembers()})
            self.index.extend((pi, k) for k in keys)

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int) -> SceneObservation:
        pi, key = self.index[i]
        with tarfile.open(self.paths[pi]) as tar:
            members = {m.name: tar.extractfile(m).read() for m in tar.getmembers()
                       if m.name.startswith(key + ".")}
        return _members_to_obs(members, key)


class IterableWebSceneDataset:
    """Infinite shuffled stream: shards in a random order an epoch, read
    sequentially, through a shuffle buffer of `buffer_size` samples (the
    reference's training-side iterator). The order is drawn from
    `np.random.RandomState(seed)`, as in the JAX package."""

    def __init__(self, shards_dir: Union[str, Path], buffer_size: int = 32, seed: int = 0):
        self.paths = _shard_paths(shards_dir)
        self.buffer_size = buffer_size
        self.seed = seed

    def _stream(self, rng) -> Iterator[SceneObservation]:
        while True:
            for pi in rng.permutation(len(self.paths)):
                with tarfile.open(self.paths[pi]) as tar:
                    groups: dict = {}
                    for m in tar.getmembers():
                        groups.setdefault(m.name.split(".")[0], {})[m.name] = \
                            tar.extractfile(m).read()
                for key in sorted(groups):
                    yield _members_to_obs(groups[key], key)

    def __iter__(self) -> Iterator[SceneObservation]:
        rng = np.random.RandomState(self.seed)
        buf: List[SceneObservation] = []
        for obs in self._stream(rng):
            buf.append(obs)
            if len(buf) >= self.buffer_size:
                yield buf.pop(rng.randint(len(buf)))
