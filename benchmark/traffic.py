"""The one traffic generator. A mix is a data file of parameters
(`mixes/<name>.json`); the cell may override any of them. Everything is
drawn from the seed with numpy's PCG64, so a seed gives the same traffic on
any machine. Sizes that vary are drawn in blocks that each hold every
value once, shuffled: every seed serves the same sizes, in another order.

Kinds:
- "frames": camera frames of `image_size`, each with its intrinsics and a
  number of detections (distinct objects, boxes inside the frame);
- "sessions": tracking sessions of `frames_per_session` frames, each with
  a number of objects, their starting poses (inside the frame) and the
  camera's intrinsics;
- "batches": training steps of `batch_size` synthetic samples (the
  runner draws each step's scenes on the card, from the seed).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _blocks(rng: np.random.Generator, values, n: int) -> List[int]:
    out: List[int] = []
    while len(out) < n:
        out += [int(v) for v in rng.permutation(values)]
    return out[:n]


def _intrinsics(rng, mix, size):
    H, W = size
    f = rng.uniform(*mix["focal_px"])
    d = mix["principal_offset_px"]
    return np.array([[f, 0.0, (W - 1) / 2 + rng.uniform(-d, d)],
                     [0.0, f * rng.uniform(0.99, 1.01), (H - 1) / 2 + rng.uniform(-d, d)],
                     [0.0, 0.0, 1.0]], np.float32)


def _boxes(rng, mix, size, n):
    H, W = size
    lo, hi = mix["box_side_px"]
    w = rng.uniform(lo, min(hi, W - 1), n)
    h = rng.uniform(lo, min(hi, H - 1), n)
    x = rng.uniform(0, W - 1 - w)
    y = rng.uniform(0, H - 1 - h)
    return np.stack([x, y, x + w, y + h], -1).astype(np.float32)


def _poses(rng, mix, K, size, n):
    """Object poses [n, 4, 4]: a uniform rotation, the origin at a depth in
    `depth_m` on the ray of a pixel at least `margin_px` inside the frame."""
    H, W = size
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q.T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                 -1).reshape(n, 3, 3)
    m = mix["margin_px"]
    u, v = rng.uniform(m, W - 1 - m, n), rng.uniform(m, H - 1 - m, n)
    d = rng.uniform(*mix["depth_m"], n)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = np.stack([(u - K[0, 2]) / K[0, 0] * d, (v - K[1, 2]) / K[1, 1] * d, d], -1)
    return T.astype(np.float32)


def generate(mix: Dict, seed: int, n_objects: int) -> Dict:
    """{"images": how many pool images the items index, "items": [...]}."""
    rng = np.random.default_rng(seed % (1 << 63))
    size = tuple(mix["image_size"]) if "image_size" in mix else None
    kind = mix["kind"]
    if kind == "frames":
        counts = _blocks(rng, mix["detections"], mix["frames"])
        items = [{"image": int(rng.integers(mix["images"])), "K": _intrinsics(rng, mix, size),
                  "obj_ids": rng.permutation(n_objects)[:d].astype(np.int64),
                  "boxes": _boxes(rng, mix, size, d)} for d in counts]
    elif kind == "sessions":
        counts = _blocks(rng, mix["objects"], mix["sessions"])
        items = []
        for s, k in enumerate(counts):
            K = _intrinsics(rng, mix, size)
            obj_ids = rng.permutation(n_objects)[:k].astype(np.int64)
            init = _poses(rng, mix, K, size, k)
            for f in range(mix["frames_per_session"]):
                items.append({"session": s, "frame": f, "K": K, "obj_ids": obj_ids,
                              "init": init if f == 0 else None,
                              "image": int(rng.integers(mix["images"]))})
    elif kind == "batches":
        items = [{"step": i} for i in range(mix["steps"])]
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    return {"images": mix.get("images", 0), "items": items}
