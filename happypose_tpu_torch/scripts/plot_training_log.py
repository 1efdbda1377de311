"""Render training curves from JSON-lines logs to a standalone SVG.

Port of `happypose_tpu/scripts/plot_training_log.py` (it has no
dependencies): a dependency-free SVG line chart over one or more run
directories, in place of the reference's bokeh dashboards. It reads the
`log.txt` of either package's `run_pose_training` (one JSON object an epoch).

Usage:
  python -m happypose_tpu_torch.scripts.plot_training_log \
      --runs /tmp/run1 /tmp/run2 --metric loss --out curves.svg
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e"]


def render_svg(series, metric: str, width=640, height=360) -> str:
    pad = 48
    xs_all = [x for _, pts in series for x, _ in pts]
    ys_all = [y for _, pts in series for _, y in pts]
    if not xs_all:
        return "<svg xmlns='http://www.w3.org/2000/svg'/>"
    x0, x1 = min(xs_all), max(xs_all) or 1
    y0, y1 = min(ys_all), max(ys_all)
    if y1 == y0:
        y1 = y0 + 1
    sx = lambda x: pad + (x - x0) / max(x1 - x0, 1e-9) * (width - 2 * pad)
    sy = lambda y: height - pad - (y - y0) / (y1 - y0) * (height - 2 * pad)
    parts = [
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' "
        f"height='{height}' style='background:#fff;font-family:sans-serif'>",
        f"<text x='{width // 2}' y='18' text-anchor='middle' "
        f"font-size='14'>{metric}</text>",
        f"<line x1='{pad}' y1='{height - pad}' x2='{width - pad}' "
        f"y2='{height - pad}' stroke='#888'/>",
        f"<line x1='{pad}' y1='{pad}' x2='{pad}' y2='{height - pad}' "
        f"stroke='#888'/>",
        f"<text x='{pad}' y='{height - pad + 16}' font-size='10'>{x0}</text>",
        f"<text x='{width - pad}' y='{height - pad + 16}' font-size='10' "
        f"text-anchor='end'>{x1}</text>",
        f"<text x='{pad - 4}' y='{height - pad}' font-size='10' "
        f"text-anchor='end'>{y0:.4g}</text>",
        f"<text x='{pad - 4}' y='{pad + 4}' font-size='10' "
        f"text-anchor='end'>{y1:.4g}</text>",
    ]
    for i, (name, pts) in enumerate(series):
        color = _COLORS[i % len(_COLORS)]
        d = " ".join(
            f"{'M' if j == 0 else 'L'}{sx(x):.1f},{sy(y):.1f}"
            for j, (x, y) in enumerate(pts)
        )
        parts.append(f"<path d='{d}' fill='none' stroke='{color}' "
                     f"stroke-width='1.5'/>")
        parts.append(
            f"<text x='{width - pad}' y='{pad + 14 * i}' font-size='11' "
            f"fill='{color}' text-anchor='end'>{name}</text>"
        )
    parts.append("</svg>")
    return "".join(parts)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--runs", type=Path, nargs="+", required=True)
    p.add_argument("--metric", default="loss")
    p.add_argument("--out", type=Path, default=Path("training_curves.svg"))
    args = p.parse_args(argv)

    series = []
    for run in args.runs:
        log = run / "log.txt"
        if not log.exists():
            continue
        pts = []
        for line in log.read_text().splitlines():
            rec = json.loads(line)
            if args.metric in rec:
                pts.append((rec.get("epoch", len(pts)), rec[args.metric]))
        if pts:
            series.append((run.name, pts))
    args.out.write_text(render_svg(series, args.metric))
    print(f"wrote {args.out} ({len(series)} runs)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
