"""Force/trajectory visualization: the `draw_force_plugin` counterpart.

The reference's ``unitree_gazebo/plugin/draw_force_plugin.cc`` draws GRF
vectors from WrenchStamped messages inside the Gazebo GUI. This framework
has no live GUI; the same information — per-foot ground-reaction
vectors along the torso trajectory — renders offline from telemetry
(``TelemetryLogger.publish_forces`` → ``grf_vis`` JSONL channel) into a
PNG/SVG via matplotlib (Agg backend, no display required).
"""

from __future__ import annotations

import json
import pathlib
from typing import Iterable, Optional, Union

import numpy as np

Records = Union[str, pathlib.Path, Iterable[dict]]


def _load_frames(records: Records) -> list[dict]:
    if isinstance(records, (str, pathlib.Path)):
        with open(records) as fh:
            recs = [json.loads(line) for line in fh if line.strip()]
    else:
        recs = list(records)
    return [r for r in recs if r.get("ch") == "grf_vis"]


def render_forces(
    records: Records,
    out_path: Union[str, pathlib.Path],
    plane: str = "xz",
    every: int = 1,
    force_scale: float = 0.002,
    title: Optional[str] = None,
) -> pathlib.Path:
    """Render GRF arrows + torso trajectory from ``grf_vis`` frames.

    records: a telemetry JSONL path or an iterable of record dicts.
    plane: "xz" (side view, default) or "xy" (top view).
    every: plot every Nth frame's arrows (trajectory uses all frames).
    force_scale: meters of arrow per Newton (draw_force_plugin scales by
    1/20 per its .cc; default here keeps a 126 N stance arrow ~0.25 m).

    Returns the written path. Raises ValueError if no frames are present.
    """
    frames = _load_frames(records)
    if not frames:
        raise ValueError("no grf_vis frames in the provided records")
    ai, bi = {"xz": (0, 2), "xy": (0, 1)}[plane]

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 4))
    traj = np.asarray([f["pos"] for f in frames])
    ax.plot(traj[:, ai], traj[:, bi], color="tab:blue", lw=1.5,
            label="torso trajectory")

    for f in frames[::every]:
        feet = np.asarray(f["feet"])       # (n_feet, 3)
        grf = np.asarray(f["grf"])         # (n_feet, 3)
        contacts = f.get("contacts")
        on = (
            np.asarray(contacts) > 0.5
            if contacts is not None
            else np.linalg.norm(grf, axis=-1) > 1e-6
        )
        for foot, force, active in zip(feet, grf, on):
            if not active:
                continue
            ax.annotate(
                "",
                xy=(foot[ai] + force[ai] * force_scale,
                    foot[bi] + force[bi] * force_scale),
                xytext=(foot[ai], foot[bi]),
                arrowprops=dict(arrowstyle="->", color="tab:red", lw=0.8),
            )
        ax.scatter(feet[on, ai], feet[on, bi], s=4, color="k", zorder=3)

    ax.set_xlabel(plane[0] + " [m]")
    ax.set_ylabel(plane[1] + " [m]")
    ax.set_title(title or f"ground-reaction forces ({plane} view)")
    ax.legend(loc="upper left", fontsize=8)
    ax.set_aspect("equal", adjustable="datalim")
    fig.tight_layout()
    out_path = pathlib.Path(out_path)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
