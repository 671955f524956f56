"""Watch-later style checkpoint/resume.

Reference behavior (player/configfiles.c): on quit (or periodically) mpv
writes playback position + a configurable option subset into a per-file
hashed config under watch_later/ (:211-233 hashing, :308 writing) and
reapplies it when the file is opened again.  The interpolator's own state is
deliberately unpersisted -- the reference rebuilds flow state from scratch
after any seek (vf_HopperRender.c:562-567) -- so a checkpoint is exactly
{position, runtime options}, which this module stores as flat key=value
text, one file per media path.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, Optional

DEFAULT_DIR = os.path.expanduser("~/.config/mfi/watch_later")

# runtime options worth carrying across sessions (mpv's default set is
# position+volume-ish; ours is position + the interpolation knobs)
SAVED_PROPS = ("speed", "frame-output-mode", "search-radius", "black-level",
               "white-level", "scene-threshold")


def _key(media_path: str) -> str:
    return hashlib.md5(os.path.abspath(media_path).encode()).hexdigest().upper()


def save(media_path: str, position: float, props: Dict[str, object],
         directory: str = DEFAULT_DIR) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _key(media_path))
    lines = [f"# {media_path}", f"# saved {time.strftime('%F %T')}",
             f"start={position:.6f}"]
    for k in SAVED_PROPS:
        if k in props:
            lines.append(f"{k}={props[k]}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def load(media_path: str, directory: str = DEFAULT_DIR) -> Optional[dict]:
    path = os.path.join(directory, _key(media_path))
    if not os.path.exists(path):
        return None
    out: Dict[str, object] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            try:
                out[k] = int(v) if v.lstrip("-").isdigit() else float(v)
            except ValueError:
                out[k] = v
    return out


def forget(media_path: str, directory: str = DEFAULT_DIR):
    try:
        os.unlink(os.path.join(directory, _key(media_path)))
    except FileNotFoundError:
        pass


def apply_to_player(player, state: dict):
    """Reapply a loaded checkpoint to a Player (api.Player)."""
    for k, v in state.items():
        if k == "start":
            continue
        try:
            player.set_property(k, v)
        except Exception:
            pass
    return float(state.get("start", 0.0))
