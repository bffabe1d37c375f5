"""The card a run used: its record for the result line, and its power
limit as `nvidia-smi` reads it."""

from __future__ import annotations

import subprocess


def record(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def power_limit() -> str:
    """"<name>, <power limit>" of card 0, or why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc.__class__.__name__})"
    return out.stdout.strip() or f"not read (exit {out.returncode})"
