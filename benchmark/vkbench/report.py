"""The end of a run: the check lines on stderr, the result line last on
stdout, once no forbidden module is loaded in the printing process."""

from __future__ import annotations

import json
import subprocess
import sys

from .cell import forbidden_modules


def power_limit() -> list[str] | None:
    """Each card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return [line.strip() for line in out.splitlines() if line.strip()]


def emit(result: dict, lines: list[str]) -> int:
    """Print the run's result; returns the exit code (3 when a JAX
    module was loaded, and then no result)."""
    bad = forbidden_modules()
    if bad:
        print(f"run: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    if result["device"]["platform"] == "gpu":
        result["device"]["power_limit"] = power_limit()
        # keep the comparison's numbers the result's last key
        result["checks"] = result.pop("checks")
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
