"""Build-at-first-use for the port's native sources (``csrc/``).

Each source compiles into a shared library with a plain C interface, named
by a hash of the source and the compiler command, inside the package's
``build/`` directory (listed in .gitignore), and is loaded with ctypes.
Concurrent builders (test workers) each compile to a private temporary
file and rename it into place, so a half-written library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"


def build_library(source: str, command: list[str],
                  src_dir: Path = CSRC_DIR) -> Path:
    """Compile ``<src_dir>/<source>`` (``csrc/`` by default) with
    ``command + ["-o", out, src]`` unless a library of the same source
    and command already exists.  Returns the library's path; raises
    RuntimeError with the compiler's output if the build fails (OSError
    if the compiler is missing), and keeps that output in ``<lib>.log``
    when it succeeds."""
    src = Path(src_dir) / source
    tag = hashlib.sha256(src.read_bytes() + "\0".join(command).encode()
                         ).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    proc = subprocess.run(command + ["-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {source} failed "
                           f"({' '.join(command)}):\n{proc.stderr}")
    os.replace(tmp, out)
    # the compiler's report (e.g. ptxas register / spill counts) beside it
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return out


def load_library(source: str, command: list[str],
                 src_dir: Path = CSRC_DIR) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(source, command, src_dir)))
