"""Shared build-on-first-use helper for the native host cores.

Each native core (native/*.cpp) is compiled to a .so next to its source
on first use.  Staleness is decided by a sha256 sidecar of the source
content + compiler flags (``<so>.srchash``), NOT by mtimes: after a
fresh clone every file carries the checkout time, so an mtime comparison
is timing-dependent and could silently reuse a .so built from different
source.  The .so artifacts are not committed; a missing sidecar always
triggers a rebuild.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import Sequence


def _src_hash(src: str, flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(repr(list(flags)).encode())
    return h.hexdigest()


def ensure_lib(src: str, so: str, flags: Sequence[str],
               timeout: float = 300.0) -> bool:
    """True iff ``so`` exists and was built from the current content of
    ``src`` with ``flags``; rebuilds when the sidecar hash mismatches.
    False when the build fails (callers then use their Python spec)."""
    try:
        build_lib(src, so, flags, timeout=timeout)
        return True
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return False


def build_lib(src: str, so: str, flags: Sequence[str],
              compiler: str = "g++", timeout: float = 300.0) -> None:
    """Build ``so`` from ``src`` unless the sidecar says it is current.
    Raises RuntimeError with the compiler's output when the build
    fails."""
    want = _src_hash(src, [compiler, *flags])
    sidecar = so + ".srchash"
    try:
        if os.path.exists(so):
            with open(sidecar) as f:
                if f.read().strip() == want:
                    return
    except OSError:
        pass
    res = subprocess.run([compiler, *flags, src, "-o", so],
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"{compiler} failed on {src}:\n"
                           f"{res.stdout}{res.stderr}")
    with open(sidecar, "w") as f:
        f.write(want + "\n")
