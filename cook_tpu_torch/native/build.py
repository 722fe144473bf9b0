"""The port's copy of ``cook_tpu/native/build.py``: the build-if-stale
helper for the native (C++) host components the port uses (the status
watch queue and the journal replication carrier)."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Sequence


def build_if_stale(sources: Sequence[Path], target: Path,
                   extra: List[str], timeout_s: float = 180.0
                   ) -> Optional[Path]:
    """Compile ``sources[0]`` (with ``sources[1:]`` as staleness inputs,
    e.g. included headers) into ``target`` unless the target is already
    newer than every source.  Returns the target path, or None when the
    toolchain is unavailable or the build fails (the compiler's stderr is
    surfaced — a syntax error must not masquerade as "no g++")."""
    existing = [p for p in sources if p.exists()]
    if not existing:
        return None
    src_mtime = max(p.stat().st_mtime for p in existing)
    if target.exists() and target.stat().st_mtime >= src_mtime:
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: processes that start
    # together never load a half-written library
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O2", "-pthread", "-std=c++17", *extra,
             str(sources[0]), "-o", str(tmp)],
            check=True, capture_output=True, timeout=timeout_s)
        os.replace(tmp, target)
        return target
    except subprocess.CalledProcessError as e:
        print(f"cook_tpu_torch: native build of {target.name} failed:\n"
              f"{e.stderr.decode(errors='replace')[-2000:]}",
              file=sys.stderr)
        return None
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
