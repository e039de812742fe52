"""Build native sources into the port's build directory, keyed by content.

Each shared object is named after the SHA-256 of its source and the headers
it includes, so an edited source or header builds a new object and a stale
one is never loaded.  The compiler writes to a temporary file that is
renamed into place, so processes that build the same source at once (test
workers) never load a half-written object.
"""

import hashlib
import logging
import os
import subprocess
import tempfile
from collections.abc import Sequence
from pathlib import Path

LOGGER = logging.getLogger(__name__)

#: gitignored output directory for every object the port compiles
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_IDMAP_SOURCE = Path(__file__).parent / "idmap.cc"


def build_object(
    source: Path, command: "list[str]", timeout: float, deps: "Sequence[Path]" = ()
) -> Path:
    """Compile ``source`` into ``BUILD_DIR`` unless its object exists.

    :param source: The source file.
    :param command: Compiler command without the output path; ``-o <path>``
        and the source path are appended.
    :param timeout: Seconds the compiler may take.
    :param deps: Headers the source includes; they are part of the hash.
    :raises subprocess.CalledProcessError: When the compiler fails (its
        stderr is on the exception).
    :return: Path of the shared object; the compiler's output is beside it
        with the suffix ``.log``.
    """
    h = hashlib.sha256(source.read_bytes())
    for dep in deps:
        h.update(dep.read_bytes())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        done = subprocess.run(
            [*command, "-o", tmp, str(source)],
            check=True,
            capture_output=True,
            text=True,
            timeout=timeout,
        )
        # the compiler's report (e.g. ptxas register counts) stays readable
        out.with_suffix(".log").write_text(done.stdout + done.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_idmap() -> Path | None:
    """Compile (if needed) and return the id-map object, or ``None``."""
    try:
        path = build_object(
            _IDMAP_SOURCE, ["g++", "-O3", "-std=c++20", "-shared", "-fPIC", "-pthread"], 120
        )
    except (subprocess.SubprocessError, OSError) as e:
        LOGGER.warning("native idmap build failed (%s); using python fallback", e)
        return None
    LOGGER.info("native idmap: %s", path)
    return path
