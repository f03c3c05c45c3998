"""Build the JAX package's native library once, before the test workers
start.

``pero_ocr_tpu/utils/native.py`` runs ``make -C native`` at its first
use and writes ``native/libperotpu.so`` in place (the file is not in
git).  Under xdist every worker of a fresh checkout would build it at
once, and a worker that loads a half-written file keeps that failure
for its whole life, so ``tests/test_native.py`` would skip there.  This
hook runs in the controller only (``workerinput`` marks a worker) and
only while the library is missing: one ``make``, up to 120 s.  If the
build fails it does nothing more, and the loader behaves as before.
"""

import os
import subprocess

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def pytest_configure(config):
    if hasattr(config, "workerinput") or os.path.exists(os.path.join(NATIVE, "libperotpu.so")):
        return
    try:
        subprocess.run(["make", "-C", NATIVE], check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        pass
