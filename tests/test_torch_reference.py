"""The reference's native module, made ready for the port's parity tests.

smh_tpu's native host module (`smh_tpu/native/__init__.py`) builds
`libsmhnative.so` and `smh_consts.h` in place, in its source directory,
at first use: no lock across processes, no atomic rename. Under pytest-xdist
several workers of a fresh tree (the library is an untracked build output)
may run g++ on the same output at once; a worker that loads a torn library,
or compiles against a torn header, gets None, and `_tried` keeps it None for
the rest of that worker. The reference then falls back to its XLA march
(`lsd_engine="auto"` -> "tpu") and its markers differ from the port's by
sub-pixels.

`reference_native()` makes the module usable in this process. Under an
`fcntl.flock` on one lock file in the temp directory it builds the library,
when it is missing or older than its sources, from private copies of the
source and the generated header into a temporary name, moves it into place
with `os.replace`, resets `_tried` and loads again. It retries for a bounded
time and then fails the test loudly; it never skips.

The port's parity test files that reach smh_tpu's native module (directly,
or through TpuBackend or VisionState) import its module-scoped autouse
fixture, which pytest then applies to every test of the importing file:

    from test_torch_reference import _reference_native  # noqa: F401
"""

from __future__ import annotations

import fcntl
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import pytest

from smh_tpu import consts as jconsts
from smh_tpu import native as jnative

LOCK_FILE = pathlib.Path(tempfile.gettempdir()) / "smh_tpu_native_build.lock"
TIMEOUT_S = 300.0


def _sources_mtime() -> float:
    """The newest of the inputs smh_tpu.native.load() rebuilds on."""
    toml = pathlib.Path(jconsts.__file__).parent / "consts.toml"
    return max(jnative._SRC.stat().st_mtime, toml.stat().st_mtime)


def _fresh() -> bool:
    so = jnative._SO
    return so.exists() and so.stat().st_mtime >= _sources_mtime()


def _build_atomically() -> None:
    """g++ with smh_tpu.native._build's flags, on private copies of the
    source and the consts header, into a temporary name beside the library;
    then one rename, so a loader in another process sees the old file or the
    new one, never a part."""
    so = jnative._SO
    tmp_so = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    header = jconsts.generate_c_header()
    with tempfile.TemporaryDirectory(prefix="smhnative-") as d:
        src = pathlib.Path(d) / jnative._SRC.name
        src.write_bytes(jnative._SRC.read_bytes())
        (pathlib.Path(d) / "smh_consts.h").write_text(header)
        cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-o", str(tmp_so), str(src), "-lm"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except BaseException:
            tmp_so.unlink(missing_ok=True)
            raise
    in_tree = jnative._HERE / "smh_consts.h"
    if not in_tree.exists() or in_tree.read_text() != header:
        tmp_h = in_tree.with_name(f"{in_tree.name}.{os.getpid()}.tmp")
        tmp_h.write_text(header)
        os.replace(tmp_h, in_tree)
    os.replace(tmp_so, so)


def reference_native(timeout_s: float = TIMEOUT_S):
    """smh_tpu.native's loaded library, building it first if need be.
    Fails the calling test if it is still unavailable after timeout_s."""
    if jnative._lib is not None:
        return jnative._lib
    deadline = time.monotonic() + timeout_s
    errors: list[str] = []
    LOCK_FILE.parent.mkdir(parents=True, exist_ok=True)
    with open(LOCK_FILE, "a+") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while True:
                try:
                    if not _fresh():
                        _build_atomically()
                    with jnative._lock:
                        jnative._tried = False
                    lib = jnative.load()
                    if lib is not None:
                        return lib
                    errors.append("smh_tpu.native.load() returned None")
                except (OSError, subprocess.SubprocessError) as e:
                    stderr = getattr(e, "stderr", b"") or b""
                    errors.append(f"{e!r} {stderr.decode(errors='replace')[-400:]}")
                if time.monotonic() >= deadline:
                    pytest.fail(
                        f"smh_tpu's native module is unavailable after {timeout_s:.0f} s: " + " | ".join(errors[-3:]),
                        pytrace=False,
                    )
                time.sleep(0.5)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    reference_native()


@pytest.fixture(scope="module")
def port_native():
    """The port's native module, built if need be (one process builds under
    its file lock; the rest wait for it and load its library). A test that
    needs it fails with the compiler's message if it does not build, and
    skips only on a machine with no g++."""
    from smh_tpu_torch import native

    if not native.available():
        if shutil.which("g++") is None:
            pytest.skip("no g++: the port's native module cannot build")
        pytest.fail(f"the port's native module did not build: {native.build_error}", pytrace=False)
    return native


def test_reference_native_loads():
    assert jnative.available()
    assert jnative._SO.exists() and jnative._SO.stat().st_mtime >= _sources_mtime()


def test_reference_auto_engine_resolves_to_native():
    """The condition the build race broke: a reference backend asked for
    lsd_engine="auto" takes the native engine, as the port's does."""
    from smh_tpu.vision import tpu_backend as tb

    assert tb.TpuBackend(lsd_engine="auto").lsd_engine == "native"
    assert tb.TpuBackend().lsd_engine == "native"


def test_reference_native_recovers_after_a_failed_load(monkeypatch):
    """A worker whose first load came back None (a torn file) is not stuck:
    the helper clears _tried and loads again."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    assert not jnative.available()
    assert reference_native() is not None
    assert jnative.available()
