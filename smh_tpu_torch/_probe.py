"""What the kernel probes share: their sources patched as text, and one
nvcc per build, all started together, each build into its own library
under smh_tpu_torch/build/probe-<hash of its sources>.

A build is {file name: source text}; a patch set is {file name: [(text,
replacement), ...]}. Every text must occur in its file, so a probe whose
patch no longer applies fails instead of timing the unpatched kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import pathlib
import subprocess

from . import _build


def patched(csrc: pathlib.Path, names, patches: dict) -> dict:
    """{file name: text} of the files `names` of csrc, each with its patches
    applied in order."""
    texts = {}
    for name in names:
        text = (csrc / name).read_text()
        for old, new in patches.get(name, ()):
            if old not in text:
                raise RuntimeError(f"probe patch does not apply to {name}: {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def build(builds: dict, sources, ptxas_of: str | None = None) -> dict:
    """{build: {file name: text}} -> {build: ctypes library}: the files
    `sources` of each build compiled and linked into one library (the
    others are headers), every entry of _build._SIGNATURES that it holds
    bound. With ptxas_of, prints that build's register and spill lines."""
    nvcc = _build._nvcc()
    jobs = {}
    for name, texts in builds.items():
        key = hashlib.sha256(json.dumps(texts, sort_keys=True).encode()).hexdigest()[:16]
        d = _build.BUILD_ROOT / f"probe-{key}"
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        so = d / "libprobe.so"
        verbose = ["-Xptxas", "-v"] if name == ptxas_of else []
        cmd = [nvcc, *_build.NVCC_FLAGS, *verbose, "-I", str(d), "-shared", "-o", str(so), *(str(d / s) for s in sources)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name == ptxas_of:
            print(f"ptxas ({name}): " + " | ".join(l.strip() for l in log.splitlines() if "registers" in l or "spill" in l),
                  flush=True)
        lib = ctypes.CDLL(str(so))
        for entry in (e for e in _build._SIGNATURES if hasattr(lib, e)):
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs
