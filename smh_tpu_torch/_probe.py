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


# A timeline of a kernel: clock64() of thread 0 of every block at named
# points of its source (each stamp after a value it names has arrived, so a
# load's wait lands before the stamp), into a device array that
# smh_probe_timeline copies out. Clocks are per SM: only differences within a
# block mean anything.
TIMELINE_BLOCKS = 16384
_TIMELINE_HEAD = """
__device__ long long probe_tl[{blocks} * {stamps}];  // probe

// Stamp k of this block, once `dep` has arrived (the mov reads it).
__device__ __forceinline__ void probe_stamp(int k, unsigned dep) {{
  unsigned sink;
  asm volatile("mov.b32 %0, %1;" : "=r"(sink) : "r"(dep));
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  if (blk < {blocks}) probe_tl[blk * {stamps} + k] = clock64();
}}

extern "C" int smh_probe_timeline(void* dst, long long bytes, void* stream) {{
  return (int)cudaMemcpyFromSymbolAsync(dst, probe_tl, bytes, 0, cudaMemcpyDeviceToDevice,
                                        static_cast<cudaStream_t>(stream));
}}

extern "C" int smh_probe_timeline_clear(void* stream) {{
  void* at = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&at, probe_tl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemsetAsync(at, 0, sizeof(probe_tl), static_cast<cudaStream_t>(stream));
}}
"""


def timeline_patches(anchor: str, stamps, who: str = "threadIdx.x == 0") -> list:
    """Patches that add the timeline to a source: its head after `anchor`
    (text that ends the source's includes), then for each (text, k, dep) of
    `stamps` the stamp k of thread 0 (the thread for which `who` holds)
    inserted before `text`, once the u32 `dep` has arrived."""
    head = _TIMELINE_HEAD.format(blocks=TIMELINE_BLOCKS, stamps=len(stamps))
    return [(anchor, anchor + head)] + [
        (text, f"  if ({who}) probe_stamp({k}, (unsigned)({dep}));  // probe\n" + text)
        for text, k, dep in stamps]


def timeline_of(lib, call, n_stamps: int, device) -> "torch.Tensor":
    """The stamps of one call() of a timeline build: int64 [blocks, n_stamps]
    (clock64 values of each block's thread 0; the blocks that stamped
    every point)."""
    import torch

    stream = torch.cuda.current_stream(device).cuda_stream
    lib.smh_probe_timeline.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.smh_probe_timeline_clear.argtypes = [ctypes.c_void_p]
    _build.check(lib.smh_probe_timeline_clear(stream), "smh_probe_timeline_clear")
    call()
    out = torch.empty((TIMELINE_BLOCKS, n_stamps), dtype=torch.int64, device=device)
    _build.check(lib.smh_probe_timeline(out.data_ptr(), out.numel() * 8, stream), "smh_probe_timeline")
    out = out.cpu()
    return out[(out != 0).all(dim=1)]


def timeline_summary(stamps, names) -> dict:
    """{phase: [median, max] cycles over the blocks} for the phases between
    consecutive stamps (names[k]: the phase that ends at stamp k + 1), and
    "total": the first stamp to the last."""
    d = (stamps[:, 1:] - stamps[:, :-1]).double()
    out = {name: [float(d[:, k].median()), float(d[:, k].max())] for k, name in enumerate(names)}
    total = (stamps[:, -1] - stamps[:, 0]).double()
    out["total"] = [float(total.median()), float(total.max())]
    return out


def children_in_turns(trees: dict, child: str, tag: str, timeout: int = 600) -> dict:
    """{tree name: [the JSON object each run printed]}: `python -c child`
    run with each tree of `trees` ({name: directory}) as its working
    directory, in turns (the first, the second, the second, the first), so
    each times that tree's own code; a child prints its result on a line
    that starts with `tag`."""
    import subprocess
    import sys

    names = list(trees)
    out = {n: [] for n in names}
    for name in names + names[::-1]:
        proc = subprocess.run([sys.executable, "-c", child], cwd=trees[name], capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"the child in {trees[name]} failed:\n{proc.stderr[-3000:]}")
        out[name].append(json.loads(next(l for l in proc.stdout.splitlines() if l.startswith(tag))[len(tag):]))
    return out
