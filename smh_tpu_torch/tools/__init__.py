"""The port's operator and offline entry points, each a copy of its
counterpart in the repo's `tools/` (which drive smh_tpu) that drives
smh_tpu_torch instead:

  * analyze_video     — a recording -> per-frame detections JSONL, through
                        BatchPipeline.stream (decoding needs OpenCV)
  * compare_backends  — a frame through the numpy oracle and CudaBackend,
                        every intermediate diffed
  * render_detections — detected marker lines drawn over a frame -> PNG
  * soak_corpus       — the screenshot corpus against its goldens
  * soak_worker       — worker RSS under the recycle guard
  * probe_cold_start  — the first frames' wall time split by stage

Run each as `python -m smh_tpu_torch.tools.<name>`. Each takes --device
("cuda" by default, "cuda:N", or "cpu" for the kernels' plain versions);
a CUDA device that is absent raises. None imports jax, smh_tpu or the
repo's `tools/`.
"""
