"""Application entry point of the port: capture -> vision -> web on CUDA.

smh_tpu.app.App is backend-agnostic and imports no JAX at module level (its
`main` does, for the compile cache), so the port reuses it and swaps in the
port's VisionState and a VisionLoop over it. The App reads `self.state` at
call time, so the web API, the pixel inspector and the status endpoint see
the port's backend.

Usage:
  python -m smh_tpu_torch.app --synthetic --pipelined --no-web   # on a CUDA device
  python -m smh_tpu_torch.app --synthetic --debug-web   # debug telemetry + /api/debug-view
  python -m smh_tpu_torch.app --synthetic --backend numpy --device cpu   # the numpy oracle, no card
  python -m smh_tpu_torch.app --image frame.png --device cuda:1
  python -m smh_tpu_torch.app --list-maps --paks ... --ripper .. # heightmap tools

Not ported yet: --worker (the pipeline in a worker process); it exits with
a message.
"""

from __future__ import annotations

import argparse
import logging
import signal

from smh_tpu import app as _app
from smh_tpu.settings import Settings

from .vision.pipeline import VisionLoop, VisionState

log = logging.getLogger(__name__)

NOT_PORTED = {
    "worker": "--worker (the vision pipeline in a worker process) is not ported to the CUDA backend yet",
}


class App(_app.App):
    """smh_tpu's App with the port's VisionState on `device` ("cuda",
    "cuda:N" or "cpu")."""

    def __init__(
        self,
        source,
        settings: Settings | None = None,
        device="cuda",
        pipelined: bool = False,
        scales_async: bool = False,
        debug_web: bool = False,
        worker: bool = False,
        **kwargs,
    ) -> None:
        if worker:
            raise NotImplementedError(NOT_PORTED["worker"])
        super().__init__(
            source, settings=settings, pipelined=pipelined, scales_async=scales_async,
            debug_web=debug_web, **kwargs,
        )
        jax_state = self.state
        # --debug-web collects the per-frame OCR boxes and scale overlays, and
        # joins the scales branch every frame, as smh_tpu's App does.
        self.state = VisionState(
            settings=self.settings, ocr_engine=self.ocr_engine, device=device,
            collect_debug_overlays=debug_web, scales_async=scales_async and not debug_web,
        )
        jax_state.close()
        self.loop = VisionLoop(self.state, self.capture, self._on_update, pipelined=pipelined)


def build_parser() -> argparse.ArgumentParser:
    """smh_tpu.app's command line without --warmup, with --device and the
    backends "cuda" and "numpy"."""
    ap = argparse.ArgumentParser(description="Squad Mortar Helper (PyTorch + CUDA)")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--image", help="use a single screenshot as the frame source")
    src.add_argument("--dir", help="cycle screenshots from a directory")
    src.add_argument("--video", help="loop frames from a video recording")
    src.add_argument("--screen", action="store_true",
                     help="live screen capture (X11 root window / ImageGrab)")
    src.add_argument("--synthetic", action="store_true", help="built-in demo frame")
    ap.add_argument("--region", default=None, metavar="X,Y,W,H",
                    help="with --screen: clip to the game window's bounds")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--dpi", type=int, default=None)
    ap.add_argument("--backend", choices=["cuda", "numpy"], default=None)
    ap.add_argument("--device", default="cuda", help='CUDA device of the cuda backend ("cuda:N")')
    ap.add_argument("--no-web", action="store_true")
    ap.add_argument(
        "--pipelined", action="store_true",
        help="overlap the next frame's upload and device work with the current "
             "frame's result processing",
    )
    ap.add_argument("--worker", action="store_true", help="not ported to the CUDA backend yet")
    ap.add_argument("--debug-web", action="store_true",
                    help="broadcast debug telemetry to web clients (event id 100): "
                         "per-frame timeshares, OCR boxes and scale overlays")
    ap.add_argument("--sync-scales", action="store_true",
                    help="join the scales branch every frame like the reference "
                         "(default: async — markers publish immediately, the ratio "
                         "lags <=1 frame; it only changes on zoom)")
    ap.add_argument("--settings", default="settings.json")
    ap.add_argument("--dumplogs", action="store_true", help="also log to smh.log")
    ap.add_argument("--list-maps", action="store_true")
    ap.add_argument("--rip", metavar="MAP_PATH", help="rip a heightmap into the .smhhm cache")
    ap.add_argument("--paks", nargs="*", default=[])
    ap.add_argument("--aes", default=None)
    ap.add_argument("--ripper", default=None, help="ripper executable override")
    ap.add_argument("--cache-dir", default="heightmaps")
    ap.add_argument("--skip-cache", action="store_true")
    ap.add_argument("--export-png", metavar="OUT.png", help="with --rip: export L16 PNG")
    ap.add_argument("--heightmap", help="load a .smhhm heightmap at startup")
    ap.add_argument("--fit-to-minimap", action="store_true",
                    help="align the heightmap by fitting it to the detected minimap bounds")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for flag, message in NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(message)

    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if args.dumplogs:
        from smh_tpu.utils.ringlog import CollapsingFileHandler

        handlers.append(CollapsingFileHandler("smh.log"))
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s",
        handlers=handlers,
    )

    if not args.paks:
        from smh_tpu.heightmaps import ripper as _ripper

        discovered = _ripper.discover_paks()
        if discovered:
            log.info("auto-discovered %d pak dir(s): %s", len(discovered), discovered)
            args.paks = discovered

    if args.list_maps or args.rip:
        from smh_tpu.heightmaps import browser, ripper

        exe = args.ripper or ripper.DEFAULT_EXE
        if args.list_maps:
            for layer in ripper.list_maps(args.paks, args.aes, exe=exe):
                print(layer)
            return 0
        hm = browser.load_or_rip(
            args.rip, args.paks, args.aes,
            cache_dir=args.cache_dir, exe=exe, skip_cache=args.skip_cache,
        )
        if hm is None:
            print("layer has no heightmap")
            return 1
        print(f"cached {args.rip} ({hm.width}x{hm.height}) in {args.cache_dir}/")
        if args.export_png:
            browser.export_png(hm, args.export_png)
            print(f"wrote {args.export_png}")
        return 0

    settings = Settings(path=args.settings)
    if args.backend:
        # An override for this run only: a CLI flag must not rewrite settings.json.
        settings.set("hardware_acceleration", args.backend == "cuda", save=False)

    app = App(
        _app._build_source(args), settings=settings, device=args.device, port=args.port,
        serve=not args.no_web, pipelined=args.pipelined, scales_async=not args.sync_scales,
        debug_web=args.debug_web, paks=args.paks, aes=args.aes, ripper_exe=args.ripper, cache_dir=args.cache_dir,
    )

    if args.heightmap:
        from smh_tpu.squadex import heightmaps as hms

        hm = hms.load_smhhm(args.heightmap)
        if hm is None:
            log.error("failed to load heightmap %s", args.heightmap)
            return 1
        app.select_heightmap(hm)
    if args.fit_to_minimap:
        app.set_fit_to_minimap(True)

    # The first Ctrl+C requests a clean shutdown, the third force-exits.
    sigint_count = [0]

    def handle_sigint(signum, frame):
        sigint_count[0] += 1
        if sigint_count[0] >= 3:
            log.error("third interrupt: force exit")
            import os

            os._exit(130)
        log.info("shutting down... (Ctrl+C x%d; 3rd force-exits)", sigint_count[0])
        app._shutdown.set()

    signal.signal(signal.SIGINT, handle_sigint)

    app.start()
    app.wait()
    app.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
