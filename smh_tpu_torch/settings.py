"""Runtime settings: JSON-persisted, saved on every set.

Counterpart of /root/reference/src/settings.rs:30-142 (same keys, same
save-on-set behaviour; `paused` is deliberately not persisted, settings.rs:5).
`hardware_acceleration` selects the TPU backend over the numpy reference,
mirroring the reference's CPU/GPU toggle. `lsd_engine` picks the CUDA
backend's line search: "native" (the C++ march on the host, the default)
or "cuda" (the host seed scan over the device ray march, kernel 4: upstream's
GPU `find_longest_line`, vision-gpu/src/lib.rs:489-538).
"""

from __future__ import annotations

import json
import pathlib
import threading
from typing import Any, Optional

_DEFAULTS: dict[str, Any] = {
    "hardware_acceleration": True,
    "github_star_modal": 0,
    "detect_markers": True,
    "grayscale_map": True,
    "squad_dir": None,
    "squad_pak_aes": None,
    "lsd_engine": "native",
}

LSD_ENGINES = ("native", "cuda")


class Settings:
    def __init__(self, path: Optional[str] = "settings.json", autosave: bool = True) -> None:
        self._path = pathlib.Path(path) if path else None
        self._autosave = autosave and path is not None
        self._lock = threading.Lock()
        self._values = dict(_DEFAULTS)
        self._paused = False
        self.load()

    # -- persistence ---------------------------------------------------------

    def load(self) -> None:
        if self._path is None or not self._path.exists():
            return
        try:
            with open(self._path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        with self._lock:
            for k in _DEFAULTS:
                if k in data and (k != "lsd_engine" or data[k] in LSD_ENGINES):
                    self._values[k] = data[k]

    def save(self) -> None:
        if self._path is None:
            return
        with self._lock:
            data = dict(self._values)
        try:
            self._path.write_text(json.dumps(data, indent=2))
        except OSError:
            pass

    # -- accessors -----------------------------------------------------------

    def get(self, key: str) -> Any:
        with self._lock:
            return self._values[key]

    def set(self, key: str, value: Any, save: bool = True) -> None:
        if key not in _DEFAULTS:
            raise KeyError(key)
        if key == "lsd_engine" and value not in LSD_ENGINES:
            raise ValueError(f"lsd_engine must be one of {LSD_ENGINES}, not {value!r}")
        with self._lock:
            self._values[key] = value
        if save and self._autosave:
            self.save()

    # Typed conveniences (same names as the reference's accessors).
    def hardware_acceleration(self) -> bool:
        return bool(self.get("hardware_acceleration"))

    def detect_markers(self) -> bool:
        return bool(self.get("detect_markers"))

    def grayscale_map(self) -> bool:
        return bool(self.get("grayscale_map"))

    def lsd_engine(self) -> str:
        return self.get("lsd_engine")

    def squad_dir(self) -> Optional[str]:
        return self.get("squad_dir")

    def squad_pak_aes(self) -> Optional[str]:
        return self.get("squad_pak_aes")

    # `paused` is not persisted (settings.rs:5).
    def paused(self) -> bool:
        return self._paused

    def set_paused(self, paused: bool) -> None:
        self._paused = paused
