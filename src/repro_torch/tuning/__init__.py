"""Per-hardware autotuning: sweep executor tunables, persist the winner.

* ``store``    — tuned-config JSON schema + load/save keyed by
  (device kind, net); ``load_tuned_config`` is what the executor calls at
  construction under ``tuned="auto"``.
* ``autotune`` — the sweep itself (``python -m repro_torch.tuning.
  autotune``).  Imported lazily: it pulls in the volume executor, which
  itself loads tuned configs from ``store``.
"""

from .store import (  # noqa: F401
    CONFIG_DIR,
    TunedConfig,
    config_key,
    config_path,
    load_tuned_config,
    normalize_device_kind,
    save_tuned_config,
)
