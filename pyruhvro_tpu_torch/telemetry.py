"""Public alias and CLI of :mod:`pyruhvro_tpu_torch.runtime.telemetry`
(the counterpart of ``pyruhvro_tpu/telemetry.py``).

Usage::

    python -m pyruhvro_tpu_torch.telemetry report snapshot.json
    python -m pyruhvro_tpu_torch.telemetry prom snapshot.json
    python -m pyruhvro_tpu_torch.telemetry perfetto snapshot.json -o trace.json
    python -m pyruhvro_tpu_torch.telemetry route-report snapshot.json
    python -m pyruhvro_tpu_torch.telemetry what-if snapshot.json

``snapshot.json`` is ``json.dump(telemetry.snapshot(), f)``; the
``perfetto`` output loads in ui.perfetto.dev; ``route-report`` renders the
routing ledger and the learned cost model, ``what-if`` replays the ledger.
"""

import sys

from .runtime.telemetry import *  # noqa: F401,F403
from .runtime.telemetry import main

if __name__ == "__main__":
    sys.exit(main())
