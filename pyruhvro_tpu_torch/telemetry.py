"""Public alias and CLI of :mod:`pyruhvro_tpu_torch.runtime.telemetry`
(the counterpart of ``pyruhvro_tpu/telemetry.py``).

Usage::

    python -m pyruhvro_tpu_torch.telemetry report snapshot.json
    python -m pyruhvro_tpu_torch.telemetry prom snapshot.json
    python -m pyruhvro_tpu_torch.telemetry perfetto snapshot.json -o trace.json
    python -m pyruhvro_tpu_torch.telemetry route-report snapshot.json
    python -m pyruhvro_tpu_torch.telemetry what-if snapshot.json
    python -m pyruhvro_tpu_torch.telemetry slo-report snapshot.json
    python -m pyruhvro_tpu_torch.telemetry audit-report snapshot.json
    python -m pyruhvro_tpu_torch.telemetry timeline snapshot.json [--json]
    python -m pyruhvro_tpu_torch.telemetry incident-report incident_1_1_x.json
    python -m pyruhvro_tpu_torch.telemetry serve snapshot.json --port 9000

``snapshot.json`` is ``json.dump(telemetry.snapshot(), f)``; the
``perfetto`` output loads in ui.perfetto.dev; ``route-report`` renders the
routing ledger and the learned cost model, ``what-if`` replays the ledger;
``incident-report`` renders a bundle written into
``PYRUHVRO_TPU_INCIDENT_DIR``; ``serve`` answers ``/metrics``,
``/healthz`` and ``/snapshot`` from the saved file. A file that is
missing, not JSON or not a snapshot exits 2.
"""

import sys

from .runtime.telemetry import *  # noqa: F401,F403
from .runtime.telemetry import main

if __name__ == "__main__":
    sys.exit(main())
