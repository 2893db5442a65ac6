#!/usr/bin/env python
"""Render a report of the port's telemetry (counterpart of
``scripts/metrics_report.py``).

Thin wrapper over ``python -m pyruhvro_tpu_torch.telemetry``, so that
the report path is run by the unit suite
(``tests/test_torch_soak.py``). Reading a snapshot needs no card.

Usage::

    python scripts/torch_metrics_report.py report snapshot.json
    python scripts/torch_metrics_report.py prom snapshot.json
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pyruhvro_tpu_torch.runtime.telemetry import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
