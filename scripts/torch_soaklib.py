"""What the port's soak scripts share (``scripts/torch_*_soak.py``).

Every soak runs on the card by default: :func:`card` raises
``RuntimeError`` when ``--device cuda`` names a card that is not there,
and ``--device cpu`` runs the kernels' plain versions only because the
caller asked. Reports go under ``build/pyruhvro_tpu_torch/`` unless
``--out`` names another file. Imports torch, numpy, pyarrow and the
port, nothing of JAX or of ``pyruhvro_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BUILD = REPO / "build" / "pyruhvro_tpu_torch"

# a record that a tier rejects: the ValueError family of the oracle
# (MalformedAvro, invalid values) and OverflowError (durations). The
# device tier's limits (UnsupportedOnDevice is a ValueError too,
# DeviceCapacityExceeded, BatchTooLarge) are not rejects: they raise
# through every soak.
DATA_ERRORS = (ValueError, OverflowError)


class Divergence(Exception):
    """A soak's result differs from what it is held to (raised by the
    soaks' checks, which ``python -O`` keeps, as it would not keep an
    ``assert``)."""


def parser(doc: str, out_name: str) -> argparse.ArgumentParser:
    """The soaks' common arguments: ``--device`` (default ``cuda``) and
    ``--out`` (default ``build/pyruhvro_tpu_torch/<out_name>``)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card, RuntimeError without "
                         "one) or cpu (the kernels' plain versions)")
    ap.add_argument("--out", default=str(BUILD / out_name),
                    help="the report's JSON file")
    return ap


@contextlib.contextmanager
def watchdog(seconds: float):
    """The soaks' no-hang guard: a body that outlasts ``seconds`` dumps
    every thread's stack and ends the process."""
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def card(device: str) -> str:
    """The device the soak runs on, checked: no card under ``cuda``
    raises ``RuntimeError``, never a silent CPU run. Returns the card's
    line (``nvidia-smi`` name and power limit, or ``torch``'s name), or
    ``"cpu"``."""
    from pyruhvro_tpu_torch.ops.walk_decode import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    import torch

    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        line = []
    return line[0] if line else torch.cuda.get_device_name(dev)


def is_reject(exc: BaseException) -> bool:
    """A data error, not a limit of the device tier."""
    from pyruhvro_tpu_torch import UnsupportedOnDevice

    return isinstance(exc, DATA_ERRORS) and not isinstance(
        exc, UnsupportedOnDevice)


def oracle(datums, entry):
    """The port's pure-Python oracle (``fallback/decoder.py``): the
    batch every tier is held to."""
    from pyruhvro_tpu_torch.fallback.decoder import decode_to_record_batch

    return decode_to_record_batch(datums, entry.ir, entry.arrow_schema)


def verdict(fn):
    """``(True, result)`` or ``(False, exc)`` when ``fn`` raises a data
    error; any other exception propagates."""
    try:
        return True, fn()
    except DATA_ERRORS as e:
        if not is_reject(e):
            raise
        return False, e


# the counters that say a call reached a host tier (the chaos soak's
# ``host_routed`` reads the same)
HOST_ROUTES = ("route.native", "route.fallback", "route.host",
               "device.host_answer")


def on_device(fn):
    """``fn()``, a public call made with ``backend="device"``, held to the
    device tier: ``Divergence`` when the call was not routed there or a
    host tier answered any of it (``route.native``, ``route.fallback``
    or ``device.host_answer`` moved). A data error ``fn`` raises
    propagates after the check."""
    from pyruhvro_tpu_torch.runtime import metrics

    c0 = metrics.snapshot()
    try:
        return fn()
    finally:
        c1 = metrics.snapshot()
        moved = sorted(k for k in c1 if k.startswith(HOST_ROUTES)
                       and c1[k] != c0.get(k, 0))
        if moved:
            raise Divergence(f"a host tier answered a device call: {moved}")
        if c1.get("route.device", 0) == c0.get("route.device", 0):
            raise Divergence("the call was not routed to the device tier")


def tolerant(corpus, schema, **kw):
    """``(batch, [(index, slug)])`` of an ``on_error="skip"`` call."""
    import pyruhvro_tpu_torch as p

    batch, quar = p.deserialize_array(corpus, schema, on_error="skip",
                                      return_errors=True, **kw)
    return batch, [(q.index, q.error) for q in quar]


def write_report(path: str, doc: dict) -> None:
    """Write ``doc`` as JSON through the port's atomic writer, creating
    the directory."""
    from pyruhvro_tpu_torch.runtime import fsio

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fsio.atomic_write_json(path, doc)
