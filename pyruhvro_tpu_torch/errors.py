"""Error types of the port (counterparts of ``pyruhvro_tpu/fallback/io.py:50,94``
and ``pyruhvro_tpu/ops/decode.py:239-246``).

``MalformedAvro`` and ``shift_malformed`` keep the reference's messages
(``record <index>: <why>``) and fields (``index``, ``err_name``, ``tier``,
``indices``, kept across a pickle round trip). ``BatchTooLarge`` is the single-launch byte
budget signal the codec answers by halving the batch.
``DeviceCapacityExceeded`` is the pipeline engine's item-capacity limit
(and its ladder's failure to converge); the reference's codec serves such
a batch from its host tier (``codec.py:289-294``), the port has none and
raises it to the caller.

:func:`mark_value_error` tags the errors of a record's value that a host
stage of the device tier raises without naming a row: the Arrow
assembly's invalid UTF-8, decimal precision and duration range, and the
encode extraction's values that do not fit. They are the only errors of
the device tier, besides the walk's row errors, that a tolerant policy
(``api.py``) isolates; every other error propagates.
"""

from __future__ import annotations

__all__ = ["MalformedAvro", "shift_malformed", "BatchTooLarge",
           "DeviceCapacityExceeded", "mark_value_error", "is_value_error"]


class MalformedAvro(ValueError):
    """Raised on truncated or invalid Avro wire bytes.

    ``index`` is the row index of the offending datum when the raiser
    knows it (None otherwise), ``err_name`` a short machine-stable slug
    (``ops.varint.ERR_SLUGS``), ``tier`` the tier that found it
    (``"device"`` for a row error of a device walk, None otherwise)."""

    def __init__(self, message: str = "", index=None, err_name=None,
                 tier=None, indices=None):
        super().__init__(message)
        self.index = index
        self.err_name = err_name
        self.tier = tier
        # every bad row's (index, slug) when the raiser knows them all
        self.indices = indices

    def __reduce__(self):
        # ValueError's own reduce rebuilds from args alone and would drop
        # the structured fields across a pickle round trip
        return (_rebuild_malformed,
                (self.args, self.index, self.err_name, self.tier,
                 self.indices))


def _rebuild_malformed(args, index, err_name, tier, indices):
    e = MalformedAvro(*args)
    e.index, e.err_name, e.tier, e.indices = index, err_name, tier, indices
    return e


def shift_malformed(e: MalformedAvro, base: int) -> MalformedAvro:
    """Re-base a chunk-local error to global row indices (``base`` added
    to ``index``); the message is rewritten to match."""
    if not base or e.index is None:
        return e
    idx = e.index + base
    msg = str(e)
    prefix = f"record {e.index}: "
    detail = msg[len(prefix):] if msg.startswith(prefix) else msg
    indices = None if e.indices is None else [
        (i + base, slug) for i, slug in e.indices]
    return MalformedAvro(f"record {idx}: {detail}", index=idx,
                         err_name=e.err_name, tier=e.tier, indices=indices)


class BatchTooLarge(Exception):
    """Batch exceeds the single-launch byte budget (int32 offsets);
    the codec splits it and decodes the pieces (still on the device)."""


class DeviceCapacityExceeded(Exception):
    """Batch needs more per-record item slots than the device path
    supports (copy of ``pyruhvro_tpu/ops/decode.py:239-241``)."""


def mark_value_error(e: Exception) -> Exception:
    """Tag ``e`` as an error of a record's value that names no row (the
    type and message stay the reference's); returns ``e``."""
    e.value_error = True
    return e


def is_value_error(e: BaseException) -> bool:
    """True for an error tagged by :func:`mark_value_error`."""
    return getattr(e, "value_error", False)
