"""Error types of the port (counterparts of ``pyruhvro_tpu/fallback/io.py:50,94``
and ``pyruhvro_tpu/ops/decode.py:239-246``).

``MalformedAvro`` and ``shift_malformed`` keep the reference's messages
(``record <index>: <why>``). ``BatchTooLarge`` is the single-launch byte
budget signal the codec answers by halving the batch.
"""

from __future__ import annotations

__all__ = ["MalformedAvro", "shift_malformed", "BatchTooLarge"]


class MalformedAvro(ValueError):
    """Raised on truncated or invalid Avro wire bytes.

    ``index`` is the row index of the offending datum when the raiser
    knows it (None otherwise), ``err_name`` a short machine-stable slug
    (``ops.varint.ERR_SLUGS``)."""

    def __init__(self, message: str = "", index=None, err_name=None):
        super().__init__(message)
        self.index = index
        self.err_name = err_name


def shift_malformed(e: MalformedAvro, base: int) -> MalformedAvro:
    """Re-base a chunk-local error to global row indices (``base`` added
    to ``index``); the message is rewritten to match."""
    if not base or e.index is None:
        return e
    idx = e.index + base
    msg = str(e)
    prefix = f"record {e.index}: "
    detail = msg[len(prefix):] if msg.startswith(prefix) else msg
    return MalformedAvro(f"record {idx}: {detail}", index=idx,
                         err_name=e.err_name)


class BatchTooLarge(Exception):
    """Batch exceeds the single-launch byte budget (int32 offsets);
    the codec splits it and decodes the pieces (still on the device)."""
