"""The capacity planner and its persistence (copy of
``pyruhvro_tpu/runtime/capacity.py:60-212``: ``persist_enabled``,
``lookup``, ``learn``, ``seed_decoder``, ``harvest_decoder``,
``entries``, ``merge_entries``, ``snapshot``, ``reset``; and
``footprint_bytes`` with its memory probe, ``:210-236``).

Every converged ladder teaches the planner its final rung: the item cap
of each region path, the item total of each (``R``, region path), and
the ``B`` buckets whose compact string descriptors overflowed
(:func:`harvest_decoder`, called by ``DeviceDecoder._harvest_plan``). A
fresh decoder consults it first (:func:`seed_decoder`, through
``DeviceDecoder.seed_from_plan``), so a schema that any decoder of this
process has converged before starts at the learned rung: one rung, no
retry. Plans are keyed by (schema fingerprint, ``R``); values are keyed
by region path and merged by monotonic max, so merging is idempotent and
order-free.

:func:`seed_decoder` counts ``device.capacity.plan_hits`` /
``.plan_misses`` as the reference does.

Persistence rides the routing profile (:mod:`.costmodel`, version 2 of
its document, ``PYRUHVRO_TPU_ROUTING_PROFILE``): :func:`entries` gives
the plans as the document's ``capacity`` rows and :func:`merge_entries`
max-merges rows back. It is armed by ``PYRUHVRO_TPU_AUTOTUNE=1`` or, for
the plans alone, ``PYRUHVRO_TPU_CAPACITY_PERSIST=1`` (:func:`persist_enabled`):
the profile then loads at import and is saved at exit, so a fresh
process's first device call starts at the learned rung.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from . import knobs, memacct, metrics
from .pack import bucket_len

__all__ = ["persist_enabled", "lookup", "learn", "seed_decoder",
           "harvest_decoder", "entries", "merge_entries", "snapshot",
           "reset", "footprint_bytes"]

_lock = threading.Lock()
# (schema fingerprint, R) -> {"item_caps": {path: int},
#                             "tot_caps": {path: int}, "str_full_B": set}
_plans: Dict[Tuple[str, int], Dict[str, Any]] = {}  # guarded-by: _lock


def persist_enabled() -> bool:
    """``PYRUHVRO_TPU_CAPACITY_PERSIST=1``: the plans arm the routing
    profile's persistence on their own, without autotune."""
    return knobs.get_bool("PYRUHVRO_TPU_CAPACITY_PERSIST")


def lookup(fingerprint: str, R: int) -> Optional[Dict[str, Any]]:
    """A copy of the learned plan for (schema, ``R``), or None."""
    with _lock:
        plan = _plans.get((fingerprint, int(R)))
        if plan is None:
            return None
        return {"item_caps": dict(plan["item_caps"]),
                "tot_caps": dict(plan["tot_caps"]),
                "str_full_B": set(plan["str_full_B"])}


def learn(fingerprint: str, R: int, item_caps: Dict[str, int],
          tot_caps: Dict[str, int], str_full_B=()) -> None:
    """Fold one converged rung into the plan (monotonic max per key)."""
    if not fingerprint:
        return
    key = (fingerprint, int(R))
    with _lock:
        plan = _plans.get(key)
        if plan is None:
            plan = _plans[key] = {"item_caps": {}, "tot_caps": {},
                                  "str_full_B": set()}
        for path, cap in (item_caps or {}).items():
            if int(cap) > plan["item_caps"].get(path, 0):
                plan["item_caps"][path] = int(cap)
        for path, cap in (tot_caps or {}).items():
            if int(cap) > plan["tot_caps"].get(path, 0):
                plan["tot_caps"][path] = int(cap)
        plan["str_full_B"].update(int(b) for b in str_full_B)


def seed_decoder(decoder, R: int) -> bool:
    """Merge the learned plan for (``decoder.fingerprint``, ``R``) into the
    decoder's capacity memory (monotonically: seeding never shrinks a cap
    the decoder already climbed to). True when a plan existed."""
    plan = lookup(decoder.fingerprint, R)
    if plan is None:
        metrics.inc("device.capacity.plan_misses")
        return False
    prog = decoder.prog
    with decoder._lock:
        for rid in range(1, len(prog.regions)):
            path = prog.regions[rid]
            icap = plan["item_caps"].get(path, 0)
            if icap > decoder._item_caps[rid]:
                decoder._item_caps[rid] = bucket_len(icap, minimum=icap)
            tcap = plan["tot_caps"].get(path, 0)
            if tcap > decoder._tot_cap_mem.get((R, rid), 0):
                decoder._tot_cap_mem[(R, rid)] = tcap
        for b in plan["str_full_B"]:
            decoder._str_full.add((R, int(b)))
    metrics.inc("device.capacity.plan_hits")
    return True


def harvest_decoder(decoder, R: int) -> None:
    """Teach the planner a decoder's current rung for ``R``."""
    prog = decoder.prog
    if len(prog.regions) <= 1 and not decoder._str_full:
        return
    with decoder._lock:
        item_caps = {prog.regions[rid]: decoder._item_caps[rid]
                     for rid in range(1, len(prog.regions))
                     if decoder._item_caps[rid] > 0}
        tot_caps = {prog.regions[rid]: decoder._tot_cap_mem[(R, rid)]
                    for rid in range(1, len(prog.regions))
                    if (R, rid) in decoder._tot_cap_mem}
        str_full = {b for (r, b) in decoder._str_full if r == R}
    learn(decoder.fingerprint, R, item_caps, tot_caps, str_full)


def entries() -> List[Dict[str, Any]]:
    """The plans as JSON rows for the profile's ``capacity`` section."""
    with _lock:
        return [
            {
                "schema": fp,
                "R": R,
                "item_caps": dict(plan["item_caps"]),
                "tot_caps": dict(plan["tot_caps"]),
                "str_full_B": sorted(plan["str_full_B"]),
            }
            for (fp, R), plan in sorted(_plans.items())
        ]


def merge_entries(rows) -> int:
    """Fold profile ``capacity`` rows into the planner (max-merge); a
    malformed row is skipped, so an old or foreign profile never fails
    the load. Returns the rows merged."""
    merged = 0
    for row in rows or ():
        try:
            learn(
                str(row["schema"]), int(row["R"]),
                {str(k): int(v) for k, v in (row.get("item_caps")
                                             or {}).items()},
                {str(k): int(v) for k, v in (row.get("tot_caps")
                                             or {}).items()},
                [int(b) for b in row.get("str_full_B") or ()],
            )
            merged += 1
        except (KeyError, TypeError, ValueError, AttributeError):
            continue
    return merged


def snapshot() -> Dict[str, Any]:
    """How many plans, and for how many schemas."""
    with _lock:
        return {"plans": len(_plans), "schemas": len({fp for fp, _ in _plans})}


def reset() -> None:
    """Forget every plan (test isolation; ``costmodel.reset()`` calls it).
    The profile on disk stays."""
    with _lock:
        _plans.clear()


def footprint_bytes() -> int:
    """Approximate host bytes of the plans (explicit per-object overhead
    estimates, as in the reference; the values are small ints)."""
    with _lock:
        n = 0
        for (fp, _R), plan in _plans.items():
            n += 160 + len(fp)
            n += sum(len(p) + 64 for p in plan["item_caps"])
            n += sum(len(p) + 64 for p in plan["tot_caps"])
            n += 64 * len(plan["str_full_B"])
        return n


memacct.register_probe(
    "capacity",
    lambda: {"bytes": float(footprint_bytes()),
             "items": float(len(_plans))},
)
