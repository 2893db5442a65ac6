"""The in-process capacity planner (copy of
``pyruhvro_tpu/runtime/capacity.py:66-212``: ``lookup``, ``learn``,
``seed_decoder``, ``harvest_decoder``, ``snapshot``, ``reset``).

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

Not ported yet: persistence through ``ROUTING_PROFILE.json`` and the
cost model (``entries``/``merge_entries``, ``persist_enabled``) waits for
``ROADMAP.md`` (a) 8; estimating caps from a host-decoded sample
(``DeviceDecoder.seed_caps_from_sample``) needs the host tier and waits
for (a) 4.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from .pack import bucket_len

__all__ = ["lookup", "learn", "seed_decoder", "harvest_decoder", "snapshot",
           "reset"]

_lock = threading.Lock()
# (schema fingerprint, R) -> {"item_caps": {path: int},
#                             "tot_caps": {path: int}, "str_full_B": set}
_plans: Dict[Tuple[str, int], Dict[str, Any]] = {}  # guarded-by: _lock


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


def snapshot() -> Dict[str, Any]:
    """How many plans, and for how many schemas."""
    with _lock:
        return {"plans": len(_plans), "schemas": len({fp for fp, _ in _plans})}


def reset() -> None:
    """Forget every plan (test isolation)."""
    with _lock:
        _plans.clear()
