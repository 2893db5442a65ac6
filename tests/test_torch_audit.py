"""The port's differential audit (``pyruhvro_tpu_torch/runtime/audit.py``
and ``coldigest.py``, copies of the reference's) held against the
reference on the CPU.

* **Digests.** The port's column digests of its own decode (the kernels'
  plain versions under ``device="cpu"``, and the host tier) equal the
  reference's digests of the reference's oracle, batch for batch and
  including a sliced sparse-union column; ``input_digest`` of a list, a
  ``BinaryArray`` and a ``RecordBatch`` equals the reference's.
* **Detection.** A planted one-byte corruption of the primary result is
  found in the right column at the exact row, with the reference's
  record; a truncated result is the ``#rows`` mismatch. The caller's
  result is untouched, the arm is penalised, and the next
  ``backend="device"`` call still runs on the device tier.
* **Accounting.** Budget 0, ``PYRUHVRO_TPU_NO_AUDIT`` and the tier filter
  turn it off; the shadow's counters are undone and its seconds leave
  the SLO feed; the coverage gauge (on a frozen clock, never raced), its
  age decay and the period follow the reference's arithmetic; the encode
  skip reasons count; the ``audit_shadow`` fault seam counts as the
  reference's does. Tolerance 0 throughout.
"""

import json
import os

import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu import api as ref_api  # noqa: E402
from pyruhvro_tpu.fallback.decoder import (  # noqa: E402
    decode_to_record_batch as ref_oracle)
from pyruhvro_tpu.runtime import audit as ref_audit  # noqa: E402
from pyruhvro_tpu.runtime import coldigest as ref_cd  # noqa: E402
from pyruhvro_tpu.runtime import faults as ref_faults  # noqa: E402
from pyruhvro_tpu.runtime import metrics as ref_metrics  # noqa: E402
from pyruhvro_tpu.schema.cache import (  # noqa: E402
    get_or_parse_schema as ref_schema)
from pyruhvro_tpu.utils.datagen import (  # noqa: E402
    random_datums as ref_random_datums, random_schema)

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch import api  # noqa: E402
from pyruhvro_tpu_torch.ops.arrow_build import (  # noqa: E402
    compact_union_slices)
from pyruhvro_tpu_torch.runtime.chunking import chunk_bounds  # noqa: E402
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    audit,
    coldigest,
    costmodel,
    faults,
    metrics,
    slo,
    telemetry,
)
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

KAFKA = datagen.KAFKA_SCHEMA_JSON
CPU = {"backend": "device", "device": "cpu"}
HOST = {"backend": "host", "device": "cpu"}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in ("PYRUHVRO_TPU_AUDIT_BUDGET", "PYRUHVRO_TPU_NO_AUDIT",
                 "PYRUHVRO_TPU_AUDIT_TIERS", "PYRUHVRO_TPU_FAULTS",
                 "PYRUHVRO_TPU_SLO_FILE", "PYRUHVRO_TPU_FLIGHT_DIR",
                 "PYRUHVRO_TPU_INCIDENT_DIR", "PYRUHVRO_TPU_POOL",
                 "PYRUHVRO_TPU_AUTOTUNE", "PYRUHVRO_TPU_NO_NATIVE",
                 "PYRUHVRO_TPU_MAX_DATUM_BYTES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_ROUTING_PROFILE", "")
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")
    monkeypatch.setenv("PYRUHVRO_TPU_OVERLAP_ROWS", "64")
    for mod in (telemetry, ref.telemetry):
        mod.reset()
    faults.reset()
    ref_faults.reset()
    yield
    for mod in (telemetry, ref.telemetry):
        mod.reset()
    faults.reset()
    ref_faults.reset()


@pytest.fixture
def audit_on(monkeypatch):
    """A saturating budget; tests arm the calls they audit with
    ``force_next``."""
    monkeypatch.setenv("PYRUHVRO_TPU_AUDIT_BUDGET", "1.0")


def counters(prefix="audit."):
    return {k: v for k, v in metrics.snapshot().items()
            if k.startswith(prefix)}


def flip_byte(batch, name, row):
    """One flipped byte of one row of a fixed-width column (the
    reference's ``tests/test_audit.py`` ``_flip_buffer_byte``, with the
    array's offset honoured)."""
    idx = batch.schema.names.index(name)
    arr = batch.column(idx)
    width = arr.type.bit_width // 8
    bufs = arr.buffers()
    data = bytearray(bufs[1].to_pybytes())
    data[(arr.offset + row) * width] ^= 0x01
    cols = list(batch.columns)
    cols[idx] = pa.Array.from_buffers(
        arr.type, len(arr), [bufs[0], pa.py_buffer(bytes(data))],
        offset=arr.offset)
    return pa.RecordBatch.from_arrays(cols, schema=batch.schema)


# -- digests -------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_digests_of_the_ports_decode_are_the_references(seed):
    """One random schema and corpus: the port's device tier (plain
    versions) and host tier, whole and chunked, digest equal to the
    reference's oracle under both digest modules."""
    schema = random_schema(seed)
    entry = ref_schema(schema)
    datums = ref_random_datums(entry.ir, 24, seed=seed + 5000)
    want = ref_cd.column_digests(
        ref_oracle(datums, entry.ir, entry.arrow_schema))
    for kw in (CPU, HOST):
        one = port.deserialize_array(datums, schema, **kw)
        chunked = port.deserialize_array_threaded(datums, schema, 3, **kw)
        for got in (one, chunked):
            assert coldigest.column_digests(got) == want, (schema, kw)
            assert ref_cd.column_digests(got) == want, (schema, kw)
    k = one.num_rows // 2
    assert coldigest.column_digests([one.slice(0, k), one.slice(k)]) == want


def test_sliced_sparse_union_digest_is_the_references():
    batch = port.deserialize_array(datagen.kafka_style_datums(60, seed=11),
                                   KAFKA, **CPU)
    i = batch.schema.names.index("status")
    u = batch.column(i)
    for lo, n in ((0, 30), (13, 29), (31, 29)):
        sl = u.slice(lo, n)
        compacted = compact_union_slices(batch.slice(lo, n)).column(i)
        assert coldigest.array_digest(sl) == ref_cd.array_digest(sl)
        assert coldigest.array_digest(sl) == \
            coldigest.array_digest(compacted)
    assert coldigest.array_digest(u.slice(0, 30)) != \
        coldigest.array_digest(u.slice(30, 30))


def test_input_digest_is_the_references():
    datums = datagen.kafka_style_datums(40, seed=3)
    arr = pa.array(datums, pa.binary())
    batch = port.deserialize_array(datums, KAFKA, **HOST)
    for x in (datums, arr, batch, pa.Table.from_batches([batch])):
        assert coldigest.input_digest(x) == ref_cd.input_digest(x)
    assert coldigest.input_digest(datums) == coldigest.input_digest(arr)
    assert coldigest.batch_digest(batch) == ref_cd.batch_digest(batch)


# -- clean audits --------------------------------------------------------------


@pytest.mark.parametrize("kw", [CPU, HOST], ids=["device", "host"])
def test_decode_and_encode_audit_clean(kw, audit_on):
    datums = datagen.kafka_style_datums(300, seed=4)
    audit.force_next()
    out = port.deserialize_array_threaded(datums, KAFKA, 4, **kw)
    audit.force_next()
    port.serialize_record_batch(out[1], KAFKA, 2, **kw)
    c = counters()
    assert c["audit.audited"] == 2 and c["audit.audited_rows"] == 375
    assert not c.get("audit.mismatches") and not c.get("audit.shadow_error")
    sec = telemetry.snapshot()["audit"]
    assert [e["arm"] for e in sec["per_arm"]] == sorted(
        e["arm"] for e in sec["per_arm"])
    assert {e["arm"].split("/")[0] for e in sec["per_arm"]} == {
        "device" if kw is CPU else "native"}
    # one exported (input, result) digest per call, keyed by schema
    [(fp, ring)] = audit.export_digests().items()
    assert [e["op"] for e in ring] == ["decode", "encode"]
    assert ring[0]["input"] == ref_cd.input_digest(datums)


@pytest.mark.parametrize("policy", ["skip", "null"])
def test_tolerant_results_audit_clean(policy, audit_on):
    datums = datagen.kafka_style_datums(40, seed=5)
    datums[7] = b"\xff"  # never a valid kafka record
    audit.force_next()
    port.deserialize_array(datums, KAFKA, on_error=policy, **CPU)
    c = counters()
    assert c["audit.audited"] == 1 and not c.get("audit.mismatches")
    got = port.deserialize_array(datums, KAFKA, on_error=policy, **CPU)
    entry = get_or_parse_schema(KAFKA)
    shadow = api._audit_shadow_decode(entry, datums, [(0, 40)], policy)
    want = ref_api._audit_shadow_decode(
        ref_schema(KAFKA), datums, [(0, 40)], policy)
    assert coldigest.column_digests(got) == \
        coldigest.column_digests(shadow) == ref_cd.column_digests(want)


# -- planted corruption --------------------------------------------------------


def _plant(monkeypatch, module, fn):
    real = module._maybe_audit_decode

    def corrupting(dec, entry, data, bounds, on_error, result):
        real(dec, entry, data, bounds, on_error, fn(result))

    monkeypatch.setattr(module, "_maybe_audit_decode", corrupting)


def test_planted_corruption_is_the_references_record(audit_on, monkeypatch):
    """The reference's acceptance scenario through both packages: the
    same flipped byte gives the same column, row and digests."""
    datums = datagen.kafka_style_datums(50, seed=3)
    flip = lambda b: flip_byte(b, "created_at", 17)  # noqa: E731
    _plant(monkeypatch, api, flip)
    _plant(monkeypatch, ref_api, flip)
    audit.force_next()
    ref_audit.force_next()
    batch = port.deserialize_array(datums, KAFKA, **CPU)
    want = ref.deserialize_array(datums, KAFKA, backend="host")
    assert batch.equals(want)  # the caller's result is untouched
    [m], [r] = audit.mismatches(), ref_audit.mismatches()
    keys = ("schema", "op", "column", "row_index", "primary_digest",
            "shadow_digest")
    assert {k: m[k] for k in keys} == {k: r[k] for k in keys}
    assert (m["column"], m["row_index"]) == ("created_at", 17)
    assert m["arm"] == "device/c1/none" and m["trace_id"]
    c = metrics.snapshot()
    for key in ("audit.mismatches", "audit.mismatch.created_at",
                "audit.quarantined", "router.arm_penalty",
                "router.device_penalty"):
        assert c[key] == 1, key
    assert costmodel.arm_penalized(m["schema"], m["arm"])
    assert costmodel.device_penalized(m["schema"])
    assert telemetry.snapshot()["audit"]["mismatch_records"] == [m]


def test_mismatch_on_the_device_tier_leaves_the_next_call_on_it(
        audit_on, monkeypatch):
    """A chunked device result corrupted in its second chunk: the global
    row is found; ``backend="device"`` runs the next call on the device
    tier all the same."""
    datums = datagen.kafka_style_datums(120, seed=8)
    bounds = chunk_bounds(120, 4)
    _plant(monkeypatch, api, lambda out: [
        flip_byte(b, "created_at", 5) if i == 1 else b
        for i, b in enumerate(out)])
    audit.force_next()
    out = port.deserialize_array_threaded(datums, KAFKA, 4, **CPU)
    [m] = audit.mismatches()
    assert (m["column"], m["row_index"]) == ("created_at", bounds[1][0] + 5)
    assert all(b.column(b.schema.names.index("created_at")).equals(
        w.column(w.schema.names.index("created_at")))
        for b, w in zip(out, ref.deserialize_array_threaded(
            datums, KAFKA, 4, backend="host")))
    monkeypatch.undo()
    port.deserialize_array_threaded(datums, KAFKA, 4, **CPU)
    last = telemetry.snapshot()["routing"]["ledger"][-1]
    assert last["tier"] == "device" and last["arm"] == m["arm"]


def test_row_count_mismatch_is_its_own_column(audit_on, monkeypatch):
    datums = datagen.kafka_style_datums(20, seed=9)
    cut = lambda b: b.slice(0, 15)  # noqa: E731
    _plant(monkeypatch, api, cut)
    _plant(monkeypatch, ref_api, cut)
    audit.force_next()
    ref_audit.force_next()
    port.deserialize_array(datums, KAFKA, **CPU)
    ref.deserialize_array(datums, KAFKA, backend="host")
    [m], [r] = audit.mismatches(), ref_audit.mismatches()
    assert m["column"] == r["column"] == "#rows"
    assert (m["row_index"], m["primary_digest"], m["shadow_digest"]) == \
        (r["row_index"], r["primary_digest"], r["shadow_digest"]) == \
        (15, "15", "20")


# -- switches --------------------------------------------------------------------


def test_budget_zero_is_a_noop(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_AUDIT_BUDGET", "0")
    assert not audit.enabled() and not ref_audit.enabled()
    datums = datagen.kafka_style_datums(30, seed=1)
    audit.force_next()
    batch = port.deserialize_array(datums, KAFKA, **CPU)
    assert not counters() and audit.snapshot_audit() == {}
    assert "audit" not in telemetry.snapshot()
    monkeypatch.setenv("PYRUHVRO_TPU_AUDIT_BUDGET", "1.0")
    audit.force_next()
    assert batch.equals(port.deserialize_array(datums, KAFKA, **CPU))
    assert counters()["audit.audited"] == 1


def test_the_default_budget_is_the_references(monkeypatch):
    assert audit.budget() == ref_audit.budget() == 0.005
    assert audit.enabled() and ref_audit.enabled()
    audit.set_enabled(False)
    assert not audit.enabled()
    audit.set_enabled(None)
    assert audit.enabled()


def test_no_audit_kill_switch(audit_on, monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_NO_AUDIT", "1")
    assert not audit.enabled() and not ref_audit.enabled()
    audit.force_next()
    port.deserialize_array(datagen.kafka_style_datums(10, seed=4), KAFKA,
                           **CPU)
    assert not counters()


def test_tier_filter(audit_on, monkeypatch):
    datums = datagen.kafka_style_datums(10, seed=4)
    monkeypatch.setenv("PYRUHVRO_TPU_AUDIT_TIERS", "native,fallback")
    audit.force_next()
    port.deserialize_array(datums, KAFKA, **CPU)
    assert not counters().get("audit.audited")
    port.deserialize_array(datums, KAFKA, **HOST)
    assert counters()["audit.audited"] == 1
    monkeypatch.setenv("PYRUHVRO_TPU_AUDIT_TIERS", "device")
    audit.force_next()
    port.deserialize_array(datums, KAFKA, **CPU)
    assert counters()["audit.audited"] == 2


# -- accounting --------------------------------------------------------------------


@pytest.mark.parametrize("kw", [CPU, HOST], ids=["device", "host"])
def test_shadow_work_never_reads_as_traffic(kw, monkeypatch):
    """An audited call leaves the same counters other than ``audit.*`` as
    the same call unaudited (seconds apart)."""
    datums = datagen.kafka_style_datums(40, seed=6)

    def run(budget):
        telemetry.reset()
        monkeypatch.setenv("PYRUHVRO_TPU_AUDIT_BUDGET", budget)
        if float(budget) > 0:
            audit.force_next()
        port.deserialize_array(datums, KAFKA, **kw)
        return {k: v for k, v in metrics.snapshot().items()
                if not k.startswith("audit.")}

    base, audited = run("0"), run("1.0")
    assert metrics.snapshot()["audit.audited"] == 1
    assert {k for k, v in audited.items() if v} == \
        {k for k, v in base.items() if v}
    assert {k: v for k, v in audited.items() if not k.endswith("_s")} == \
        {k: v for k, v in base.items() if not k.endswith("_s")}
    assert audit.tls_shadow_seconds() == 0.0


def test_the_slo_feed_has_the_shadow_seconds_subtracted(audit_on,
                                                        monkeypatch):
    fed, consumed = [], []
    real_consume = audit.consume_shadow_seconds

    def consume():
        consumed.append(real_consume())
        return consumed[-1]

    monkeypatch.setattr(audit, "consume_shadow_seconds", consume)
    monkeypatch.setattr(slo, "record_root",
                        lambda name, schema, dur, err: fed.append(dur))
    audit.force_next()
    port.deserialize_array(datagen.kafka_style_datums(200, seed=2), KAFKA,
                           **HOST)
    [span] = telemetry.snapshot()["spans"]
    assert consumed[0] > 0
    assert fed == [pytest.approx(span["dur_s"] - consumed[0], abs=1e-8)]


class FrozenClock:
    """The audit's ``time`` with ``monotonic`` held still, so that the
    coverage tallies do not decay between calls."""

    def __init__(self, now=1000.0):
        import time as _time

        self.now = now
        self.perf_counter = _time.perf_counter

    def monotonic(self):
        return self.now


def test_coverage_gauge_math(audit_on, monkeypatch):
    clock = FrozenClock()
    monkeypatch.setattr(audit, "time", clock)
    datums = datagen.kafka_style_datums(30, seed=8)
    audit.force_next()
    port.deserialize_array(datums, KAFKA, **HOST)
    port.deserialize_array(datums, KAFKA, **HOST)
    aud = telemetry.snapshot()["audit"]
    assert (aud["calls"], aud["audited"]) == (2, 1)
    assert aud["coverage"] == 0.5
    [arm] = aud["per_arm"]
    assert (arm["rows"], arm["audited_rows"]) == (60.0, 30.0)
    assert metrics.gauges()["audit.coverage"] == aud["coverage"]
    # one half-life on, every tally halves and the coverage holds
    clock.now += audit._COVERAGE_HALF_LIFE_S
    [arm] = audit.snapshot_audit()["per_arm"]
    assert (arm["calls"], arm["rows"], arm["audited_rows"]) == \
        (1.0, 30.0, 15.0)
    assert audit.snapshot_audit()["coverage"] == 0.5


def test_period_tracks_the_cost_ratio(audit_on):
    audit.force_next()
    port.deserialize_array(datagen.kafka_style_datums(40, seed=2), KAFKA,
                           **HOST)
    aud = telemetry.snapshot()["audit"]
    assert aud["period"] == max(1, round(aud["cost_ratio"] / aud["budget"]))
    assert aud["cost_ratio"] != audit._ASSUMED_RATIO
    # the same ratio gives the reference's period
    with ref_audit._lock:
        ref_audit._ratio = audit._ratio
        assert ref_audit._period_locked() == audit._period_locked()


DEC = ('{"type":"record","name":"D","fields":[{"name":"d","type":'
       '{"type":"fixed","name":"Fx","size":1,"logicalType":"decimal",'
       '"precision":3,"scale":0}}]}')


def test_encode_skip_reasons_count(audit_on):
    from decimal import Decimal

    arr = pa.array([Decimal(1), Decimal(500), Decimal(7)],
                   type=pa.decimal128(3, 0))
    batch = pa.RecordBatch.from_arrays([arr], names=["d"])
    for mod, kw in ((port, HOST), (ref, {"backend": "host"})):
        (audit if mod is port else ref_audit).force_next()
        mod.serialize_record_batch(batch, DEC, 1, on_error="skip", **kw)
    c, r = metrics.snapshot(), ref_metrics.snapshot()
    assert c["audit.skipped_quarantine"] == r["audit.skipped_quarantine"] \
        == 1
    assert not c.get("audit.audited") and not r.get("audit.audited")
    # a caller-typed batch (created_at nullable where the schema's is not)
    good = port.deserialize_array(datagen.kafka_style_datums(8, seed=1),
                                  KAFKA, **HOST)
    i = good.schema.names.index("created_at")
    typed = pa.RecordBatch.from_arrays(good.columns, schema=good.schema.set(
        i, good.schema.field(i).with_nullable(True)))
    audit.force_next()
    port.serialize_record_batch(typed, KAFKA, 1, **HOST)
    assert metrics.snapshot()["audit.skipped_schema"] == 1


@pytest.mark.parametrize("kind", ["error", "hang"])
def test_the_audit_shadow_seam_counts_as_the_references(kind, audit_on,
                                                         monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", f"audit_shadow:{kind}:1")
    monkeypatch.setenv("PYRUHVRO_TPU_FAULT_HANG_S", "0.01")
    datums = datagen.kafka_style_datums(30, seed=7)
    audit.force_next()
    ref_audit.force_next()
    got = port.deserialize_array(datums, KAFKA, **CPU)
    want = ref.deserialize_array(datums, KAFKA, backend="host")
    assert got.equals(want)
    c, r = metrics.snapshot(), ref_metrics.snapshot()
    for key in ("fault.injected.audit_shadow", "audit.shadow_error",
                "audit.audited", "audit.mismatches"):
        assert c.get(key) == r.get(key), key
    assert c["fault.injected.audit_shadow"] == 1
    assert c.get("audit.shadow_error", 0) == (1 if kind == "error" else 0)
    assert telemetry.snapshot()["audit"]["shadow_errors"] == \
        ref.telemetry.snapshot()["audit"]["shadow_errors"]


# -- the section and its report ----------------------------------------------------


def test_snapshot_section_and_report_are_the_references(audit_on, tmp_path,
                                                        capsys):
    datums = datagen.kafka_style_datums(30, seed=12)
    audit.force_next()
    ref_audit.force_next()
    port.deserialize_array(datums, KAFKA, **HOST)
    ref.deserialize_array(datums, KAFKA, backend="host")
    got = telemetry.snapshot()["audit"]
    want = ref.telemetry.snapshot()["audit"]
    timed = {"cost_ratio", "period", "per_arm", "digests"}
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in timed} == \
        {k: v for k, v in want.items() if k not in timed}
    assert got["digests"] == want["digests"]
    doc = {"audit": got}
    assert audit.render_audit_report(doc) == \
        ref_audit.render_audit_report(doc)
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(telemetry.snapshot(), default=str))
    assert telemetry.main(["audit-report", str(path)]) == 0
    assert "no mismatches observed" in capsys.readouterr().out
    assert telemetry.main(["report", str(path)]) == 0
    assert "== differential audit ==" in capsys.readouterr().out
    assert audit.render_audit_report({}) == ref_audit.render_audit_report({})


def test_audit_report_exit_codes(tmp_path, capsys):
    assert telemetry.main(["audit-report", str(tmp_path / "nope.json")]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert telemetry.main(["audit-report", str(bad)]) == 2
    other = tmp_path / "other.json"
    other.write_text('{"foo": 1}')
    assert telemetry.main(["audit-report", str(other)]) == 2
    listed = tmp_path / "list.json"
    listed.write_text("[1]")
    assert telemetry.main(["audit-report", str(listed)]) == 2
    capsys.readouterr()
    assert os.path.exists(bad)
