"""The port's deep sampler (``pyruhvro_tpu_torch/runtime/sampling.py``, a
copy of ``pyruhvro_tpu/runtime/sampling.py``) and its two deep paths,
held against the reference on the CPU.

* The period, the overhead estimate, the per-feature EWMAs and the
  corrections that one synthetic call sequence tunes are the
  reference's, on an injected clock (both modules' ``time`` replaced).
* The correction is per arm; the deep flag is per thread; SIGUSR2
  toggles the sampler; a budget of 0 or telemetry off turns it off.
* A deep-sampled ``device="cpu"`` call gives the batches of a plain one
  and marks its deep path as run (``device_obs.sync_mode``, consulted at
  each launch, also on the plain versions); the router ledgers it as
  sampled.
* A deep-sampled ``backend="host"`` call decodes through the profiled
  VM build (``g++`` builds it here) and drains ``vm.op.*`` weighted by
  the period: the hits are the period times those of one profiled pass.

Values are compared exactly, floats by ``==`` where both packages run
the same arithmetic on the same inputs.
"""

import os
import signal
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.runtime import sampling as ref_sampling  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    device_obs,
    metrics,
    native,
    router,
    sampling,
    telemetry,
)
from pyruhvro_tpu_torch.hostpath.program import lower_host  # noqa: E402
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

KAFKA = datagen.KAFKA_SCHEMA_JSON


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in ("PYRUHVRO_TPU_SAMPLE_BUDGET", "PYRUHVRO_TPU_DEVICE_SYNC",
                 "PYRUHVRO_TPU_NATIVE_PROF", "PYRUHVRO_TPU_FAULTS",
                 "PYRUHVRO_TPU_POOL", "PYRUHVRO_TPU_AUTOTUNE",
                 "PYRUHVRO_TPU_NO_NATIVE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_ROUTING_PROFILE", "")
    telemetry.reset()
    ref.telemetry.reset()
    yield
    sampling.set_enabled(None)
    ref_sampling.set_enabled(None)
    telemetry.reset()
    ref.telemetry.reset()


class Clock:
    """An injected ``time`` module: ``perf_counter`` reads ``now``."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now

    def monotonic(self):
        return self.now


def drive(mod, clock, seq):
    """Run ``seq`` of ``(schema, op, rows, arm, normal_s, deep_s)`` calls
    through ``mod.call_scope``; a sampled call runs its deep path and
    takes ``deep_s``. Returns what the module saw, call by call."""
    seen = []
    for schema, op, rows, arm, normal_s, deep_s in seq:
        with mod.call_scope(op, schema, rows) as smp:
            if smp.sampled:
                mod.note_deep_ran()
                mod.note_arm(arm)
                clock.now += deep_s
            else:
                mod.note_arm(arm)
                clock.now += normal_s
        seen.append((smp.sampled, mod.period(),
                     round(mod.overhead_fraction(), 12),
                     mod.consume_last_correction(1.0)))
    return seen


def synthetic_sequence():
    """Two schemas on two arms: the native arm pays about 3x for its deep
    path, the device arm about 1.2x; the rows vary within their bands."""
    seq = []
    for i in range(400):
        if i % 3:
            rows = 1000 + 37 * (i % 11)
            seq.append(("fpA", "decode", rows, "native/c1/shard",
                        rows * 2e-7, rows * 6e-7 + 1e-5 * (i % 5)))
        else:
            rows = 5000 + 101 * (i % 7)
            seq.append(("fpB", "encode", rows, "device/c1/none",
                        rows * 1e-7, rows * 1.2e-7))
    return seq


def test_period_and_budget_tuning_are_the_reference(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0.02")
    got_clock, want_clock = Clock(), Clock()
    monkeypatch.setattr(sampling, "time", got_clock)
    monkeypatch.setattr(ref_sampling, "time", want_clock)
    sampling.set_enabled(True)
    ref_sampling.set_enabled(True)
    seq = synthetic_sequence()
    got = drive(sampling, got_clock, seq)
    want = drive(ref_sampling, want_clock, seq)
    assert got == want
    assert sum(s for s, *_ in got) >= 5
    assert sampling.period() == ref_sampling.period() > sampling._PERIOD_MIN
    assert sampling._feat == ref_sampling._feat
    for feat in list(sampling._feat):
        assert sampling.corrected_seconds(1.0, *feat) == \
            ref_sampling.corrected_seconds(1.0, *feat)
    snap = sampling.snapshot_sampling()
    assert snap == ref_sampling.snapshot_sampling()
    assert snap["deep_calls"] == metrics.snapshot()["sampling.deep_calls"]


def test_a_call_whose_deep_path_did_not_run_rearms(monkeypatch):
    """A sampled call that ran nothing deep counts ``deep_skipped``,
    teaches no EWMA and, with the profiled build loading, re-arms the
    next call, as in the reference."""
    for mod in (sampling, ref_sampling):
        mod.set_enabled(True)
        mod._period = 1
        with mod.call_scope("decode", "fp", 10) as smp:
            assert smp.sampled
        assert not mod._feat
        assert mod.consume_last_correction(2.0) == 2.0
    assert metrics.snapshot()["sampling.deep_skipped"] == 1


def test_the_correction_is_per_arm_as_in_the_reference():
    native_feat = ("fp", "decode", 14, "native/c4/shard")
    device_feat = ("fp", "decode", 14, "device/c1/none")
    for mod in (sampling, ref_sampling):
        mod.reset()
        with mod._lock:
            mod._feat[native_feat] = [1e-6, 4e-6, 8.0, 8.0]
            mod._retune_locked()
        assert mod.overhead_known()
    probes = [native_feat, ("fp", "decode", 14, "native/c8/shard"),
              device_feat]
    got = [sampling.corrected_seconds(4.0, *f) for f in probes]
    assert got == [ref_sampling.corrected_seconds(4.0, *f) for f in probes]
    assert got == pytest.approx([1.0, 1.0, 4.0])
    for mod in (sampling, ref_sampling):
        with mod._lock:
            mod._feat[device_feat] = [1e-6, 1.1e-6, 4.0, 4.0]
    assert sampling.corrected_seconds(4.0, *device_feat) == \
        ref_sampling.corrected_seconds(4.0, *device_feat) == \
        pytest.approx(4.0 / 1.1)


def test_the_deep_flag_is_per_thread():
    sampling.set_enabled(True)
    sampling._period = 1
    with sampling.call_scope("decode", "fp", 10) as smp:
        assert smp.sampled and sampling.deep_active()
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            (sampling.deep_active(), device_obs.sync_mode())))
        t.start()
        t.join()
        assert seen == [(False, False)]
        assert device_obs.sync_mode() and sampling.deep_ran()
    assert not sampling.deep_active() and not device_obs.sync_mode()


def test_sync_mode_knob(monkeypatch):
    """``PYRUHVRO_TPU_DEVICE_SYNC=1`` bounds every launch, ``0`` none,
    unset only a deep-sampled call's ((c) 8)."""
    assert device_obs.sync_mode() is False
    monkeypatch.setenv("PYRUHVRO_TPU_DEVICE_SYNC", "1")
    assert device_obs.sync_mode() is True
    sampling.set_enabled(True)
    sampling._period = 1
    monkeypatch.setenv("PYRUHVRO_TPU_DEVICE_SYNC", "0")
    with sampling.call_scope("decode", "fp", 10):
        assert device_obs.sync_mode() is False
        assert not sampling.deep_ran()


@pytest.mark.skipif(not hasattr(signal, "SIGUSR2"), reason="no SIGUSR2")
def test_sigusr2_toggles_the_sampler():
    assert sampling.install_toggle_signal()
    before = sampling.enabled()
    os.kill(os.getpid(), signal.SIGUSR2)
    time.sleep(0.05)
    assert sampling.enabled() == (not before)
    os.kill(os.getpid(), signal.SIGUSR2)
    time.sleep(0.05)
    assert sampling.enabled() == before
    sampling.snapshot_sampling()  # flushes the count the handler deferred
    assert metrics.snapshot()["sampling.toggled"] == 2


def test_disabled_states(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")
    assert not sampling.enabled()
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0.02")
    assert sampling.enabled() and sampling.budget() == 0.02
    telemetry.set_enabled(False)
    try:
        assert not sampling.enabled()
    finally:
        telemetry.set_enabled(True)
    sampling.set_enabled(False)
    port.deserialize_array(datagen.kafka_style_datums(10, seed=9), KAFKA,
                           backend="host")
    assert "sampling.calls" not in metrics.snapshot()
    assert telemetry.snapshot()["sampling"]["enabled"] is False


# -- the deep paths through the public calls ---------------------------------


def test_a_deep_device_call_gives_the_plain_batches():
    data = datagen.kafka_style_datums(300, seed=13)
    sampling.set_enabled(False)
    plain = port.deserialize_array_threaded(data, KAFKA, 3, device="cpu")
    batch = port.deserialize_array(data, KAFKA, device="cpu")
    sampling.set_enabled(True)
    sampling._period = 1  # this call samples
    deep = port.deserialize_array_threaded(data, KAFKA, 3, device="cpu")
    assert [b.to_pylist() for b in deep] == [b.to_pylist() for b in plain]
    c = metrics.snapshot()
    assert c["sampling.deep_calls"] == 1 and "sampling.deep_skipped" not in c
    entry = router.last_entry()
    assert entry["sampled"] and entry["tier"] == "device"
    assert telemetry.snapshot()["spans"][-1]["attrs"]["deep_sample"] is True
    sampling._period = 1
    arrays = port.serialize_record_batch(batch, KAFKA, 2, device="cpu")
    assert [d for a in arrays for d in a.to_pylist()] == data
    assert metrics.snapshot()["sampling.deep_calls"] == 2
    snap = telemetry.snapshot()
    assert snap["sampling"]["deep_calls"] == 2
    assert "== adaptive deep sampling ==" in telemetry.render_report(snap)


def prof_module():
    sampling.prof_codec_module()
    if sampling._prof_thread is not None:
        sampling._prof_thread.join(timeout=300)
    return sampling.prof_codec_module()


def test_a_deep_host_call_drains_vm_ops_by_the_period():
    mod = prof_module()
    assert mod is not None and hasattr(mod, "prof_drain")
    data = datagen.kafka_style_datums(200, seed=17)
    prog = lower_host(get_or_parse_schema(KAFKA).ir)
    mod.prof_drain()
    mod.decode_arrow(prog.ops, prog.coltypes, prog.op_aux, data, 1)
    once = {k: v for k, v in mod.prof_drain().items() if v[0]}
    assert any(k.startswith("vm.op.") for k in once)
    want = port.deserialize_array(data, KAFKA, backend="host")
    metrics.reset()
    sampling.set_enabled(True)
    sampling._period = 8
    # count from 0 (the call above counted one), so that the deep call is
    # the loop's last: a period retuned after it cannot sample again here
    sampling._calls = 0
    for i in range(8):  # the 8th call samples, with weight 8
        got = port.deserialize_array(data, KAFKA, backend="host")
        assert got.to_pylist() == want.to_pylist()
    c = metrics.snapshot()
    assert c["sampling.deep_calls"] == 1
    for key, (hits, _ns) in once.items():
        assert c[key] == 8.0 * hits, key
    assert any(k.startswith("vm.op.") and k.endswith("_s") for k in c)
    report = telemetry.render_report(telemetry.snapshot())
    assert "== native profiler (per-opcode self time) ==" in report
    assert "vm.op.* (" in report


def test_the_prof_knob_drains_every_host_call(monkeypatch):
    """``PYRUHVRO_TPU_NATIVE_PROF=1``: the host modules are their
    profiled builds, and every decode and encode drains."""
    monkeypatch.setenv("PYRUHVRO_TPU_NATIVE_PROF", "1")
    schema = KAFKA.replace('"name"', '"doc":"prof-knob","name"', 1)
    data = datagen.kafka_style_datums(100, seed=19)
    batch = port.deserialize_array(data, schema, backend="host")
    arrays = port.serialize_record_batch(batch, schema, 1, backend="host")
    assert arrays[0].to_pylist() == data
    assert native.loaded("host_codec", True)
    c = metrics.snapshot()
    assert any(k.startswith("vm.op.") for k in c)
    assert any(k.startswith(("extract.op.", "vm.encop.")) for k in c)


class _Event:
    """A CUDA event stand-in that counts the host's waits on it."""

    def __init__(self):
        self.cuda_event = 1
        self.waits = 0

    def record(self, stream=None):
        pass

    def query(self):
        return True

    def synchronize(self):
        self.waits += 1

    def elapsed_time(self, other):
        return 0.25


def test_sync_mode_waits_on_each_launch_end(monkeypatch):
    """On the card a launch is waited on at its end event only in sync
    mode: never on a plain call, once per launch call in a deep-sampled
    one (the end event, not the start)."""
    made = []

    def acquire(key, stream):
        made.append(_Event())
        return made[-1]

    class Stream:
        cuda_stream = 7

    monkeypatch.setattr(device_obs, "_acquire", acquire)
    monkeypatch.setattr(device_obs, "_pools", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream)
    card = torch.device("cuda", 0)

    def one_launch(calls):
        with device_obs.launch("decode.pipeline", "R8", "fp", first=False):
            for _ in range(calls):
                with device_obs.timed("walk", card):
                    pass
        device_obs.flush()

    one_launch(3)
    assert [e.waits for e in made] == [0] * 6
    made.clear()
    sampling.set_enabled(True)
    sampling._period = 1
    with sampling.call_scope("decode", "fp", 10) as smp:
        assert smp.sampled
        one_launch(3)
        assert sampling.deep_ran()
    assert [e.waits for e in made] == [0, 1] * 3
