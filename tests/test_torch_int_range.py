"""An Avro ``int`` whose varint lies past int32 is rejected by every tier
of the port, on the CPU.

The Avro spec makes ``int`` a 32-bit signed integer, and apache-avro's
``zag_i32`` rejects a wider varint. The port's oracle
(``fallback/io.py`` ``read_int``), the kernels' plain versions (K1 and
K4: ``ERR_INT_RANGE`` in ``#err``), the native VM and the specialised
engine (``Reader::read_int``) all reject such a record, for ``int``,
``date`` and ``time-millis`` alike, at the top level and under arrays,
maps and unions, each with the slug ``int_range`` (the VM's as
:func:`slug` says). The JAX package's oracle
rejects the same records (when it builds the Arrow column); the bounds
of int32 themselves decode on every tier. Decode is integer work: the
tolerance is 0.
"""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch import MalformedAvro  # noqa: E402
from pyruhvro_tpu_torch.fallback.decoder import (  # noqa: E402
    decode_to_record_batch,
)
from pyruhvro_tpu_torch.fallback.io import read_int  # noqa: E402
from pyruhvro_tpu_torch.hostpath.codec import NativeHostCodec  # noqa: E402
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402

# the fixture the card holds K1, K2 and K4 against their plain versions on
_name, SCHEMA, CORPUS, _bad = chip_smoke.int_range_fixture()
FIELDS = chip_smoke.INT_RANGE_FIELDS
INSIDE, OUTSIDE = chip_smoke.INT32_BOUNDS, chip_smoke.PAST_INT32
BAD = list(range(1 + len(FIELDS) * len(INSIDE), len(CORPUS)))
lng = chip_smoke.zz
TIERS = {"plain_k1_k2": ({"device": "cpu"}, {}),
         "plain_k4": ({"device": "cpu"}, {"PYRUHVRO_TPU_PALLAS": "1"}),
         "vm": ({"backend": "host"}, {}),
         "oracle": ({"backend": "host"}, {"PYRUHVRO_TPU_NO_NATIVE": "1"})}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in ("PYRUHVRO_TPU_PALLAS", "PYRUHVRO_TPU_NO_NATIVE",
                 "PYRUHVRO_TPU_OVERLAP", "PYRUHVRO_TPU_SPECIALIZE_ROWS",
                 "PYRUHVRO_TPU_NO_SPECIALIZE"):
        monkeypatch.delenv(name, raising=False)


def test_read_int_takes_int32_and_rejects_past_it():
    for v in INSIDE:
        assert read_int(lng(v), 0) == (v, len(lng(v)))
    for v in OUTSIDE:
        with pytest.raises(MalformedAvro) as ei:
            read_int(lng(v), 0)
        assert ei.value.err_name == "int_range"


def test_the_oracle_rejects_each_record_past_int32():
    e = get_or_parse_schema(SCHEMA)
    good = decode_to_record_batch(CORPUS[:BAD[0]], e.ir, e.arrow_schema)
    assert good.column("i").to_pylist()[1:len(INSIDE) + 1] == list(INSIDE)
    assert len(BAD) == len(FIELDS) * len(OUTSIDE) == len(CORPUS) - BAD[0]
    for j in BAD:
        with pytest.raises(MalformedAvro) as ei:
            decode_to_record_batch([CORPUS[j]], e.ir, e.arrow_schema)
        assert ei.value.err_name == "int_range", j


def test_the_reference_oracle_rejects_the_same_records():
    """The JAX package's oracle rejects these records too (in its Arrow
    build), so every tier of the port now agrees with both oracles."""
    pytest.importorskip("jax")
    from pyruhvro_tpu.fallback.decoder import (
        decode_to_record_batch as ref_decode,
    )
    from pyruhvro_tpu.schema.cache import get_or_parse_schema as ref_parse

    r = ref_parse(SCHEMA)
    ref_decode(CORPUS[:BAD[0]], r.ir, r.arrow_schema)
    for j in BAD:
        with pytest.raises((ValueError, OverflowError)):
            ref_decode([CORPUS[j]], r.ir, r.arrow_schema)


def slug(tier: str, j: int) -> str:
    """The slug a tier names for record ``j`` of ``BAD`` (one field past
    int32, in the order of ``FIELDS``, ``len(OUTSIDE)`` records each). The VM stops
    reading a record's array and map blocks at its first error, so a bad
    int ahead of them leaves the rest misread and the lowest error bit
    (a union branch) names it, as for every other error of the VM."""
    field = FIELDS[(j - BAD[0]) // len(OUTSIDE)]
    return ("bad_branch" if tier == "vm" and field in ("i", "d", "t")
            else "int_range")


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_every_tier_rejects_an_int_past_int32(tier, monkeypatch):
    kw, env = TIERS[tier]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    e = get_or_parse_schema(SCHEMA)
    want = decode_to_record_batch(CORPUS[:BAD[0]], e.ir, e.arrow_schema)
    assert port.deserialize_array(CORPUS[:BAD[0]], SCHEMA, **kw).equals(want)
    for j in BAD:
        with pytest.raises(MalformedAvro) as ei:
            port.deserialize_array(CORPUS[:BAD[0]] + [CORPUS[j]], SCHEMA,
                                   **kw)
        assert (ei.value.index, ei.value.err_name) == \
            (BAD[0], slug(tier, j)), (tier, j)
    batch, quar = port.deserialize_array(CORPUS, SCHEMA, on_error="skip",
                                         return_errors=True, **kw)
    assert [(q.index, q.error) for q in quar] == \
        [(j, slug(tier, j)) for j in BAD]
    assert batch.equals(want)


def test_the_specialised_engine_rejects_an_int_past_int32(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SPECIALIZE_ROWS", "0")
    e = get_or_parse_schema(SCHEMA)
    codec = NativeHostCodec(e.ir, e.arrow_schema)
    codec._maybe_specialize(1)
    if codec._spec is None:
        pytest.skip("specializer unavailable (no g++)")
    want = decode_to_record_batch(CORPUS[:BAD[0]], e.ir, e.arrow_schema)
    assert codec.decode(CORPUS[:BAD[0]]).equals(want)
    for j in BAD:
        with pytest.raises(MalformedAvro) as ei:
            codec.decode([CORPUS[j]])
        assert ei.value.err_name == slug("vm", j), j
