"""Malformed-input fuzz of the port's decodes against the reference's, on
the CPU.

The reference's random schemas, random records and corpus mutations
(``pyruhvro_tpu.utils.datagen.random_schema`` / ``random_datums`` and
``tests/test_fuzz_malformed.py``'s ``mutate_corpus``: truncations, bit
flips, splices) on ten seeds whose schema has a uuid column, so that
flipped bits leave uuid text that is valid on the wire but is not a
UUID. Each corpus goes through the port's ``device="cpu"`` (the kernels'
plain versions) against the reference's ``backend="tpu"`` (its device
tier on JAX's CPU), and through the port's ``backend="host"`` against
the reference's, under ``on_error="raise"`` and ``"skip"``. Under
``"skip"`` the batches' values and each quarantine entry's index, datum,
slug and tier must be equal; under ``"raise"`` the error's type name,
message and index. Decode is integer and byte work: the tolerance is 0.

The seeds are the cheap ones of their kind for the reference's XLA
compiles (a few seconds each), so the file runs in about a minute.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu.utils.datagen import random_datums, random_schema  # noqa: E402
from test_fuzz_malformed import mutate_corpus  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402

SEEDS = (18, 22, 47, 59, 70, 76, 111, 150, 186, 198)
ROWS = 40
TIERS = {"device": ({"device": "cpu"}, {"backend": "tpu"}),
         "host": ({"backend": "host"}, {"backend": "host"})}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Chunks of 64 rows on both sides, the native host tiers on, one
    torch thread (parallel test workers share the CPU)."""
    monkeypatch.setenv("PYRUHVRO_TPU_OVERLAP_ROWS", "64")
    for name in ("PYRUHVRO_TPU_OVERLAP", "PYRUHVRO_TPU_PALLAS",
                 "PYRUHVRO_TPU_NO_NATIVE", "PYRUHVRO_TPU_MAX_DATUM_BYTES",
                 "PYRUHVRO_TPU_DEADLINE_S"):
        monkeypatch.delenv(name, raising=False)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def corpus(seed):
    schema = random_schema(seed)
    ir = get_or_parse_schema(schema).ir
    return schema, mutate_corpus(random_datums(ir, ROWS, seed=seed + 5000),
                                 seed)


def outcome(call):
    """What one decode gave: the batch's rows and the quarantine entries,
    or the error's type name, message and index."""
    try:
        batch, errs = call()
    except (ValueError, OverflowError) as e:  # MalformedAvro included
        return ("raised", type(e).__name__, str(e), getattr(e, "index", None))
    return ("batch", batch.schema.to_string(), batch.to_pylist(),
            [(q.index, q.datum, q.error, q.tier) for q in errs])


def test_the_seeds_have_a_uuid_column():
    for seed in SEEDS:
        assert '"uuid"' in random_schema(seed), seed


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("seed", SEEDS)
def test_mutated_corpus_matches_the_reference(seed, tier):
    schema, data = corpus(seed)
    ours, theirs = TIERS[tier]
    seen = {}
    for policy in ("raise", "skip"):
        kw = {"on_error": policy, "return_errors": True}
        got = outcome(lambda: port.deserialize_array(data, schema, **ours,
                                                     **kw))
        want = outcome(lambda: ref.deserialize_array(data, schema, **theirs,
                                                     **kw))
        assert got == want, (seed, tier, policy)
        seen[policy] = got
    # the corpus is poisoned: "raise" raises and "skip" quarantines
    assert seen["raise"][0] == "raised"
    assert seen["skip"][0] == "batch" and seen["skip"][3]
