"""K2 ``decode_finalize`` on the card: what only a CUDA device can show.

These tests need an NVIDIA card with ``nvcc`` (the kernel builds at first
use) and skip without one. Run them on the card with

    python -m pytest -m device tests/test_torch_finalize_card.py

They import nothing of JAX: the kernel is held against its plain PyTorch
version (``finalize_plain``).
"""

import pytest
import torch

import chip_smoke
from pyruhvro_tpu_torch.ops import decode
from pyruhvro_tpu_torch.schema import parse_schema
from pyruhvro_tpu_torch.utils import datagen

pytestmark = pytest.mark.device


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: decode_finalize has no CPU mode")
    return torch.device("cuda")


def test_finalize_tables_outlive_an_eviction_during_a_run_on_another_stream(
        card):
    """A rung's tables built on one stream, a run on a side stream still in
    flight when the rung is evicted: the table's block is not handed on
    before the run ends, and the run's blob is the plain finalize's."""
    dec = decode.DeviceDecoder(parse_schema(datagen.KAFKA_SCHEMA_JSON),
                               card)
    spin_ms = chip_smoke.hold_finalize_streams(
        torch, decode, dec, datagen.kafka_style_datums(2_000, seed=3),
        "2,000 Kafka records")
    assert spin_ms > 0
