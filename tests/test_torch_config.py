"""The port's GptNeoXConfig against the JAX one: the ``num_heads`` and
``head_dim`` properties and the ``pythia_1_4b`` preset (ROADMAP queue 1,
item 4)."""
import dataclasses

import pytest

from fastertransformer4codefuse_tpu.core.config import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu_torch.core.config import GptNeoXConfig


@pytest.mark.parametrize("preset", ["pythia_1_4b", "codefuse_13b", "tiny"])
def test_presets_and_properties_equal_the_jax_config(preset):
    ours, theirs = getattr(GptNeoXConfig, preset)(), getattr(JaxConfig, preset)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("num_heads", "head_dim", "hidden_size", "kv_heads", "qkv_cols"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop
