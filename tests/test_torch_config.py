"""The port's configuration dataclasses against the JAX package's: the same
dicts, so packages and ``config.json`` round-trip between the two."""

import dataclasses

import pytest

from convtasnet_tpu import config as jconfig
from convtasnet_tpu_torch import config as pconfig


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(separator="dpt", compute_dtype="bfloat16", dpt_heads=4,
         dpt_chunk=64, use_pallas=True),
], ids=["defaults", "dpt"])
def test_model_config_matches_jax(overrides):
    got = pconfig.ConvTasNetConfig(**overrides)
    want = jconfig.ConvTasNetConfig(**overrides)
    assert got.to_dict() == want.to_dict()
    assert (got.stride, got.dpt_num_heads, got.receptive_field()) == \
        (want.stride, want.dpt_num_heads, want.receptive_field())
    assert pconfig.ConvTasNetConfig.from_dict(want.to_dict()) == got
    assert jconfig.ConvTasNetConfig.from_dict(got.to_dict()) == want


def test_every_dataclass_and_exp_name_match_jax():
    for name in ("DataConfig", "SolverConfig", "MeshConfig"):
        got, want = getattr(pconfig, name)(), getattr(jconfig, name)()
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)], name
        assert got.to_dict() == want.to_dict(), name
    cfg = jconfig.TrainConfig(
        model=jconfig.ConvTasNetConfig(separator="dpt"),
        solver=jconfig.SolverConfig(lr=3e-4, epochs=2))
    mine = pconfig.TrainConfig.from_json(cfg.to_json())
    assert mine.to_dict() == cfg.to_dict()
    assert pconfig.exp_name(mine) == jconfig.exp_name(cfg)
