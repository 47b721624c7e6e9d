"""The pure helpers of ``scripts/kernels_vs_parent.py`` (the comparison of
the port's kernels with another checkout's, which runs on the card only):
``compare`` holds the DPT and B6 outputs bit for bit and reports the TCN
block kernels by distance, at their bars; ``summarize`` lays the timed
turns out per metric and tree. On the CPU, with small tensors."""

import importlib.util
from pathlib import Path

import pytest
import torch

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "kernels_vs_parent.py"
_spec = importlib.util.spec_from_file_location("kernels_vs_parent", _PATH)
kvp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kvp)


def _outs(seed, twin=1e-3):
    g = torch.Generator().manual_seed(seed)
    out = {"dpt ffn bfloat16 S=128 heads=8 forward": torch.randn(4, 8, generator=g),
           "b6 float32 Hs=256 d=1 z": torch.randn(3, 5, generator=g),
           "b1 bfloat16 gLN causal=0 d=1": torch.randn(6, 7, generator=g),
           "b2 float32 gLN causal=0 d=16 dx": torch.randn(6, 7, generator=g)}
    out["twin b1 bfloat16 gLN causal=0 d=1"] = twin
    out["twin b2 float32 gLN causal=0 d=16 dx"] = twin
    return out


def test_compare_same_trees_has_no_fault():
    mine, other = _outs(0), _outs(0)
    lines, bad = kvp.compare(mine, other)
    assert bad == []
    assert sum("same bits" in line for line in lines) == 2
    assert any("trees apart rel_l2 0.000e+00" in line for line in lines)


@pytest.mark.parametrize("key", ["dpt ffn bfloat16 S=128 heads=8 forward",
                                 "b6 float32 Hs=256 d=1 z"])
def test_compare_flags_a_bit_difference(key):
    mine, other = _outs(0), _outs(0)
    mine[key] = mine[key].clone()
    mine[key][0, 0] += 1e-6
    lines, bad = kvp.compare(mine, other)
    assert bad == [key]
    assert any(line.startswith(key) and "DIFFERENT" in line for line in lines)


def test_compare_holds_the_tcn_kernels_at_their_bars():
    """A TCN output may differ from the other tree's (a redesign moves the
    bits); it is at fault only when its own distance from its twin passes
    the bar: 4e-2 for the bf16 forward, 4e-3 for the f32 backward."""
    other = _outs(0)
    mine = _outs(0, twin=3.9e-2)
    for key in ("b1 bfloat16 gLN causal=0 d=1",
                "b2 float32 gLN causal=0 d=16 dx"):
        mine[key] = mine[key] * 1.01
    lines, bad = kvp.compare(mine, other)
    assert any("trees apart rel_l2 1.000e-02" in line for line in lines)
    assert bad == ["b2 float32 gLN causal=0 d=16 dx"]
    mine["twin b2 float32 gLN causal=0 d=16 dx"] = 3.9e-3
    assert kvp.compare(mine, other)[1] == []
    mine["twin b1 bfloat16 gLN causal=0 d=1"] = 4.1e-2
    assert kvp.compare(mine, other)[1] == ["b1 bfloat16 gLN causal=0 d=1"]


def test_compare_flags_a_missing_output():
    mine, other = _outs(0), _outs(0)
    del mine["b6 float32 Hs=256 d=1 z"]
    assert kvp.compare(mine, other)[1] == ["b6 float32 Hs=256 d=1 z"]


def test_summarize_turns():
    turns = [("other", {"b1 gLN d=1": 0.4, "b1 gLN d=2": 0.5, "step": 50.0}),
             ("this", {"b1 gLN d=1": 0.1, "b1 gLN d=2": 0.2, "step": 40.0}),
             ("this", {"b1 gLN d=1": 0.1, "b1 gLN d=2": 0.2, "step": 42.0}),
             ("other", {"b1 gLN d=1": 0.4, "b1 gLN d=2": 0.5, "step": 52.0})]
    lines = kvp.summarize(turns)
    step = next(line for line in lines if line.startswith("step:"))
    assert "other 50.0000 52.0000 | this 40.0000 42.0000 ms" in step
    assert "means 51.0000 -> 41.0000 (x0.804)" in step
    assert "b1 gLN mean over d, other: 0.4500 ms" in lines
    assert "b1 gLN mean over d, this: 0.1500 ms" in lines
