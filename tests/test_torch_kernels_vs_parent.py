"""The pure helpers of ``scripts/kernels_vs_parent.py`` (the comparison of
the port's kernels with another checkout's, which runs on the card only):
``compare`` holds the DPT, B6 and TCN block (B1-B3) outputs bit for bit
and reports the block pair kernels (B4, B5) by distance, at their bars;
``summarize`` lays the timed turns out per metric and tree. On the CPU,
with small tensors."""

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
           "b2 float32 gLN causal=0 d=16 dx": torch.randn(6, 7, generator=g),
           "b4 bfloat16 gLN causal=0 d=(1,2)": torch.randn(6, 7, generator=g),
           "b5 float32 gLN causal=0 d=(16,32) dx": torch.randn(
               6, 7, generator=g)}
    for key in ("b1 bfloat16 gLN causal=0 d=1",
                "b2 float32 gLN causal=0 d=16 dx",
                "b4 bfloat16 gLN causal=0 d=(1,2)",
                "b5 float32 gLN causal=0 d=(16,32) dx"):
        out[f"twin {key}"] = twin
    return out


def test_compare_same_trees_has_no_fault():
    mine, other = _outs(0), _outs(0)
    lines, bad = kvp.compare(mine, other)
    assert bad == []
    assert sum("same bits" in line for line in lines) == 4
    assert sum("trees apart rel_l2 0.000e+00" in line for line in lines) == 2
    # every output with a twin prints both trees' distances from it
    assert sum("from the twin this tree 1.000e-03, other 1.000e-03"
               in line for line in lines) == 4


@pytest.mark.parametrize("key", ["dpt ffn bfloat16 S=128 heads=8 forward",
                                 "b6 float32 Hs=256 d=1 z",
                                 "b1 bfloat16 gLN causal=0 d=1",
                                 "b2 float32 gLN causal=0 d=16 dx"])
def test_compare_flags_a_bit_difference(key):
    mine, other = _outs(0), _outs(0)
    mine[key] = mine[key].clone()
    mine[key][0, 0] += 1e-6
    lines, bad = kvp.compare(mine, other)
    assert bad == [key]
    assert any(line.startswith(key) and "DIFFERENT" in line for line in lines)


def test_compare_holds_the_tcn_kernels_at_their_bars():
    """A pair kernel's output may differ from the other tree's (a redesign
    moves the bits); it is at fault only when its own distance from its
    twin passes the bar: 6e-2 for the bf16 pair forward, 4e-3 for the f32
    pair backward. The block kernels (B1-B3) are held bit for bit whatever
    their twin distance."""
    other = _outs(0)
    mine = _outs(0, twin=3.9e-2)
    for key in ("b4 bfloat16 gLN causal=0 d=(1,2)",
                "b5 float32 gLN causal=0 d=(16,32) dx"):
        mine[key] = mine[key] * 1.01
    lines, bad = kvp.compare(mine, other)
    assert sum("trees apart rel_l2 1.000e-02" in line for line in lines) == 2
    assert bad == ["b5 float32 gLN causal=0 d=(16,32) dx"]
    mine["twin b5 float32 gLN causal=0 d=(16,32) dx"] = 3.9e-3
    assert kvp.compare(mine, other)[1] == []
    mine["twin b4 bfloat16 gLN causal=0 d=(1,2)"] = 6.1e-2
    assert kvp.compare(mine, other)[1] == ["b4 bfloat16 gLN causal=0 d=(1,2)"]
    assert kvp._tcn_tol("b1 bfloat16 gLN causal=0 d=1") == 4e-2
    assert kvp._tcn_tol("b3 float32 cLN causal=1 d=1 dx") == 4e-3


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


def test_summarize_pairs_and_peak_memory():
    """The pair timings are averaged over the pairs of dilations beside the
    chained singles of the same turns, and a peak-memory metric is laid
    out in GiB."""
    this = {"b4 gLN d=(1,2)": 0.30, "b4 gLN d=(4,8)": 0.34,
            "2 x b1 gLN d=(1,2)": 0.31, "2 x b1 gLN d=(4,8)": 0.33,
            "b5 gLN d=(1,2)": 1.0, "b1 + 2 x b2 gLN d=(1,2)": 1.1,
            "peak GiB train step gLN B=8 x 4 s pairs on": 0.7}
    other = {"b4 gLN d=(1,2)": 1.0, "b4 gLN d=(4,8)": 1.0,
             "2 x b1 gLN d=(1,2)": 0.31, "2 x b1 gLN d=(4,8)": 0.33,
             "b5 gLN d=(1,2)": 3.0, "b1 + 2 x b2 gLN d=(1,2)": 1.1,
             "peak GiB train step gLN B=8 x 4 s pairs on": 0.67}
    lines = kvp.summarize([("other", other), ("this", this), ("this", this),
                           ("other", other)])
    assert "b4 gLN mean over pairs, other: 1.0000 ms" in lines
    assert "b4 gLN mean over pairs, this: 0.3200 ms" in lines
    assert "2 x b1 gLN mean over pairs, this: 0.3200 ms" in lines
    assert "b5 gLN mean over pairs, this: 1.0000 ms" in lines
    assert "b1 + 2 x b2 gLN mean over pairs, other: 1.1000 ms" in lines
    peak = next(line for line in lines if line.startswith("peak GiB"))
    assert "| this 0.7000 0.7000 GiB; means 0.6700 -> 0.7000" in peak
    assert kvp.PAIRS == [(1, 2), (4, 8), (16, 32), (64, 128)]


def test_summarize_pairs_of_the_first_design():
    """The f32 and H=192 pair timings (the first design's launches) are
    averaged over the pairs of dilations under their own names, beside
    the bf16 paper-width ones."""
    this = {"b4 gLN f32 d=(1,2)": 2.0, "b4 gLN f32 d=(4,8)": 2.2,
            "b5 gLN f32 d=(1,2)": 8.0, "b1 + 2 x b2 gLN f32 d=(1,2)": 7.9,
            "b4 gLN H=192 d=(1,2)": 0.5, "2 x b1 gLN H=192 d=(1,2)": 0.5,
            "b4 gLN d=(1,2)": 0.31}
    other = {"b4 gLN f32 d=(1,2)": 2.4, "b4 gLN f32 d=(4,8)": 2.4,
             "b5 gLN f32 d=(1,2)": 7.0, "b1 + 2 x b2 gLN f32 d=(1,2)": 7.9,
             "b4 gLN H=192 d=(1,2)": 0.6, "2 x b1 gLN H=192 d=(1,2)": 0.5,
             "b4 gLN d=(1,2)": 1.0}
    lines = kvp.summarize([("other", other), ("this", this), ("this", this),
                           ("other", other)])
    assert "b4 gLN f32 mean over pairs, this: 2.1000 ms" in lines
    assert "b4 gLN f32 mean over pairs, other: 2.4000 ms" in lines
    assert "b5 gLN f32 mean over pairs, other: 7.0000 ms" in lines
    assert "b1 + 2 x b2 gLN f32 mean over pairs, this: 7.9000 ms" in lines
    assert "b4 gLN H=192 mean over pairs, other: 0.6000 ms" in lines
    assert "2 x b1 gLN H=192 mean over pairs, this: 0.5000 ms" in lines
    # the bf16 paper-width mean takes none of the other widths' numbers
    assert "b4 gLN mean over pairs, this: 0.3100 ms" in lines
    row = next(line for line in lines if line.startswith("b4 gLN f32 d=(1,2)"))
    assert row.endswith("means 2.4000 -> 2.0000 (x0.833)")
