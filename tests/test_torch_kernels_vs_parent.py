"""The pure helpers of ``scripts/kernels_vs_parent.py`` (the comparison of
the port's kernels with another checkout's, which runs on the card only):
``compare`` holds every output bit for bit but the bf16 forward of B7 (and
its partial mode) and the f32 outputs of B1-B6 (their 3xTF32 stages),
which it reports by distance, at their twins' bars; ``summarize``
lays the timed turns out per metric and tree.
On the CPU, with small tensors."""

import importlib.util
from pathlib import Path

import pytest
import torch

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "kernels_vs_parent.py"
_spec = importlib.util.spec_from_file_location("kernels_vs_parent", _PATH)
kvp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kvp)


INTER_FWD = "dpt inter bfloat16 S=128 heads=8 forward"


def _outs(seed, twin=1e-3, fwd_twin=5e-4):
    g = torch.Generator().manual_seed(seed)
    out = {"dpt ffn bfloat16 S=128 heads=8 forward": torch.randn(
               4, 8, generator=g),
           INTER_FWD: torch.randn(4, 8, generator=g),
           "b6 float32 Hs=256 d=1 z": torch.randn(3, 5, generator=g),
           "b6 bfloat16 Hs=256 d=1 z": torch.randn(3, 5, generator=g),
           "b1 bfloat16 gLN causal=0 d=1": torch.randn(6, 7, generator=g),
           "b2 float32 gLN causal=0 d=16 dx": torch.randn(6, 7, generator=g),
           "b3 bfloat16 cLN causal=1 d=16 dx": torch.randn(6, 7, generator=g),
           "b4 bfloat16 gLN causal=0 d=(1,2)": torch.randn(6, 7, generator=g),
           "b5 float32 gLN causal=0 d=(16,32) dx": torch.randn(
               6, 7, generator=g)}
    for key in ("b1 bfloat16 gLN causal=0 d=1",
                "b2 float32 gLN causal=0 d=16 dx",
                "b3 bfloat16 cLN causal=1 d=16 dx",
                "b4 bfloat16 gLN causal=0 d=(1,2)",
                "b5 float32 gLN causal=0 d=(16,32) dx"):
        out[f"twin {key}"] = twin
    out["twin b6 float32 Hs=256 d=1 z"] = 4e-7  # at its rounding points
    out[f"twin {INTER_FWD}"] = fwd_twin          # at its rounding points
    out[f"bf16 twin {INTER_FWD}"] = 10 * fwd_twin
    return out


def test_compare_same_trees_has_no_fault():
    mine, other = _outs(0), _outs(0)
    lines, bad = kvp.compare(mine, other)
    assert bad == []
    assert sum("same bits" in line for line in lines) == 5
    assert sum("trees apart rel_l2 0.000e+00" in line for line in lines) == 4
    # every output with a twin prints both trees' distances from it
    assert sum("from the twin this tree 1.000e-03, other 1.000e-03"
               in line for line in lines) == 5
    inter = next(line for line in lines if line.startswith(INTER_FWD))
    assert ("from the twin this tree 5.000e-04, other 5.000e-04 (bar 1e-03)"
            in inter and "from the bf16 twin this tree 5.000e-03, other "
            "5.000e-03 (bar 4e-02)" in inter)


@pytest.mark.parametrize("key", ["dpt ffn bfloat16 S=128 heads=8 forward",
                                 "b6 bfloat16 Hs=256 d=1 z",
                                 "b1 bfloat16 gLN causal=0 d=1",
                                 "b3 bfloat16 cLN causal=1 d=16 dx"])
def test_compare_flags_a_bit_difference(key):
    mine, other = _outs(0), _outs(0)
    mine[key] = mine[key].clone()
    mine[key][0, 0] += 1e-6
    lines, bad = kvp.compare(mine, other)
    assert bad == [key]
    assert any(line.startswith(key) and "DIFFERENT" in line for line in lines)


def test_compare_holds_the_tcn_kernels_at_their_bars():
    """The TCN kernels in bf16, blocks and pairs alike, are held bit for
    bit whatever their twin distance; the outputs held by distance (the
    bf16 B7 forward, and f32 B1-B6 on their 3xTF32 stages) may differ from
    the other tree's and are at fault only when a distance from a twin
    passes its bar: 1e-3 at the kernel's rounding points (f32 B6's 1e-5),
    4e-2 from the bf16 twin, 4e-3 for an f32 backward, or when this tree
    has no twin to hold them."""
    other = _outs(0)
    mine = _outs(0, twin=3.9e-3)
    for key in ("b4 bfloat16 gLN causal=0 d=(1,2)",
                "b5 float32 gLN causal=0 d=(16,32) dx", INTER_FWD):
        mine[key] = mine[key] * 1.01
    lines, bad = kvp.compare(mine, other)
    assert sum("trees apart rel_l2 1.000e-02" in line for line in lines) == 2
    assert bad == ["b4 bfloat16 gLN causal=0 d=(1,2)"]
    mine["b4 bfloat16 gLN causal=0 d=(1,2)"] = other[
        "b4 bfloat16 gLN causal=0 d=(1,2)"]
    assert kvp.compare(mine, other)[1] == []
    mine["twin b5 float32 gLN causal=0 d=(16,32) dx"] = 4.1e-3
    assert kvp.compare(mine, other)[1] == [
        "b5 float32 gLN causal=0 d=(16,32) dx"]
    del mine["twin b5 float32 gLN causal=0 d=(16,32) dx"]
    assert kvp.compare(mine, other)[1] == [
        "b5 float32 gLN causal=0 d=(16,32) dx"]
    mine["twin b5 float32 gLN causal=0 d=(16,32) dx"] = 1e-3
    mine[f"twin {INTER_FWD}"] = 1.1e-3
    assert kvp.compare(mine, other)[1] == [INTER_FWD]
    mine[f"twin {INTER_FWD}"] = 9e-4
    mine[f"bf16 twin {INTER_FWD}"] = 4.1e-2
    assert kvp.compare(mine, other)[1] == [INTER_FWD]
    del mine[f"twin {INTER_FWD}"]
    mine[f"bf16 twin {INTER_FWD}"] = 1e-3
    assert kvp.compare(mine, other)[1] == [INTER_FWD]
    mine[f"bf16 twin {INTER_FWD}"] = 5e-3
    mine[f"twin {INTER_FWD}"] = 5e-4
    mine["b6 float32 Hs=256 d=1 z"] = mine["b6 float32 Hs=256 d=1 z"] * 1.01
    assert kvp.compare(mine, other)[1] == []
    mine["twin b6 float32 Hs=256 d=1 z"] = 1.1e-5
    assert kvp.compare(mine, other)[1] == ["b6 float32 Hs=256 d=1 z"]
    assert kvp._tcn_tol("b1 bfloat16 gLN causal=0 d=1") == 4e-2
    assert kvp._tcn_tol("b3 float32 cLN causal=1 d=1 dx") == 4e-3
    assert kvp._tcn_tol("b6 float32 Hs=256 d=1 z") == 1e-5
    assert kvp._tcn_tol(INTER_FWD) == 1e-3


@pytest.mark.parametrize("key,bits", [
    ("b1 float32 gLN causal=0 d=1", False),
    ("b1 float32 cLN causal=1 d=16 P=5", False),
    ("b2 float32 gLN causal=0 d=128 dW_in", False),
    ("b2 float32 gLN causal=0 d=1 P=16 4", False),
    ("b4 float32 cLN causal=1 d=(16,32)", False),
    ("b5 float32 gLN causal=0 d=(1,2) a dW_out", False),
    ("b3 float32 cLN causal=1 d=1 dx", False),
    ("b1 bfloat16 gLN causal=0 d=1", True),
    ("b5 bfloat16 gLN causal=0 d=(1,2) dx", True),
    ("dpt inter bfloat16 S=128 heads=8 backward 0", True),
    ("dpt intra bfloat16 S=256 heads=4 backward 3", True),
    ("dpt intra bfloat16 S=128 heads=8 partial m=2 backward 1", True),
    ("dpt ffn bfloat16 S=128 heads=8 partial m=4 backward 0", True),
    ("dpt inter float32 S=128 heads=8 partial m=2 backward 0", True),
    ("dpt intra float32 S=208 heads=4 backward 4", True),
    ("dpt inter bfloat16 S=128 heads=8 partial m=2 forward", False),
    ("dpt intra float32 S=176 heads=4 forward", True),
    ("dpt ffn float32 S=128 heads=8 forward", True),
    ("dpt intra bfloat16 S=128 heads=8 forward", True),
    ("dpt intra bfloat16 S=256 heads=4 forward", True),
    ("dpt intra bfloat16 S=128 heads=8 partial m=4 forward", True),
    ("dpt ffn bfloat16 S=128 heads=8 forward", True),
    ("dpt ffn bfloat16 S=128 heads=8 partial m=2 forward", True),
    ("dpt inter bfloat16 S=128 heads=8 forward", False),
    ("dpt inter float32 S=128 heads=8 forward", True),
    ("b6 bfloat16 Hs=256 d=1 z", True),
    ("b4 bfloat16 gLN causal=0 d=(1,2)", True),
    ("b6 float32 Hs=128 d=16 sums", False)])
def test_bitwise_holds_the_redesigned_bf16_outputs_by_distance(key, bits):
    """The bf16 forward of B7 (and its partial mode) and the f32 outputs
    of B1-B6 sum in another order than their first designs: held by
    distance at their twins' bars (1e-3 at B7's rounding points; f32 2e-3
    forward, 3e-3 pair forward, 4e-3 backward, 1e-5 for B6 at its rounding
    points); every other output, the bf16 forwards of B9 and B11 (which
    keep their bits), the bf16 backwards and bf16 B6 among them, bit for
    bit."""
    assert kvp.bitwise(key) is bits
    if not bits:
        bar = {"dpt": 1e-3, "b1": 2e-3, "b4": 3e-3,
               "b6": 1e-5}.get(key.split()[0], 4e-3)
        assert kvp._tcn_tol(key) == bar


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


def test_summarize_keeps_a_shape_one_tree_refuses():
    """A metric only one tree has (a head width the other refuses) is laid
    out for that tree alone, in the order the turns first show it."""
    other = {"b7/b8 forward [8,25,128,256] f32 d=32": 1.0}
    this = {"b7/b8 forward [8,25,128,256] f32 d=16": 2.0,
            "b7/b8 forward [8,25,128,256] f32 d=32": 1.1}
    lines = kvp.summarize([("other", other), ("this", this), ("this", this),
                           ("other", other)])
    assert lines[0].startswith("b7/b8 forward [8,25,128,256] f32 d=32: "
                               "other 1.0000 1.0000 | this 1.1000 1.1000")
    assert lines[1] == ("b7/b8 forward [8,25,128,256] f32 d=16: this tree "
                        "only 2.0000 2.0000 ms")


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


@pytest.mark.parametrize("n,S,fwd_ms,bwd_ms", [(10, 320, 0.326, 0.927),
                                               (7, 512, 0.449, 1.290)])
def test_f32_intra_bounds(n, S, fwd_ms, bwd_ms):
    """The least times of B9 and B10 in f32 at [8, n, S, 256], 8 heads of
    32, that ``--time f32-attention`` prints beside their device times:
    B9's QKV, q k^T, p v and out products (30.1 GFLOP at S = 512) and
    B10's 11 projection and 6 core products (86.4 GFLOP) at 67 TFLOP/s,
    where their bytes take less."""
    assert kvp._f32_intra_bound_ms(n, S, False) == pytest.approx(fwd_ms,
                                                                 abs=5e-4)
    assert kvp._f32_intra_bound_ms(n, S, True) == pytest.approx(bwd_ms,
                                                                abs=5e-4)
    assert (n, S) in kvp.F32_INTRA_LONG


def test_same_bits_counts_every_output():
    """``same_bits`` counts the outputs this tree gives bit for bit among
    all the other tree's, those held by distance (the bf16 B7 forward)
    included and the twin distances left out: the count the bit proof
    prints as "n of n outputs in all the same bits"."""
    mine, other = _outs(0), _outs(0)
    assert kvp.same_bits(mine, other) == (9, 9)
    mine[INTER_FWD] = mine[INTER_FWD] * 1.01
    del mine["b6 float32 Hs=256 d=1 z"]
    assert kvp.same_bits(mine, other) == (7, 9)


def test_width_cases_cover_the_narrow_tiles():
    """The bit proof also runs every DPT kernel at B = 128 and 192 (B / 32
    heads; out's and DN's 128-wide tiles, and their 256-wide tiles with
    the columns past B zero) and at 320 and 512 (the wide routes), full
    and on a shard of 64 channels (256 at B = 512), in both dtypes, each
    output held bit for bit but the bf16 B7 forward's."""
    assert {(B, m) for _, _, B, m in kvp.WIDTH_CASES} == {
        (128, 2), (192, 3), (320, 5), (512, 2)}
    assert {(k, d) for k, d, _, _ in kvp.WIDTH_CASES} == {
        (k, d) for k in ("inter", "intra", "ffn")
        for d in ("bfloat16", "float32")}
    assert kvp.bitwise("dpt intra bfloat16 B=192 S=128 heads=6 forward")
    assert kvp.bitwise("dpt ffn float32 B=128 S=128 heads=4 partial m=2 "
                       "backward 0")
    assert not kvp.bitwise("dpt inter bfloat16 B=192 S=128 heads=6 forward")


def test_taps_cases_run_the_first_routes_in_both_trees():
    """The bit proof runs B1 (gLN, cLN causal), B2, B3 and B5 also at P = 5
    and 16 taps, d = 1 and 128, both dtypes: P <= 16 runs the first
    routes in both trees, an even P only causal. Each bf16 output is held
    bit for bit, each f32 one (the 3xTF32 stages) by distance."""
    assert {P for *_, P in kvp.TCN_TAPS_CASES} == {5, 16}
    assert {k for k, *_ in kvp.TCN_TAPS_CASES} == {"b1", "b2", "b3", "b5"}
    assert all(causal for _, _, causal, _, _, P in kvp.TCN_TAPS_CASES
               if P % 2 == 0)
    assert len(kvp.TCN_TAPS_CASES) == 2 * 5 * 2 * 2
    assert kvp.bitwise("b3 bfloat16 cLN causal=1 d=128 P=16 2")
    assert not kvp.bitwise("b3 float32 cLN causal=1 d=128 P=16 2")


@pytest.mark.parametrize("dtype,products,conv,nbytes,want", [
    # B1 at the paper shape, P = 3: two products of 2 M K B H and the taps
    ("bfloat16", 2 * 2 * 8 * 3199 * 256 * 512, 2 * 8 * 3199 * 512 * 3,
     26.3e6, 0.01365),
    # f32 at P = 33: the FMA peak
    ("float32", 2 * 2 * 8 * 3199 * 256 * 512, 2 * 8 * 3199 * 512 * 33,
     52.5e6, 0.2132),
    # a kernel whose bytes take longer than its FLOP
    ("bfloat16", 1e9, 0.0, 33.5e6, 0.0100)])
def test_taps_bound(dtype, products, conv, nbytes, want):
    """``--time taps``'s bound: the larger of the FLOP at the dtype's peak
    (989 TFLOP/s bf16, 67 TFLOP/s f32) and the bytes at 3.35 TB/s."""
    got = kvp._taps_bound_ms(dtype, products, conv, nbytes)
    assert got == pytest.approx(want, rel=2e-3)


def test_b6_cases_cover_every_route_up_to_512():
    """The bit proof runs B6 on every route a shard up to 512 channels
    wide takes (bf16: the wgmma stage at 128, 256 and 512, the first design
    at 448, both of whose outputs are held bit for bit; f32: its one route,
    the depthwise stage on dw_rows_f32 at 128, 256 and 512 and one channel
    a thread at 448, held by distance); ``--time tp`` times the widths past
    512 only in a tree whose rule takes them (this one takes them all)."""
    from convtasnet_tpu_torch.ops.cuda import tcn_block_tp

    assert {hs for _, hs, _ in kvp.B6_CASES} == {128, 256, 448, 512}
    assert {dt for dt, _, _ in kvp.B6_CASES} == {"bfloat16", "float32"}
    assert all(kvp.bitwise(f"b6 {dt} Hs={hs} d={d} {out}")
               is (dt == "bfloat16")
               for dt, hs, d in kvp.B6_CASES for out in ("z", "sums"))
    assert [hs for hs, _ in kvp.B6_TIMED if hs > 512] == [576, 768, 1024]
    assert all(tcn_block_tp.shape_refusal(hs, kvp.B, kvp.P, False) is None
               for hs, _ in kvp.B6_TIMED)


def test_twins_hold_only_the_moved_outputs():
    """``_twins`` records a TCN case's outputs (one tensor, or each of a
    sequence as ``key i``) and gives a twin distance only to the outputs
    held by distance (f32 B1, B2, B4, B5); a bf16 case keeps its bits."""
    t = torch.ones(3)
    out = {}
    kvp._twins(out, "b2 float32 gLN causal=0 d=1 P=5", [t, 2 * t],
               [t, 4 * t])
    assert out["twin b2 float32 gLN causal=0 d=1 P=5 0"] == 0.0
    assert out["twin b2 float32 gLN causal=0 d=1 P=5 1"] == 0.5
    kvp._twins(out, "b2 bfloat16 gLN causal=0 d=1 P=5", [t], [2 * t])
    assert "b2 bfloat16 gLN causal=0 d=1 P=5 0" in out
    assert not any(k.startswith("twin b2 bfloat16") for k in out)
    kvp._twins(out, "b1 float32 gLN causal=0 d=1 P=5", t, t)
    assert out["twin b1 float32 gLN causal=0 d=1 P=5"] == 0.0
    assert kvp.B5_SLOPES == (4, 5, 13, 14)


def test_f64_distances_are_printed_and_held_by_nothing():
    """The f64 distances of f32 B2 (each tree's kernel and the f32 twin)
    print beside each other and count as no output: ``compare`` and
    ``same_bits`` see the same outputs with them as without."""
    mine, other = _outs(0), _outs(0)
    key = "b2 float32 gLN causal=0 d=1"
    for tree, v in ((mine, 1e-6), (other, 3e-4)):
        tree[f"f64 {key} dx"] = v
        tree[f"f64 twin {key} dx"] = 5e-4
    assert kvp.compare(mine, other) == kvp.compare(_outs(0), _outs(0))
    assert kvp.same_bits(mine, other) == (9, 9)
    assert kvp.f64_lines(mine, other) == [
        f"{key} dx: from the f64 block, this tree 1.000e-06, other "
        "3.000e-04, the f32 twin 5.000e-04"]
