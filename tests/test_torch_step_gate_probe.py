"""The pure helpers of ``scripts/step_gate_probe.py`` (which runs on the
card only): ``pair_correlations`` gives the cosine of each (estimate,
source) pair whose SI-SNR the loss takes, and ``rename_package`` copies a
checkout's package under another name so that two trees load in one
process. On the CPU, with small tensors."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from convtasnet_tpu_torch.losses.pit import pit_si_snr

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "step_gate_probe.py"
_spec = importlib.util.spec_from_file_location("step_gate_probe", _PATH)
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_correlations_match_numpy(seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((3, 2, 400)) + 0.3
    e = rng.standard_normal((3, 2, 400)) + 0.5 * s[:, ::-1] - 1.0
    got = probe.pair_correlations(torch.from_numpy(s), torch.from_numpy(e))
    assert got.shape == (3, 2, 2)
    for b in range(3):
        for i in range(2):
            for j in range(2):
                want = np.corrcoef(e[b, i], s[b, j])[0, 1]
                assert got[b, i, j].item() == pytest.approx(want, rel=1e-9)


def test_pair_correlations_give_the_loss_si_snr():
    """The PIT loss's best permutation mean of 10 log10(c^2 / (1 - c^2))
    over the pairs: the quantity whose gradient goes as 1 / c."""
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.standard_normal((2, 2, 800)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((2, 2, 800)).astype(np.float32))
    e = e + 0.2 * s
    c = probe.pair_correlations(s, e)
    snr = 10 * torch.log10(c ** 2 / (1 - c ** 2))
    best = torch.maximum((snr[:, 0, 0] + snr[:, 1, 1]) / 2,
                         (snr[:, 0, 1] + snr[:, 1, 0]) / 2)
    max_snr, _ = pit_si_snr(s, e, torch.full((2,), 800))
    assert torch.allclose(best.float(), max_snr, atol=1e-3)


def test_rename_package_rewrites_only_its_own_imports(tmp_path):
    src = tmp_path / "src" / "convtasnet_tpu_torch"
    (src / "ops").mkdir(parents=True)
    (src / "_build").mkdir()
    (src / "_build" / "lib.so").write_text("binary")
    (src / "__init__.py").write_text("VALUE = 7\n")
    (src / "ops" / "__init__.py").write_text("")
    (src / "ops" / "m.py").write_text(
        "from convtasnet_tpu_torch import VALUE\n"
        "import convtasnet_tpu_torch.ops\n"
        "OTHER = 'convtasnet_tpu_torch_x'\n")
    root = tmp_path / "dst"
    root.mkdir()
    dst = Path(probe.rename_package(str(src), str(root), "ctn_probe_pkg"))
    text = (dst / "ops" / "m.py").read_text()
    assert "from ctn_probe_pkg import VALUE" in text
    assert "import ctn_probe_pkg.ops" in text
    assert "'convtasnet_tpu_torch_x'" in text
    assert not (dst / "_build").exists()
    sys.path.insert(0, str(root))
    try:
        mod = importlib.import_module("ctn_probe_pkg.ops.m")
        assert mod.VALUE == 7
    finally:
        sys.path.remove(str(root))
        for name in [n for n in sys.modules if n.startswith("ctn_probe_pkg")]:
            del sys.modules[name]


@pytest.mark.parametrize("text,want", [
    ("11,12", [11, 12]), ("13", [13]), ("11-18", list(range(11, 19)))])
def test_parse_seeds(text, want):
    assert probe.parse_seeds(text) == want


def test_reference_operands_round_only_the_dpt_matrices():
    """The DPT's weight matrices reach its kernels in x's dtype, so their
    f64 twin takes them rounded; its vectors, the key bias's -inf and the
    TCN's operands stay as they are, and None stays None."""
    x = torch.zeros(2, 3, dtype=torch.bfloat16)
    w = torch.tensor([[1.0 + 2.0 ** -12, 3.0]])
    v = torch.tensor([1.0 + 2.0 ** -12])
    bias = torch.tensor([[0.0, float("-inf")]])
    got = probe.reference_operands("dpt", x, [v, w, None])
    assert got[0].dtype == got[1].dtype == torch.float64 and got[2] is None
    assert got[0].item() == 1.0 + 2.0 ** -12
    assert got[1].tolist() == [[1.0, 3.0]]
    assert probe.reference_operands("dpt", x, [bias])[0].tolist() == [
        [0.0, float("-inf")]]
    assert probe.reference_operands("tcn", x, [w])[0].tolist() == [
        [1.0 + 2.0 ** -12, 3.0]]


def test_sites_name_the_wrappers_and_their_twins():
    """Every site the probe swaps names a wrapper that counts its launches
    and a twin of the same module, and as many gradient names as the
    twin's backward returns on a small input."""
    import importlib

    for separator, sites in probe.SITES.items():
        for kind, fmod, fname, fref, bmod, bname, bref, names in sites:
            fm = importlib.import_module(f"convtasnet_tpu_torch.{fmod}")
            bm = importlib.import_module(f"convtasnet_tpu_torch.{bmod}")
            for mod, name in ((fm, fname), (bm, bname)):
                assert hasattr(getattr(mod, name), "launches"), name
            assert callable(getattr(fm, fref)) and callable(getattr(bm, bref))
            assert len(set(names)) == len(names) and names[0] == "dx"
    rng = np.random.default_rng(5)

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    from convtasnet_tpu_torch.ops.cuda import dpt_attention, dpt_ffn
    x, g = t(1, 2, 4, 64), t(1, 2, 4, 64)
    got = dpt_attention.inter_attention_bwd_reference(
        x, g, t(64), t(64), t(64, 192), t(64, 64), None, n_heads=2)
    assert len(got) == len(probe.SITES["dpt"][0][-1])
    got = dpt_ffn.ffn_bwd_reference(x, g, t(64), t(64), t(64, 128), t(128),
                                    t(128, 64), t(64))
    assert len(got) == len(probe.SITES["dpt"][2][-1])
