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
