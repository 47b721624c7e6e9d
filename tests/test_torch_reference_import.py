"""Reference PyTorch packages in and out of the port
(``convtasnet_tpu_torch/models/torch_import.py``), the cases of
tests/test_torch_import.py for the JAX importer.

A reference-layout state dict from the independent oracle
(``tests/torch_oracle.make_state_dict``) converts to the port's state dict
bit for bit as the JAX package's ``convert_state_dict`` followed by
``state_dict_from_jax`` does, key by key; the port's forward of it is
within 5e-4 of ``torch_oracle.forward`` for every norm, the causal model,
softmax masks with C=3 and the paper config; export then import is the
identity; the dual-path export raises; and ``cli import-torch`` /
``export-torch`` round-trip a paper-config package and a JAX ``.ckpt``.
"""

import os

import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig as JaxConfig
from convtasnet_tpu.models import torch_import as jimport
from convtasnet_tpu_torch import cli
from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models import torch_import as pimport
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet, init_params
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.train.checkpoint import load_params_for_inference
from tests.torch_oracle import forward as oracle_forward
from tests.torch_oracle import make_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_filters=24, kernel_size=10, bottleneck=16, hidden=32,
             conv_kernel=3, num_blocks=3, num_repeats=2, num_speakers=2)
CASES = {
    "gLN": dict(SMALL),
    "cLN": dict(SMALL, norm_type="cLN"),
    "BN": dict(SMALL, norm_type="BN"),
    "causal": dict(SMALL, norm_type="cLN", causal=True),
    "softmax_c3": dict(SMALL, num_speakers=3, mask_nonlinear="softmax"),
    "paper": {},
}


def _forward(cfg, sd, mix):
    model = ConvTasNet(cfg, use_pallas=False)
    model.load_state_dict(sd)
    model.eval()
    with torch.no_grad():
        return model(mix)


def _package(cfg, sd, epoch=42):
    return {"N": cfg.n_filters, "L": cfg.kernel_size, "B": cfg.bottleneck,
            "H": cfg.hidden, "P": cfg.conv_kernel, "X": cfg.num_blocks,
            "R": cfg.num_repeats, "C": cfg.num_speakers,
            "norm_type": cfg.norm_type, "causal": cfg.causal,
            "mask_nonlinear": cfg.mask_nonlinear, "state_dict": sd,
            "optim_dict": {}, "epoch": epoch}


@pytest.mark.parametrize("case", list(CASES))
def test_convert_equals_jax_and_forward_matches_oracle(case):
    cfg = ConvTasNetConfig(**CASES[case])
    ref = make_state_dict(cfg, seed=0)
    got = pimport.convert_state_dict(ref, cfg)
    want = state_dict_from_jax(
        jimport.convert_state_dict(ref, JaxConfig(**CASES[case])), cfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    T = 8000 if case == "paper" else 4000
    mix = torch.randn(2, T, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(_forward(cfg, got, mix).numpy(),
                               oracle_forward(ref, cfg, mix).numpy(),
                               rtol=0, atol=5e-4)


def test_module_prefix_is_stripped():
    cfg = ConvTasNetConfig(**SMALL)
    ref = make_state_dict(cfg, seed=2)
    a = pimport.convert_state_dict(ref, cfg)
    b = pimport.convert_state_dict({f"module.{k}": v for k, v in ref.items()},
                                   cfg)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", ["gLN", "BN", "causal"])
def test_export_then_import_is_the_identity(case):
    cfg = ConvTasNetConfig(**CASES[case])
    sd = init_params(cfg, torch.Generator().manual_seed(5))
    if case == "BN":   # running statistics off their init
        for k in sd:
            if k.endswith((".mean", ".var")):
                sd[k] = sd[k] + 0.1 * torch.rand(sd[k].shape)
    ref = pimport.export_state_dict(sd, cfg)
    want = jimport.export_state_dict(
        jimport.convert_state_dict(ref, JaxConfig(**CASES[case])),
        JaxConfig(**CASES[case]))
    assert set(ref) == set(want)
    for k in want:
        assert torch.equal(ref[k], want[k]), k
    back = pimport.convert_state_dict(ref, cfg)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    mix = torch.randn(1, 4000, generator=torch.Generator().manual_seed(6))
    np.testing.assert_allclose(oracle_forward(ref, cfg, mix).numpy(),
                               _forward(cfg, sd, mix).numpy(), rtol=0,
                               atol=5e-4)


def test_dpt_export_raises():
    cfg = ConvTasNetConfig(separator="dpt", n_filters=16, kernel_size=8,
                           bottleneck=64, dpt_chunk=16, dpt_layers=1,
                           dpt_heads=2, dpt_ff=128)
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="dual-path"):
        pimport.export_state_dict(sd, cfg)


def test_torch_package_import(tmp_path):
    """A reference torch.save package: its config from the hyperparameters,
    the port's package from ``import_to_checkpoint`` and its forward within
    5e-4 of the oracle's; a package that needs unsafe unpickling raises."""
    cfg = ConvTasNetConfig(**SMALL)
    ref = make_state_dict(cfg, seed=3)
    tp = str(tmp_path / "ref.pth.tar")
    torch.save(_package(cfg, ref), tp)
    cfg2, sd = pimport.load_torch_package(tp)
    assert cfg2 == cfg
    out = str(tmp_path / "imported.pt")
    assert pimport.import_to_checkpoint(tp, out) == cfg
    cfg3, sd3 = load_params_for_inference(out)
    assert cfg3 == cfg and all(torch.equal(sd3[k], sd[k]) for k in sd)
    mix = torch.randn(1, 4000, generator=torch.Generator().manual_seed(7))
    np.testing.assert_allclose(_forward(cfg3, sd3, mix).numpy(),
                               oracle_forward(ref, cfg, mix).numpy(),
                               rtol=0, atol=5e-4)
    unsafe = str(tmp_path / "unsafe.pth.tar")
    torch.save({**_package(cfg, ref), "extra": ConvTasNetConfig()}, unsafe)
    with pytest.raises(ValueError, match="unsafe unpickling"):
        pimport.load_torch_package(unsafe)
    torch.save({"state_dict": ref}, unsafe)
    with pytest.raises(ValueError, match="lacks the hyperparameters"):
        pimport.load_torch_package(unsafe)


def test_cli_paper_config_round_trip(tmp_path, capsys):
    """``cli import-torch`` of a paper-config reference package, ``cli
    separate`` of the result on the CPU, then ``cli export-torch`` back:
    every tensor of the input comes back bit for bit."""
    cfg = ConvTasNetConfig()
    ref = make_state_dict(cfg, seed=11)
    tp = str(tmp_path / "ref.pth.tar")
    torch.save(_package(cfg, ref, epoch=7), tp)
    pkg = str(tmp_path / "imported.pt")
    assert cli.main(["import-torch", "--torch-path", tp, "--out-path",
                     pkg]) == 0
    assert "imported" in capsys.readouterr().out
    back = str(tmp_path / "exported.pth.tar")
    assert cli.main(["export-torch", "--ckpt-path", pkg, "--out-path",
                     back]) == 0
    pkg2 = torch.load(back, map_location="cpu", weights_only=True)
    assert (pkg2["N"], pkg2["L"], pkg2["B"], pkg2["H"], pkg2["X"],
            pkg2["R"]) == (256, 20, 256, 512, 8, 4)
    assert set(pkg2["state_dict"]) == set(ref)
    for k, v in ref.items():
        assert pkg2["state_dict"][k].shape == v.shape, k
        assert torch.equal(pkg2["state_dict"][k], v), k

    from convtasnet_tpu_torch.data.audio_io import read_wav, write_wav

    mix_dir = tmp_path / "mix"
    mix_dir.mkdir()
    x = 0.1 * np.random.default_rng(0).standard_normal(8000)
    write_wav(str(mix_dir / "a.wav"), x.astype(np.float32), 8000)
    out = str(tmp_path / "sep")
    assert cli.main(["separate", "--model-path", pkg, "--mix-dir",
                     str(mix_dir), "--out-dir", out, "--device", "cpu"]) == 0
    est = read_wav(os.path.join(out, "a_s1.wav"))[0]
    want = oracle_forward(ref, cfg, torch.from_numpy(
        read_wav(str(mix_dir / "a.wav"))[0][None]))[0, 0].numpy()
    assert np.abs(est - want).max() <= 2.0 / 32768 + 5e-4


def test_export_torch_reads_a_jax_ckpt(tmp_path):
    """``export-torch`` of the committed JAX TCN fixture equals the JAX
    package's ``export_to_torch`` of it, tensor by tensor."""
    src = os.path.join(REPO, "tests", "fixtures", "jax_tcn.ckpt")
    got, want = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    assert cli.main(["export-torch", "--ckpt-path", src, "--out-path",
                     got]) == 0
    jimport.export_to_torch(src, want)
    a = torch.load(got, map_location="cpu", weights_only=True)
    b = torch.load(want, map_location="cpu", weights_only=False)
    assert {k: v for k, v in a.items() if k != "state_dict"} == \
        {k: v for k, v in b.items() if k != "state_dict"}
    assert set(a["state_dict"]) == set(b["state_dict"])
    for k in b["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
    # imported back, it serves as the JAX .ckpt does, to the bit
    cfg, sd = load_params_for_inference(src)
    mix = torch.randn(1, 4000, generator=torch.Generator().manual_seed(9))
    cfg2, sd2 = pimport.load_torch_package(got)
    np.testing.assert_array_equal(_forward(cfg2, sd2, mix).numpy(),
                                  _forward(cfg, sd, mix).numpy())
