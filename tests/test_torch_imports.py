"""The PyTorch port imports no JAX and nothing of the JAX package: the
machine with the GPU has no JAX, and the port keeps its own copy of what
it needs (``convtasnet_tpu_torch/config.py``)."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "convtasnet_tpu_torch"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['convtasnet_tpu'] = None\n"
        "import convtasnet_tpu_torch, convtasnet_tpu_torch.cli\n"
        "import convtasnet_tpu_torch.config\n"
        "import convtasnet_tpu_torch.infer.separate\n"
        "import convtasnet_tpu_torch.infer.evaluate\n"
        "import convtasnet_tpu_torch.infer.bss_eval\n"
        "import convtasnet_tpu_torch.models.dual_path\n"
        "import convtasnet_tpu_torch.models.jax_params\n"
        "import convtasnet_tpu_torch.ops.cuda.tcn_block\n"
        "import convtasnet_tpu_torch.ops.cuda.tcn_block_bwd\n"
        "import convtasnet_tpu_torch.ops.cuda.tcn_block_pair\n"
        "import convtasnet_tpu_torch.ops.cuda.tcn_block_pair_bwd\n"
        "import convtasnet_tpu_torch.ops.cuda.tcn_block_tp\n"
        "import convtasnet_tpu_torch.parallel.mesh\n"
        "import convtasnet_tpu_torch.parallel.tensor_parallel\n"
        "import convtasnet_tpu_torch.parallel.dpt_tp\n"
        "import convtasnet_tpu_torch.ops.cuda.dpt_attention\n"
        "import convtasnet_tpu_torch.ops.cuda.dpt_intra\n"
        "import convtasnet_tpu_torch.ops.cuda.dpt_ffn\n"
        "import convtasnet_tpu_torch.train.solver\n"
        "import convtasnet_tpu_torch.data.loader\n"
        "import convtasnet_tpu_torch.data.segment_cache\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('convtasnet_tpu', 'jax', 'flax')\n"
        "             and sys.modules[m] is not None))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # with the JAX package blocked every import above succeeds, and no
    # module of it (nor of jax or flax) is loaded
    assert proc.stdout.strip() == "[]"


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+flax|"
                         r"from\s+flax)\b", re.MULTILINE)
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert sources
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_no_jax_package_import_in_port_sources():
    """A source scan for ``convtasnet_tpu`` imports; the pattern does not
    match ``convtasnet_tpu_torch``."""
    pattern = re.compile(r"^\s*(from|import)\s+convtasnet_tpu(\.|\s|$)",
                         re.MULTILINE)
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert pattern.search("from convtasnet_tpu.config import X")
    assert pattern.search("import convtasnet_tpu\n")
    assert not pattern.search("from convtasnet_tpu_torch.config import X")
