"""The PyTorch port imports no JAX: the machine with the GPU has none."""

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
        "import convtasnet_tpu_torch, convtasnet_tpu_torch.cli\n"
        "import convtasnet_tpu_torch.infer.separate\n"
        "import convtasnet_tpu_torch.models.jax_params\n"
        "import convtasnet_tpu_torch.ops.cuda.tcn_block\n"
        "import convtasnet_tpu_torch.ops.cuda.tcn_block_bwd\n"
        "import convtasnet_tpu_torch.train.solver\n"
        "import convtasnet_tpu_torch.data.loader\n"
        "import convtasnet_tpu_torch.data.segment_cache\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] == 'convtasnet_tpu'))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # of the JAX package, only its pure-dataclass config is reached
    assert proc.stdout.strip() == \
        "['convtasnet_tpu', 'convtasnet_tpu.config']"


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+flax|"
                         r"from\s+flax)\b", re.MULTILINE)
    sources = sorted(PORT.rglob("*.py"))
    assert sources
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []
