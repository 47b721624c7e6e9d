#!/usr/bin/env python3
"""Plant known faults in copies of the TCN block forward (kernel B1) and
its gLN backward (B2) on the Hopper core, of the DPT sublayer kernels, of
the cLN block backward (B3), of the TCN block pair (B4 and B5, which run
each block through the single block's launches), of
the TCN's tensor parallelism (kernel B6 and the shard sum around it) and
of the dual-path tensor parallelism (the partial kernels B7p-B12p and
the shard sums around them), and report which checks see each one. Needs
one CUDA GPU and nvcc.

    python3 scripts/planted_faults.py [--log-dir DIR] [--only NAME ...] \\
        [--jobs N]

For each fault the script copies ``convtasnet_tpu_torch/`` (without its
build directory), ``chip_smoke.py``, ``pyproject.toml`` and
``tests/test_torch_cuda.py`` into a temporary directory, edits one line of
the copy (a kernel source, or a module around one), and runs there,
against the edited code, the
smoke phases of the kernel's kind (``PHASES``: for B1
``chip_smoke.phase_kernel_vs_twin`` gLN and cLN causal and
``phase_step_compare(torch, "tcn")``, for B2 ``phase_bwd_vs_twin(torch,
bwd)`` and ``phase_step_compare(torch, "tcn")``, for a DPT forward kernel
``chip_smoke.phase_dpt_kernels_vs_twin`` and ``phase_dpt_forward``, for a
DPT backward ``phase_dpt_bwd_vs_twin`` and ``phase_step_compare(torch,
"dpt")``, for B3 ``phase_bwd_vs_twin(torch, bwd, "cLN")`` and
``phase_step_compare(torch, "tcn", "cLN")``, for the block pair
``phase_pair_vs_twin``, ``phase_pair_bwd_vs_twin`` and
``phase_step_compare(torch, "tcn")``, for tensor parallelism
``phase_tp_stage2_vs_twin``, ``phase_tp_forward`` and
``phase_step_compare(torch, "tcn")``, for dual-path tensor parallelism
``phase_dpt_partial_vs_twin``, ``phase_dpt_tp_forward`` and
``phase_step_compare(torch, "dpt")``), then the kind's ``cuda``-marked
tests. The repository itself is never edited. A fault is caught when either
run fails. ``--jobs N`` runs N faults at once on the one card. Each run's
full output goes to ``--log-dir`` (default: a new temporary directory),
one file per fault.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (kind, file, the line's text as it is, the planted text)
FAULTS = {
    "inter_bias_transposed": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_attention.cu",
        "p.bias[static_cast<size_t>(k0 + j) * S + s]",
        "p.bias[static_cast<size_t>(s) * n + k0 + j]"),
    "intra_mask_dropped": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_intra.cu",
        "b_s[k] = p.bias ? p.bias[static_cast<size_t>(chunk) * S + k] : 0.f;",
        "b_s[k] = 0.f;"),
    "ffn_gelu_erf": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_ffn.cu",
        "return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));",
        "return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)) + 0.f * k;"),
    "inter_no_rescale": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_attention.cu",
        "sum = sum * expf(mx - mn) + expf(sc - mn);",
        "sum = sum + expf(sc - mn);"),
    "ln_eps_1e-5": ("dpt_forward",
        "convtasnet_tpu_torch/csrc/dpt_common.cuh",
        "constexpr float kLnEps = 1e-6f;",
        "constexpr float kLnEps = 1e-5f;"),
    # the backward kernels
    "intra_bwd_rowsum_dropped": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_intra_bwd.cu",
        "from_f<T>(prow[k] * (drow[k] - rs) * scale)",
        "from_f<T>(prow[k] * drow[k] * scale + 0.f * rs)"),
    "inter_bwd_bias_transposed": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_attention_bwd.cu",
        "p.bias[static_cast<size_t>(c) * S + s]",
        "p.bias[static_cast<size_t>(s) * n + c]"),
    "ffn_bwd_gelu_erf_derivative": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_ffn_bwd.cu",
        "*dy = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * "
        "(1.f + 3.f * a * x * x);",
        "*dy = 0.5f * (1.f + erff(x * 0.70710678118654752f)) + "
        "x * 0.3989422804014327f * expf(-0.5f * x * x) + 0.f * a;"),
    "inter_bwd_dk_unscaled": ("dpt_backward",
        "convtasnet_tpu_torch/csrc/dpt_attention_bwd.cu",
        "round_to<T>(pj * (dot(dav, vv) - st[2]) * scale)",
        "round_to<T>(pj * (dot(dav, vv) - st[2]))"),
    # the TCN block forward (B1) on the Hopper core: C' recomputing y with
    # its taps one row off (the halo shifted by one), and B' writing
    # sample m's norm2 partials into the next sample's slots
    "b1_c_halo_off_by_one": ("block_forward",
        "convtasnet_tpu_torch/csrc/tcn_block_hopper.cuh",
        "static_cast<const bf16*>(p.dw), K, H, P, d, left, r0, cg, rg,",
        "static_cast<const bf16*>(p.dw), K, H, P, d, left + 1, r0, cg, rg,"),
    "b1_b_stats_of_next_sample": ("block_forward",
        "convtasnet_tpu_torch/csrc/tcn_block_hopper.cuh",
        "    float* dst = p.part_b + 2 * (static_cast<size_t>(m) * gridDim.x + "
        "blockIdx.x);",
        "    float* dst = p.part_b + 2 * (static_cast<size_t>((m + 1) % "
        "gridDim.y) * gridDim.x + blockIdx.x);"),
    # B1's cLN path in C': the normalised row rounded without norm2's
    # shift b2 (the b2 @ W_out term of the fold it replaced, forgotten),
    # and the row's two warps at H = 512 not waiting for each other's half
    # of the row sums (a race)
    "b1_cln_shift_dropped": ("block_forward",
        "convtasnet_tpu_torch/csrc/tcn_block_hopper.cuh",
        "yv[j] = k < K ? (yv[j] - mu) * rs * g2[j] + b2[j] : 0.f;",
        "yv[j] = k < K ? (yv[j] - mu) * rs * g2[j] : 0.f;"),
    "b1_cln_row_halves_unsynced": ("block_forward",
        "convtasnet_tpu_torch/csrc/tcn_block_hopper.cuh",
        "if (n_seg > 1)",
        "if (n_seg < 1)"),
    # the gLN block backward (B2): G1' writing F3's partials (t1, t2) into
    # the next sample's slots, and the split-row weight gradients summing
    # the rows past the last one (read beyond the operands, not zeros)
    "b2_f3_stats_of_next_sample": ("block_backward",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_hopper.cuh",
        "      float* dst = p.part + 2 * (static_cast<size_t>(m) * gridDim.x + "
        "bx);",
        "      float* dst = p.part + 2 * (static_cast<size_t>((m + 1) % "
        "gridDim.y) * gridDim.x + bx);"),
    "b2_wgrad_rows_past_the_end": ("block_backward",
        "convtasnet_tpu_torch/csrc/hopper_gemm.cuh",
        "  const int r_end = min(rows, r0 + chunk);",
        "  const int r_end = r0 + chunk;"),
    # the cLN block backward (B3), in bf16 on the Hopper stages
    # (tcn_block_bwd_hopper.cuh: E2' as it runs at P = 3, e2_dc_kernel)
    # and, for the row finaliser both dtypes run, in
    # tcn_block_bwd_common.cuh
    "cln_bwd_tap_stats_of_output_row": ("cln_backward",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_hopper.cuh",
        "              const float* sk = stat_at(p, true, m, kh);",
        "              const float* sk = stat_at(p, true, m, j);"),
    "cln_bwd_g1_row_sum_half_twice": ("cln_backward",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_hopper.cuh",
        "            q2 = group_sum(q2, kSeg);",
        "            q2 = 2.f * group_sum(q2, kSeg / 2);"),
    "cln_bwd_e2_row_partial_shifted": ("cln_backward",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_hopper.cuh",
        "2 * ((static_cast<size_t>(m) * K + j) * gridDim.y + blockIdx.y);",
        "2 * ((static_cast<size_t>(m) * K + (j + 1) % K) * gridDim.y + "
        "blockIdx.y);"),
    "cln_bwd_row_mean_over_h_minus_1": ("cln_backward",
        "convtasnet_tpu_torch/csrc/tcn_block_bwd_common.cuh",
        "st[slot + 1] = static_cast<float>(s2 / H);",
        "st[slot + 1] = static_cast<float>(s2 / (H - 1));"),
    # the block pair (B4, B5), which runs each block through the single
    # block's launches: B5 re-forming x1 on the first design's launches in
    # bf16 (another rounding than B4's x1; in f32 the same code), block 2
    # of B4 normalised with block 1's norm1 affine, run at block 1's
    # dilation, or reading the x1 rows of the neighbouring 128-row tile,
    # block 1's backward in B5 on g in place of dx1, and B5 keeping x1 in
    # the segment where block 2's backward writes dx1
    "pair_x1_rounded_otherwise": ("pair",
        "convtasnet_tpu_torch/csrc/tcn_block_pair_bwd.cu",
        "  CTN_TRY(launch_block<T>(forward_params(",
        "  CTN_TRY(launch_block_first<T, kNormGLN>(forward_params("),
    "pair_block2_norm1_of_block1": ("pair",
        "convtasnet_tpu_torch/csrc/tcn_block_pair.cu",
        "{w_in2, dw2, w_out2, a1b, a2b, g1b, b1b, g2b, b2b};",
        "{w_in2, dw2, w_out2, a1b, a2b, g1a, b1a, g2b, b2b};"),
    "pair_block2_dilation_of_block1": ("pair",
        "convtasnet_tpu_torch/csrc/tcn_block_pair.cu",
        "part_b, M, K, B, H, P, d2, causal, norm);",
        "part_b, M, K, B, H, P, d1, causal, norm);"),
    "pair_block2_x1_of_neighbouring_tile": ("pair",
        "convtasnet_tpu_torch/csrc/tcn_block_pair.cu",
        "  const Params p2 = block_params(wb, x1, out,",
        "  const Params p2 = block_params(wb, x1 + 128 * B, out,"),
    "pair_bwd_block1_cotangent_g": ("pair",
        "convtasnet_tpu_torch/csrc/tcn_block_pair_bwd.cu",
        "BwdParams q1 = block_bwd_params(wa, x, dx1, dx,",
        "BwdParams q1 = block_bwd_params(wa, x, g, dx,"),
    "pair_bwd_x1_on_dx1": ("pair",
        "convtasnet_tpu_torch/csrc/tcn_block_pair_bwd.cu",
        "  T* x1 = act + L.act[0];",
        "  T* x1 = act + L.act[1];"),
    # TCN tensor parallelism: B6 with the gLN-1 shift added for taps
    # outside [0, K) (the Pallas halo's trap), B6 with g2 folded into W_out
    # in place of rounding y g2 (planted in its wrapper: W_eff in the
    # compute dtype and g2 = 1; in f32 the same numbers, so only bf16 can
    # see it), and the shard sum's epilogue without the g2 @ W_out term
    "tp2_shift_on_out_of_range_taps": ("tp",
        "convtasnet_tpu_torch/csrc/tcn_block_tp.cu",
        "if (kk < 0 || kk >= K) continue;  // zero padding after gLN-1",
        "if (kk < 0 || kk >= K) { acc = fmaf(to_f<T>(dw[q * Hs + c]), sh, "
        "acc); continue; }"),
    "tp2_g2_folded_into_w_out": ("tp",
        "convtasnet_tpu_torch/ops/cuda/tcn_block_tp.py",
        "    dw, w_out = (t.to(dt).contiguous() for t in (dw, w_out))",
        "    dw, w_out, gamma2 = (dw.to(dt).contiguous(), (w_out * gamma2[:, "
        "None]).to(dt).contiguous(), torch.ones_like(gamma2))"),
    "tp_shard_sum_drops_w1": ("tp",
        "convtasnet_tpu_torch/parallel/tensor_parallel.py",
        "        y = tp_epilogue(y, z, stats_from_sums(sums2, n), w1, w0)",
        "        y = tp_epilogue(y, z, stats_from_sums(sums2, n), 0 * w1, w0)"),
    # dual-path tensor parallelism: the residual kept in a partial (bf16)
    # attention forward, so the m shards' residuals are summed; the down
    # bias added once per shard; a contiguous column split of W_qkv in
    # place of the head-aligned one; g kept in a partial backward's dx
    "dpt_partial_keeps_residual": ("dpt_tp",
        "convtasnet_tpu_torch/csrc/dpt_common.cuh",
        "      for (int e = 0; e < 8; ++e) o[e] = round_to<T>(v[e]);",
        "      for (int e = 0; e < 8; ++e) o[e] = to_f<T>(x[idx + e]) + "
        "round_to<T>(v[e]);"),
    "dpt_tp_b_down_per_shard": ("dpt_tp",
        "convtasnet_tpu_torch/parallel/dpt_tp.py",
        "    return (x3 + all_reduce(parts) + b_down.to(x.dtype))",
        "    return (x3 + all_reduce(parts) + len(parts) * b_down.to(x.dtype))"),
    "dpt_tp_qkv_contiguous_split": ("dpt_tp",
        "convtasnet_tpu_torch/parallel/dpt_tp.py",
        "[q[:, heads], k[:, heads], v[:, heads]], dim=1)",
        "[variables[pre + 'qkv.kernel'][:, 3 * heads.start:3 * heads.stop]],"
        " dim=1)"),
    "dpt_partial_bwd_keeps_g": ("dpt_tp",
        "convtasnet_tpu_torch/csrc/dpt_bwd_common.cuh",
        "P.dgb, !f.partial, stream);",
        "P.dgb, true, stream);"),
}
# The smoke phases a fault of each kind is run through; each phase runs
# whether or not an earlier one failed, and prints "PHASE <call>: passed"
# or "PHASE <call>: FAILED <reason>"; then the card tests that -k selects.
PHASES = {
    "block_forward": ["phase_kernel_vs_twin(torch, k['tcn'])",
                      "phase_kernel_vs_twin(torch, k['tcn'], 'cLN', True)",
                      "phase_step_compare(torch, 'tcn')"],
    "block_backward": ["phase_bwd_vs_twin(torch, bwd)",
                       "phase_step_compare(torch, 'tcn')"],
    "dpt_forward": ["phase_dpt_kernels_vs_twin(torch, dpt)",
                    "phase_dpt_forward(torch, dpt)"],
    "dpt_backward": ["phase_dpt_bwd_vs_twin(torch, dpt)",
                     "phase_step_compare(torch, 'dpt')"],
    "cln_backward": ["phase_bwd_vs_twin(torch, bwd, 'cLN')",
                     "phase_step_compare(torch, 'tcn', 'cLN')"],
    "pair": ["phase_pair_vs_twin(torch, k)",
             "phase_pair_bwd_vs_twin(torch, k)",
             "phase_step_compare(torch, 'tcn')"],
    "tp": ["phase_tp_stage2_vs_twin(torch, k)",
           "phase_tp_forward(torch, k)",
           "phase_step_compare(torch, 'tcn')"],
    "dpt_tp": ["phase_dpt_partial_vs_twin(torch, dpt)",
               "phase_dpt_tp_forward(torch, dpt)",
               "phase_step_compare(torch, 'dpt')"],
}
CARD_TESTS = {"block_forward": "kernel_matches_twin or model_kernel_path "
                               "or fused_block_ad or rounding_points",
              "block_backward": "bwd or fused_block_ad or train_grads or "
                                "wgmma",
              "dpt_forward": "dpt", "dpt_backward": "dpt",
              "cln_backward": "cln", "pair": "pair", "tp": "tp_",
              "dpt_tp": "partial or dpt_tp"}
RUNNER = """
import sys
import torch
import chip_smoke
from chip_smoke import *
from convtasnet_tpu_torch.ops.cuda import dpt_attention, dpt_ffn, dpt_intra
from convtasnet_tpu_torch.ops.cuda import tcn_block_bwd as bwd
k = tcn_modules()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dpt = {'inter': dpt_attention, 'intra': dpt_intra, 'ffn': dpt_ffn}
failed = False
for call in sys.argv[1:]:
    try:
        eval(call)
        print(f"PHASE {call}: passed", flush=True)
    except AssertionError as e:
        failed = True
        print(f"PHASE {call}: FAILED {str(e)[:400]}", flush=True)
sys.exit(1 if failed else 0)
"""
COPIED = ("chip_smoke.py", "pyproject.toml", "tests/test_torch_cuda.py")


def plant(root: str, name: str) -> str:
    """A copy of the package and its checks with fault ``name`` planted."""
    _, path, old, new = FAULTS[name]
    d = os.path.join(root, name)
    shutil.copytree(os.path.join(REPO, "convtasnet_tpu_torch"),
                    os.path.join(d, "convtasnet_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    os.makedirs(os.path.join(d, "tests"))
    for f in COPIED:
        shutil.copy(os.path.join(REPO, f), os.path.join(d, f))
    with open(os.path.join(d, path)) as f:
        src = f.read()
    if src.count(old) != 1:
        raise RuntimeError(f"{name}: the line to edit occurs {src.count(old)}"
                           f" times in {path}")
    with open(os.path.join(d, path), "w") as f:
        f.write(src.replace(old, new))
    return d


def run_fault(root: str, name: str, log_dir: str) -> list:
    """Plants fault ``name``, runs its kind's smoke phases and card tests
    against it, writes the full log and returns the lines to print."""
    d = plant(root, name)
    env = dict(os.environ, PYTHONPATH=d)
    kind = FAULTS[name][0]
    smoke = subprocess.run([sys.executable, "-c", RUNNER, *PHASES[kind]],
                           cwd=d, env=env, capture_output=True, text=True)
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
         "tests/test_torch_cuda.py", "-q", "-k", CARD_TESTS[kind],
         "-p", "no:cacheprovider"], cwd=d, env=env,
        capture_output=True, text=True)
    with open(os.path.join(log_dir, f"{name}.log"), "w") as f:
        f.write(smoke.stdout + smoke.stderr + "\n=== card tests\n"
                + tests.stdout + tests.stderr)
    summary = (tests.stdout.strip().splitlines() or [""])[-1]
    caught = smoke.returncode != 0 or tests.returncode != 0
    lines = [f"== {name}: {'CAUGHT' if caught else 'not caught'}; "
             f"smoke phases rc={smoke.returncode}, card tests "
             f"rc={tests.returncode} ({summary})"]
    lines += ["    " + line for line in smoke.stdout.splitlines()
              if line.startswith("PHASE") or "dpt forward B" in line]
    lines += ["    " + line[:300] for line in smoke.stderr.splitlines()[-3:]]
    lines += ["    " + line[:200] for line in tests.stdout.splitlines()
              if line.startswith("FAILED")]
    shutil.rmtree(d, ignore_errors=True)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--only", nargs="*", choices=sorted(FAULTS))
    ap.add_argument("--jobs", type=int, default=1,
                    help="faults run at once on the one card (each builds "
                         "its own copy of the kernels)")
    a = ap.parse_args()
    log_dir = a.log_dir or tempfile.mkdtemp(prefix="faults_logs_")
    os.makedirs(log_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="faults_") as root, \
            concurrent.futures.ThreadPoolExecutor(a.jobs) as pool:
        runs = [pool.submit(run_fault, root, name, log_dir)
                for name in a.only or FAULTS]
        for run in runs:
            print("\n".join(run.result()), flush=True)
    print(f"logs in {log_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
