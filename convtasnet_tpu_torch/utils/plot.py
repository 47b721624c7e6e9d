"""Loss-curve rendering from the solver's JSONL history.

The port's own copy of ``convtasnet_tpu/utils/plot.py``. matplotlib is
imported inside ``plot_history`` only, and nothing else imports this
module: where matplotlib is absent, ``plot_history`` raises naming it.

The reference streamed loss curves to a live visdom server
(``src/solver.py:45-52,148-166``, documented ``README.md:51-57`` with
``egs/wsj0/loss.png``). Here the solver writes ``history.jsonl``
(``utils/metrics.py``) and this module renders the same train/cv-per-epoch
figure (plus an optional per-iteration panel) to a PNG — no server needed.
"""

from __future__ import annotations

import json
import os
from typing import Optional


def plot_history(history_path: str, out_path: Optional[str] = None,
                 per_iter: bool = False) -> str:
    """Render loss curves. Returns the written image path."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plotting the loss history needs matplotlib, which is not "
            "installed here; history.jsonl holds the same numbers") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = {"train": {}, "valid": {}}
    iters = []
    with open(history_path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("kind") == "epoch":
                epochs[rec["split"]][rec["epoch"]] = rec["loss"]
            elif rec.get("kind") == "iter":
                iters.append((rec["epoch"], rec["iter"], rec.get("loss")))

    n_panels = 2 if (per_iter and iters) else 1
    fig, axes = plt.subplots(1, n_panels, figsize=(6 * n_panels, 4))
    if n_panels == 1:
        axes = [axes]

    ax = axes[0]
    for split, marker in (("train", "o"), ("valid", "s")):
        if epochs[split]:
            xs = sorted(epochs[split])
            ax.plot([x + 1 for x in xs], [epochs[split][x] for x in xs],
                    marker=marker, label=f"{split} loss", markersize=3)
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss (-SI-SNR dB)")
    ax.legend()
    ax.grid(True, alpha=0.3)
    ax.set_title("Training curves")

    if n_panels == 2:
        ax = axes[1]
        ax.plot([l for _, _, l in iters], linewidth=0.7)
        ax.set_xlabel("Logged iteration")
        ax.set_ylabel("Loss")
        ax.grid(True, alpha=0.3)
        ax.set_title("Per-iteration loss")

    out_path = out_path or os.path.join(
        os.path.dirname(os.path.abspath(history_path)), "loss.png")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def follow(history_path: str, out_path: Optional[str] = None,
           per_iter: bool = False, interval: float = 5.0,
           max_iterations: Optional[int] = None) -> str:
    """Watch-while-training: re-render the PNG whenever ``history.jsonl``
    grows (the serverless stand-in for the reference's live visdom window,
    ``src/solver.py:148-166``). Polls mtime+size every ``interval`` seconds;
    Ctrl-C to stop. ``max_iterations`` bounds the loop for tests."""
    import time

    last_sig = None
    n = 0
    out = out_path
    while max_iterations is None or n < max_iterations:
        try:
            st = os.stat(history_path)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            sig = None
        if sig is not None and sig != last_sig:
            out = plot_history(history_path, out_path, per_iter)
            last_sig = sig
            print(f"rendered {out}", flush=True)
        n += 1
        if max_iterations is None or n < max_iterations:
            try:
                time.sleep(interval)
            except KeyboardInterrupt:
                break
    return out or ""


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="plot solver loss history")
    p.add_argument("history", help="path to history.jsonl")
    p.add_argument("--out", default=None)
    p.add_argument("--per-iter", action="store_true")
    p.add_argument("--follow", action="store_true",
                   help="keep watching the history file and re-render the "
                        "PNG on change (live training monitor; Ctrl-C stops)")
    p.add_argument("--interval", type=float, default=5.0,
                   help="--follow poll interval in seconds")
    a = p.parse_args(argv)
    if a.follow:
        try:
            follow(a.history, a.out, a.per_iter, a.interval)
        except KeyboardInterrupt:
            pass
        return 0
    print(plot_history(a.history, a.out, a.per_iter))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
