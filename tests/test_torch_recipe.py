"""The port's staged pipeline: ``utils/jobs.py`` (the cases of
tests/test_jobs_sphere.py), ``utils/plot.py`` and ``cli recipe``.

``run_jobs`` and ``submit`` substitute, log and propagate failures as the
JAX launchers do; the loss history renders to a PNG where matplotlib is
installed and raises naming it where not; ``cli recipe`` runs stages 1-4
on the CPU at tiny widths, and a standalone ``--stage 3`` finds the newest
checkpoint under the exp dir.
"""

import json
import os
import shutil
import sys
import time

import pytest

from convtasnet_tpu_torch import cli
from convtasnet_tpu_torch.utils.jobs import (
    JobError,
    run_jobs,
    submit,
    submit_jobs,
)
from tests.test_data import _write_corpus

TINY = ["--device", "cpu", "--N", "16", "--L", "8", "--B", "12", "--H", "24",
        "--X", "2", "--R", "1", "--segment", "0.5", "--batch-size", "2",
        "--epochs", "1", "--print-freq", "1", "--num-workers", "1"]


def test_run_jobs_substitutes_logs_and_fails(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    codes = run_jobs(f"echo job-JOB && touch {out}/f.JOB", n_jobs=4,
                     log=str(tmp_path / "logs" / "run.JOB.log"))
    assert codes == [0, 0, 0, 0]
    assert sorted(os.listdir(out)) == ["f.1", "f.2", "f.3", "f.4"]
    log1 = open(tmp_path / "logs" / "run.1.log").read()
    assert "job-1" in log1 and "Exit code 0" in log1
    with pytest.raises(JobError) as e:
        run_jobs("test JOB -ne 2", n_jobs=3, log=str(tmp_path / "r.JOB.log"))
    assert "1/3 jobs failed" in str(e.value)
    assert "Exit code 1" in open(tmp_path / "r.2.log").read()


def test_submit_local_and_template(tmp_path):
    log = str(tmp_path / "logs" / "ok.log")
    assert submit("echo stage-done", log) == 0
    assert "stage-done" in open(log).read()
    log2 = str(tmp_path / "logs" / "tpl.log")
    assert submit("echo via-template", log2,
                  cmd_template="bash {script} > {log} 2>&1") == 0
    assert "via-template" in open(log2).read()
    assert os.path.exists(log2 + ".sh")
    with pytest.raises(JobError, match="bad.log"):
        submit("exit 3", str(tmp_path / "logs" / "bad.log"),
               cmd_template="bash {script} > {log} 2>&1")
    logs = str(tmp_path / "logs" / "arr.JOB.log")
    assert submit_jobs("echo job-JOB", 3, logs,
                       cmd_template="bash {script} > {log} 2>&1") == [0] * 3
    assert "job-2" in open(str(tmp_path / "logs" / "arr.2.log")).read()
    with pytest.raises(JobError, match="1/2 submitted jobs failed"):
        submit_jobs("test JOB -ne 2", 2, logs,
                    cmd_template="bash {script} > {log} 2>&1")


def _history(path):
    with open(path, "w") as f:
        for e in range(3):
            f.write(json.dumps({"kind": "iter", "epoch": e, "iter": 0,
                                "loss": 5.0 - e}) + "\n")
            for split in ("train", "valid"):
                f.write(json.dumps({"kind": "epoch", "epoch": e,
                                    "split": split, "loss": 4.0 - e}) + "\n")
    return str(path)


def test_plot_history(tmp_path):
    pytest.importorskip("matplotlib")
    from convtasnet_tpu_torch.utils.plot import follow, plot_history

    hist = _history(tmp_path / "history.jsonl")
    out = plot_history(hist, per_iter=True)
    assert out == str(tmp_path / "loss.png")
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    assert follow(hist, str(tmp_path / "f.png"), interval=0,
                  max_iterations=1) == str(tmp_path / "f.png")


def test_plot_names_matplotlib_when_absent(tmp_path, monkeypatch):
    from convtasnet_tpu_torch.utils.plot import plot_history

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        plot_history(_history(tmp_path / "history.jsonl"))


@pytest.fixture(scope="module")
def recipe_run(tmp_path_factory):
    """``cli recipe`` stages 1-4 on a tiny corpus."""
    root = tmp_path_factory.mktemp("recipe")
    data = str(root / "wav")
    _write_corpus(data, [4000, 4800, 5600, 6400], split="tr", seed=1)
    _write_corpus(data, [4000, 4400], split="cv", seed=2)
    _write_corpus(data, [4000, 5200], split="tt", seed=3)
    work = str(root / "work")
    old = os.environ.get("CONVTASNET_SEGMENT_CACHE")
    os.environ["CONVTASNET_SEGMENT_CACHE"] = "0"
    try:
        rc = cli.main(["recipe", "--data-dir", data, "--work-dir", work,
                       "--stage", "1", "--stop-stage", "4", *TINY])
    finally:
        if old is None:
            os.environ.pop("CONVTASNET_SEGMENT_CACHE")
        else:
            os.environ["CONVTASNET_SEGMENT_CACHE"] = old
    return dict(rc=rc, data=data, work=work)


def test_recipe_stages_1_to_4(recipe_run):
    work = recipe_run["work"]
    assert recipe_run["rc"] == 0
    assert sorted(os.listdir(os.path.join(work, "json"))) == ["cv", "tr",
                                                               "tt"]
    (exp,) = os.listdir(os.path.join(work, "exp"))
    assert exp.startswith("train_r8000_seg0.5_bs2_N16_L8_B12_H24")
    for name in ("final.ckpt", "history.jsonl", "config.json"):
        assert os.path.exists(os.path.join(work, "exp", exp, name))
    sep = sorted(os.listdir(os.path.join(work, "separate")))
    assert sep == ["utt000.wav", "utt000_s1.wav", "utt000_s2.wav",
                   "utt001.wav", "utt001_s1.wav", "utt001_s2.wav"]


def test_standalone_stage_3_finds_the_newest_checkpoint(recipe_run,
                                                        monkeypatch, capsys):
    work = recipe_run["work"]
    exp_dir = os.path.join(work, "exp")
    (first,) = os.listdir(exp_dir)
    newer = os.path.join(exp_dir, "a_later_run")
    shutil.copytree(os.path.join(exp_dir, first), newer)
    later = time.time() + 10
    os.utime(os.path.join(newer, "final.ckpt"), (later, later))
    seen = {}

    def record(ns):
        seen["separate"] = ns
        return 0

    monkeypatch.setattr(cli, "cmd_separate", record)
    capsys.readouterr()
    assert cli.main(["recipe", "--data-dir", recipe_run["data"],
                     "--work-dir", work, "--stage", "3", "--stop-stage", "4",
                     *TINY]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "si_snri" in res
    assert seen["separate"].model_path == os.path.join(newer, "final.ckpt")
    shutil.rmtree(newer)
    empty = os.path.join(work, "elsewhere")
    assert cli.main(["recipe", "--data-dir", recipe_run["data"],
                     "--work-dir", empty, "--stage", "3", *TINY]) == 1
    assert "no final.ckpt found under" in capsys.readouterr().err
